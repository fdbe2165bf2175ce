"""The FRS1 freshness trailer of the read wire
(``pytorch_ps_mpi_tpu/telemetry/freshness.py:80-180``).

Every version the read tier publishes gets a birth record (the root's
publish wall clock, its version and the root's generation); each
follower relay appends one hop record (its arrival wall on its own clock
and its skew against its upstream). The trailer rides a full or delta
reply after the payload when the reader sets ``FLAG_WANT_FRESH``; the
reply header's ``fresh_len`` byte carries its length, so a reader that
does not ask gets the bytes of the wire without freshness.

Wire format (little-endian): a 32-byte birth header ``u32 magic 'FRS1',
u8 hop_count, u8 cap, u16 reserved, u64 version, f64 publish_wall, u32
root_gen, u32 reserved2``, then ``hop_count`` 16-byte hop records ``u16
hop_index, u16 reserved, f32 skew_ms, f64 arrival_wall``. Appends past
the cap (:data:`FRESH_HOP_CAP`) are dropped, never wrapped.

``FreshnessTracker`` and the ``freshness`` cfg key come with ROADMAP
queue 1 item 3.
"""

from __future__ import annotations

import struct
import time
from typing import Any, Dict, List, Optional

__all__ = [
    "FRESH_MAGIC", "FRESH_HOP_CAP", "FRESH_MAX_BYTES",
    "pack_birth", "append_hop", "unpack_trailer",
    "total_skew_s", "birth_wall_local", "age_ms", "visible_latency_ms",
    "hop_latencies_ms",
]

#: ``b"FRS1"`` read as a little-endian u32 — same derivation as the
#: PSR1 magic in :mod:`pytorch_ps_mpi_tpu_torch.serving.net`.
FRESH_MAGIC = 0x31535246

#: hop records retained per trailer; appends past this saturate
FRESH_HOP_CAP = 8

_BIRTH = struct.Struct("<IBBHQdII")   # 32 B birth header
_HOP = struct.Struct("<HHfd")         # 16 B per-hop record

#: the largest trailer the wire can carry (must fit the u8 pad1 byte)
FRESH_MAX_BYTES = _BIRTH.size + FRESH_HOP_CAP * _HOP.size
assert _BIRTH.size == 32 and _HOP.size == 16 and FRESH_MAX_BYTES <= 255


# -- trailer codec ----------------------------------------------------------

def pack_birth(version: int, publish_wall: float,
               root_gen: int = 0) -> bytes:
    """A hop-less birth record — what the ROOT stamps at publish."""
    return _BIRTH.pack(FRESH_MAGIC, 0, FRESH_HOP_CAP, 0, int(version),
                       float(publish_wall), int(root_gen) & 0xFFFFFFFF, 0)


def append_hop(blob: bytes, hop_index: int, arrival_wall: float,
               skew_ms: float = 0.0) -> bytes:
    """Return ``blob`` with one hop record appended (validates first).
    At the cap the trailer is returned UNCHANGED — bounded, never
    reordered or wrapped."""
    doc = unpack_trailer(blob)  # raises on malformed input
    if len(doc["hops"]) >= doc["cap"]:
        return bytes(blob)
    head = bytearray(blob[:_BIRTH.size])
    head[4] = doc["hop_count"] + 1
    return (bytes(head) + blob[_BIRTH.size:]
            + _HOP.pack(int(hop_index) & 0xFFFF, 0, float(skew_ms),
                        float(arrival_wall)))


def unpack_trailer(blob: bytes) -> Dict[str, Any]:
    """Decode an FRS1 trailer. Raises ``ValueError`` on bad magic, a
    short header, truncated hop records, or trailing bytes — a
    truncated trailer is DROPPED by callers, never half-trusted."""
    if len(blob) < _BIRTH.size:
        raise ValueError(
            f"freshness trailer too short: {len(blob)} < {_BIRTH.size}")
    (magic, hop_count, cap, _r0, version, publish_wall, root_gen,
     _r1) = _BIRTH.unpack_from(blob, 0)
    if magic != FRESH_MAGIC:
        raise ValueError(f"bad freshness magic 0x{magic:08x}")
    want = _BIRTH.size + hop_count * _HOP.size
    if len(blob) != want:
        raise ValueError(
            f"freshness trailer is {len(blob)} bytes but header "
            f"declares {hop_count} hop(s) ({want} bytes)")
    hops: List[Dict[str, float]] = []
    for i in range(hop_count):
        idx, _r, skew_ms, arrival = _HOP.unpack_from(
            blob, _BIRTH.size + i * _HOP.size)
        hops.append({"hop_index": int(idx), "skew_ms": float(skew_ms),
                     "arrival_wall": float(arrival)})
    return {"version": int(version), "publish_wall": float(publish_wall),
            "root_gen": int(root_gen), "hop_count": int(hop_count),
            "cap": int(cap), "hops": hops}


# -- clock algebra ----------------------------------------------------------

def total_skew_s(doc: Dict[str, Any]) -> float:
    """Cumulative (local clock − root clock) down the recorded chain."""
    return sum(h["skew_ms"] for h in doc["hops"]) * 1e-3


def birth_wall_local(doc: Dict[str, Any]) -> float:
    """The publish wall re-expressed in the LAST hop's clock (the clock
    of whoever holds the trailer) — the zero point for local ages."""
    return doc["publish_wall"] + total_skew_s(doc)


def age_ms(doc: Dict[str, Any], now: Optional[float] = None) -> float:
    """Wall age of the version described by ``doc``, in the local
    clock. Clamped at 0 — a skew mis-estimate must never report a
    version as younger than freshly published."""
    t = time.time() if now is None else float(now)
    return max(0.0, (t - birth_wall_local(doc)) * 1e3)


def visible_latency_ms(doc: Dict[str, Any]) -> Optional[float]:
    """Publish→visible latency at the last recorded hop (``None`` for a
    hop-less root trailer): the last arrival and the corrected birth
    are both in that hop's clock, so the difference is a real
    duration."""
    if not doc["hops"]:
        return None
    return max(0.0,
               (doc["hops"][-1]["arrival_wall"] - birth_wall_local(doc))
               * 1e3)


def hop_latencies_ms(doc: Dict[str, Any]) -> List[float]:
    """Per-hop propagation latencies, skew-corrected: each arrival is
    re-expressed in the ROOT clock (subtract the cumulative skew up to
    and including that hop) and differenced against the previous
    stamp. Negative offsets (a hop's clock BEHIND its upstream's)
    correct in the same pass — the estimator's sign convention is
    receiver minus sender throughout."""
    out: List[float] = []
    prev_root = doc["publish_wall"]
    skew_s = 0.0
    for h in doc["hops"]:
        skew_s += h["skew_ms"] * 1e-3
        arrival_root = h["arrival_wall"] - skew_s
        out.append(max(0.0, (arrival_root - prev_root) * 1e3))
        prev_root = arrival_root
    return out

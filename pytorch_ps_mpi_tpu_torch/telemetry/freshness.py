"""Read-path freshness plane — version propagation from root publish to
edge reader.

The write path has exact causal accounting (lineage trace IDs survive
every hop into the published composition), but the trace used to die at
``ServingCore.publish()``: the read plane reported only
``replica_lag_versions``, a version count with no wall-clock meaning.
This module gives every published version a **birth record** that rides
the PSR1 delta stream as an opt-in trailer (FRS1), gains one bounded
**hop record** per follower relay, and is turned by a
:class:`FreshnessTracker` into publish→visible latency distributions,
an age-of-information gauge, and reader-delivery rows that join back to
write-path lineage — one causal chain from worker encode to the wall
age at which an edge replica served the containing version.

Wire format (FRS1, little-endian, appended AFTER the PSR1 payload; the
reply header's previously-zero ``pad1`` byte carries the trailer
length, so a reader that never sets ``FLAG_WANT_FRESH`` receives
byte-identical replies — the native-vs-Python reply-parity invariant
is preserved):

- 32-byte birth header: ``u32 magic 'FRS1', u8 hop_count, u8 cap,
  u16 reserved, u64 version, f64 publish_wall, u32 root_gen,
  u32 reserved2``;
- ``hop_count`` × 16-byte hop records: ``u16 hop_index, u16 reserved,
  f32 skew_ms, f64 arrival_wall``.

``publish_wall`` is stamped on the ROOT's clock; each hop's
``arrival_wall`` is stamped on THAT hop's clock, and ``skew_ms`` is the
hop's lower-envelope estimate (``lineage.estimate_clock_offset``) of its
own clock minus its upstream's. Summing ``skew_ms`` down the chain
therefore re-expresses the birth wall in the local clock — see
:func:`birth_wall_local` — which is what makes cross-host age numbers
meaningful at all. The cap (:data:`FRESH_HOP_CAP`) bounds the trailer
at 160 bytes (fits the u8 length byte with room to spare); appends past
the cap are dropped, not wrapped, so ``hop_count`` saturates and the
deepest hops go unrecorded rather than corrupting the birth record.

Skew caveat: a follower only observes (upstream stamp, local receive)
pairs through its *polled* pulls, so the lower-envelope fit absorbs the
minimum poll delay into the offset estimate — ages are accurate to
roughly one poll interval plus genuine clock drift, not to the
microsecond. OPERATIONS.md documents the operational consequences.
"""

from __future__ import annotations

import json
import os
import struct
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

__all__ = [
    "FRESH_MAGIC", "FRESH_HOP_CAP", "FRESH_MAX_BYTES",
    "pack_birth", "append_hop", "unpack_trailer",
    "total_skew_s", "birth_wall_local", "age_ms", "visible_latency_ms",
    "hop_latencies_ms", "FreshnessTracker", "fresh_path",
    "load_fresh_rows", "freshness_flow_events",
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


# -- sidecar rows -----------------------------------------------------------

def fresh_path(dir: str, name: str) -> str:
    return os.path.join(dir, f"freshness-{name}.jsonl")


def load_fresh_rows(path: str) -> List[Dict[str, Any]]:
    rows: List[Dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def _q(xs: List[float], q: float) -> float:
    if not xs:
        return 0.0
    s = sorted(xs)
    return s[min(len(s) - 1, int(round(q * (len(s) - 1))))]


class FreshnessTracker:
    """Turns FRS1 trailers into distributions, rows, and flow events.

    Attached via ``arm_observability`` (the SLOWatchdog pattern):
    ``server.freshness_tracker = self`` plus scrape instruments. The
    serving core calls :meth:`note_publish` with each installed
    trailer document; reader owners (followers, benches, smokes) call
    :meth:`note_delivery` with :meth:`~pytorch_ps_mpi_tpu_torch.serving.net.
    ServingReader.fresh_delivery_row` dicts. Both append to
    ``freshness-<name>.jsonl`` when a directory is armed, so the whole
    plane replays offline. Self-timed: ``overhead_s`` is the CPU this
    tracker cost, same discipline as the TSDB and the watchdog."""

    def __init__(self, server=None, cfg: Optional[Dict[str, Any]] = None,
                 *, name: str = "server", dir: Optional[str] = None,
                 window: int = 512, core=None, **overrides: Any):
        cfg = cfg or {}
        kw = dict(cfg.get("freshness_kw") or {})
        kw.update(overrides)
        self.name = str(name)
        self.window = int(kw.get("window", window))
        self.server = server
        #: standalone serving core (no PS server around it — replicas,
        #: benches): the age source when ``server.serving_core`` is gone
        self.core = core
        #: hop_index → recent skew-corrected hop latencies (ms)
        self._hop_lat: Dict[int, Deque[float]] = {}
        #: recent end-to-end publish→visible latencies at this node (ms)
        self._visible: Deque[float] = deque(maxlen=self.window)
        #: recent delivery ages observed by local readers (ms)
        self._delivery_age: Deque[float] = deque(maxlen=self.window)
        self.publishes = 0
        self.deliveries = 0
        self.dropped = 0  # malformed/truncated trailers rejected
        self.overhead_s = 0.0
        self.path: Optional[str] = None
        self._f = None
        if dir:
            os.makedirs(dir, exist_ok=True)
            self.path = fresh_path(dir, self.name)
            self._f = open(self.path, "a")
        if server is not None:
            server.freshness_tracker = self
            reg = getattr(server, "scrape_registry", None)
            if reg is not None:
                self.register(reg())
        if core is not None:
            # standalone-core attach: publishes flow straight through
            # core._stamp_fresh -> note_publish without a PS server
            core.freshness_tracker = self

    # -- ingestion --------------------------------------------------------
    def note_publish(self, tenant: str, doc: Dict[str, Any],
                     now: Optional[float] = None) -> None:
        """One version installed locally (root stamp or follower
        republish) — fold its chain into the per-hop windows and write
        the row."""
        t0 = time.thread_time()
        t = time.time() if now is None else float(now)
        lats = hop_latencies_ms(doc)
        for h, lat in zip(doc["hops"], lats):
            win = self._hop_lat.get(h["hop_index"])
            if win is None:
                win = self._hop_lat[h["hop_index"]] = deque(
                    maxlen=self.window)
            win.append(lat)
        vis = visible_latency_ms(doc)
        if vis is not None:
            self._visible.append(vis)
        self.publishes += 1
        self._write({"kind": "publish", "t": round(t, 4),
                     "tenant": tenant, "version": doc["version"],
                     "publish_wall": doc["publish_wall"],
                     "root_gen": doc["root_gen"],
                     "hop_count": doc["hop_count"],
                     "hops": doc["hops"],
                     "visible_ms": (round(vis, 3)
                                    if vis is not None else None)})
        self.overhead_s += time.thread_time() - t0

    def note_delivery(self, row: Dict[str, Any]) -> None:
        """One reader delivery (a ``fresh_delivery_row`` dict): the
        edge of the causal chain."""
        t0 = time.thread_time()
        self.deliveries += 1
        if "age_ms" in row:
            self._delivery_age.append(float(row["age_ms"]))
        out = dict(row)
        out["kind"] = "delivery"
        out.setdefault("t", time.time())
        self._write(out)
        self.overhead_s += time.thread_time() - t0

    def note_reject(self) -> None:
        self.dropped += 1

    def _write(self, row: Dict[str, Any]) -> None:
        if self._f is not None:
            self._f.write(json.dumps(row) + "\n")
            self._f.flush()

    # -- read-out ---------------------------------------------------------
    def hop_quantiles_ms(self) -> Dict[int, Dict[str, float]]:
        return {idx: {"p50": round(_q(list(w), 0.50), 3),
                      "p95": round(_q(list(w), 0.95), 3),
                      "n": float(len(w))}
                for idx, w in sorted(self._hop_lat.items())}

    def snapshot(self) -> Dict[str, Any]:
        sc = self.core if self.core is not None \
            else getattr(self.server, "serving_core", None)
        ages = sc.fresh_ages_ms() if sc is not None else {}
        return {
            "publishes": self.publishes,
            "deliveries": self.deliveries,
            "dropped": self.dropped,
            "visible_p50_ms": round(_q(list(self._visible), 0.50), 3),
            "visible_p95_ms": round(_q(list(self._visible), 0.95), 3),
            "delivery_age_p95_ms": round(
                _q(list(self._delivery_age), 0.95), 3),
            "hops": {str(k): v for k, v in self.hop_quantiles_ms().items()},
            "serving_age_ms": {k: round(v, 3) for k, v in ages.items()},
            "overhead_s": round(self.overhead_s, 6),
            "file": self.path,
        }

    def register(self, registry) -> None:
        def collect(r) -> None:
            r.counter("ps_fresh_publishes_total",
                      "versions with freshness birth records installed "
                      "on this node").set(float(self.publishes))
            r.counter("ps_fresh_deliveries_total",
                      "reader deliveries folded into the freshness "
                      "plane").set(float(self.deliveries))
            r.counter("ps_fresh_dropped_total",
                      "malformed/truncated freshness trailers "
                      "rejected").set(float(self.dropped))

        registry.add_collector(collect)

    def close(self) -> None:
        f, self._f = self._f, None
        if f is not None:
            f.close()


# -- Chrome flow events -----------------------------------------------------

def freshness_flow_events(rows: List[Dict[str, Any]],
                          lineage_rows: Optional[List[Dict[str, Any]]]
                          = None,
                          t0_wall: float = 0.0) -> List[Dict[str, Any]]:
    """Render persisted freshness rows as Chrome trace flow events: one
    flow per (tenant, version) from the root publish instant through
    each hop arrival to every reader delivery. When write-path lineage
    rows are supplied, each flow's publish step carries the worker
    push ``trace_ids`` folded into that version, completing the causal
    chain worker encode → published version → replica hops → reader
    read in one ``chrome://tracing`` / Perfetto view."""
    from pytorch_ps_mpi_tpu_torch.telemetry.lineage import trace_id

    by_version: Dict[int, List[str]] = {}
    for lr in lineage_rows or []:
        if lr.get("kind") == "publish" and "version" in lr:
            ids = []
            for p in lr.get("pushes", []):
                tid = p.get("trace_id")
                if tid is None and "worker" in p and "seq" in p:
                    # real LineageTracker rows carry the id as its
                    # (worker, step, seq) parts, not a pre-joined string
                    tid = trace_id(p["worker"], p.get("step", 0),
                                   p["seq"])
                if tid:
                    ids.append(tid)
            by_version.setdefault(int(lr["version"]), []).extend(ids)
    ev: List[Dict[str, Any]] = []

    def _flow(ph: str, fid: str, ts_s: float, pid: str, tid: str,
              nm: str, args: Dict[str, Any]) -> None:
        ev.append({"name": nm, "cat": "freshness", "ph": ph,
                   "id": fid, "ts": (ts_s - t0_wall) * 1e6,
                   "pid": pid, "tid": tid, "args": args})

    seen_pub = set()
    for row in rows:
        tenant = str(row.get("tenant", "default"))
        ver = int(row.get("version", 0))
        fid = f"fresh:{tenant}/{ver}"
        if row.get("kind") == "publish":
            pw = float(row.get("publish_wall", row.get("t", 0.0)))
            if (tenant, ver) not in seen_pub:
                seen_pub.add((tenant, ver))
                _flow("s", fid, pw, "root", "publish",
                      f"publish v{ver}",
                      {"tenant": tenant, "version": ver,
                       "trace_ids": by_version.get(ver, [])})
            skew_s = 0.0
            for h in row.get("hops", []):
                skew_s += float(h.get("skew_ms", 0.0)) * 1e-3
                _flow("t", fid, float(h["arrival_wall"]) - skew_s,
                      f"hop{h['hop_index']}", "relay",
                      f"hop {h['hop_index']} v{ver}",
                      {"skew_ms": h.get("skew_ms", 0.0)})
        elif row.get("kind") == "delivery":
            _flow("f", fid, float(row.get("t", 0.0)), "reader",
                  str(row.get("reader", "reader")),
                  f"read v{ver} age {row.get('age_ms', 0.0):.1f}ms",
                  {"age_ms": row.get("age_ms", 0.0),
                   "hop_count": row.get("hop_count", 0)})
    return ev

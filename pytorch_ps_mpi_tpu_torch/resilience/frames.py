"""Self-verifying frames on the async gradient push
(``pytorch_ps_mpi_tpu/resilience/frames.py``), byte for byte.

With frame checking on, every push carries a 36-byte PSF2 header:

``magic u32 | payload_len u32 | crc32 u32 | fingerprint u64 |``
``step u32 | seq u32 | send_wall f64``

- **magic** (``PSF2``) rejects garbage and is the format version: a v1
  (``PSF1``) frame is rejected with the reason ``"version"``;
- **payload_len** rejects truncation;
- **crc32** of the payload rejects corruption;
- **fingerprint**, an 8-byte BLAKE2b digest of the wire agreement
  (:func:`wire_fingerprint`: the codec's class and public settings, the
  unit and payload specs, and the template's treedef), rejects a worker
  whose configuration drifted, even at an equal byte count;
- **step / seq / send_wall** are the push's trace ID and its seal time.

The fingerprint is computed from JAX's own description of a codec and
of the template (``PyTreeDef(...)``), so a port worker and a JAX server,
or the reverse, agree whenever their configurations do. A failed check
is a counted rejection for that worker (``server._reject_frame``), never
a server crash.

**The composed-lineage trailer** (``frames.py:104-170``). A frame pushed
by a tree leader composes many worker pushes into one payload
(``parallel/tree.py``); their trace IDs ride a fixed-size trailer after
the codec payload, inside the length- and CRC-checked region:
``magic u32 ("PSTL") | count u32`` and ``K`` slots of ``worker u32 |
step u32 | seq u32 | send_wall f64``, unused slots zeroed. A server with
``tree_slots=K`` expects every payload to be ``wire_bytes +
trailer_bytes(K)`` long, and ``K`` joins the fingerprint. A valid frame
whose trailer magic or count is wrong is rejected as ``"trailer"``.
"""

from __future__ import annotations

import hashlib
import json
import struct
import time
import zlib
from typing import Any, Callable, Optional, Tuple

import numpy as np

from pytorch_ps_mpi_tpu_torch.telemetry.recorder import record_event

#: header magic ("PSF2" little-endian), the format version
FRAME_MAGIC = 0x32465350
#: the v1 magic ("PSF1"), recognized only to reject it as "version"
FRAME_MAGIC_V1 = 0x31465350

# magic, payload_len, crc32, fingerprint, step, seq, send_wall
_HEADER = struct.Struct("<IIIQIId")
HEADER_BYTES = _HEADER.size
assert HEADER_BYTES == 36
_LINEAGE = struct.Struct("<IId")
_LINEAGE_OFF = 20

#: C++ FrameStatus codes (``native/tcpps.cpp``) -> :func:`open_frame` reasons
BATCH_REASONS = {1: "short", 2: "version", 3: "magic", 4: "size",
                 5: "config", 6: "corrupt"}

#: lineage-trailer magic ("PSTL" little-endian)
TRAILER_MAGIC = 0x4C545350
_TRAILER_HEAD = struct.Struct("<II")          # magic, count
_TRAILER_ENTRY = struct.Struct("<IIId")       # worker, step, seq, send_wall
TRAILER_ENTRY_BYTES = _TRAILER_ENTRY.size
assert TRAILER_ENTRY_BYTES == 20


def trailer_bytes(slots: int) -> int:
    """On-wire size of a ``slots``-capacity trailer (0 for none)."""
    slots = int(slots)
    return 0 if slots <= 0 else _TRAILER_HEAD.size + slots * TRAILER_ENTRY_BYTES


def pack_trailer(out: np.ndarray, off: int, entries, slots: int) -> int:
    """Write a trailer into ``out`` at ``off``; return the bytes written.
    ``entries``: ``(worker, step, seq, send_wall)`` tuples or dicts with
    those keys, the first ``slots`` of them kept, the rest zeroed."""
    slots = int(slots)
    norm = []
    for e in entries or ():
        if isinstance(e, dict):
            norm.append((int(e["worker"]), int(e.get("step", 0)),
                         int(e.get("seq", 0)),
                         float(e.get("send_wall", 0.0))))
        else:
            w, s, q, t = e
            norm.append((int(w), int(s), int(q), float(t)))
    norm = norm[:slots]
    _TRAILER_HEAD.pack_into(out, off, TRAILER_MAGIC, len(norm))
    pos = off + _TRAILER_HEAD.size
    for w, s, q, t in norm:
        _TRAILER_ENTRY.pack_into(out, pos, w & 0xFFFFFFFF, s & 0xFFFFFFFF,
                                 q & 0xFFFFFFFF, t)
        pos += TRAILER_ENTRY_BYTES
    end = off + trailer_bytes(slots)
    out[pos:end] = 0
    return end - off


def read_composed(payload: np.ndarray, wire_bytes: int,
                  slots: int) -> Optional[list]:
    """The composed ``[{worker, step, seq, send_wall}, ...]`` of a
    validated tree-wire payload (codec payload + trailer), or None for a
    malformed trailer: wrong size or magic, or a count of 0 (it would
    zero the root round's weighting denominator) or above ``slots``."""
    slots = int(slots)
    if payload.nbytes != wire_bytes + trailer_bytes(slots):
        return None
    magic, count = _TRAILER_HEAD.unpack_from(payload, wire_bytes)
    if magic != TRAILER_MAGIC or count > slots or count == 0:
        return None
    out = []
    pos = wire_bytes + _TRAILER_HEAD.size
    for _ in range(count):
        w, s, q, t = _TRAILER_ENTRY.unpack_from(payload, pos)
        out.append({"worker": int(w), "step": int(s), "seq": int(q),
                    "send_wall": float(t)})
        pos += TRAILER_ENTRY_BYTES
    return out


def _codec_desc(code) -> dict:
    """The codec's class name and every public primitive-valued attribute
    (its constructor's settings), ``frames.py:174``."""
    kw = {}
    for k, v in vars(code).items():
        if k.startswith("_"):
            continue
        if isinstance(v, (bool, int, float, str, type(None))):
            kw[k] = v
        elif isinstance(v, (tuple, list)) and all(
                isinstance(x, (bool, int, float, str)) for x in v):
            kw[k] = list(v)
    return {"cls": type(code).__name__, "kw": kw}


def wire_fingerprint(wire, template, tree_slots: int = 0) -> int:
    """64-bit fingerprint of the wire agreement (``frames.py:191``).
    ``wire`` is a ``parallel.dcn.CodecWire`` or None for the raw float32
    wire; ``template`` the JAX-layout parameter tree. A nonzero
    ``tree_slots`` joins the agreement (omitted at 0)."""
    from pytorch_ps_mpi_tpu_torch.utils.serialization import tree_flatten

    if wire is None:
        leaves, treedef = tree_flatten(template)
        desc = {
            "codec": None,
            "units": [[list(np.shape(l)), "float32"] for l in leaves],
            "treedef": str(treedef),
        }
    else:
        desc = {
            "codec": _codec_desc(wire.code),
            "units": [[list(s), d] for s, d in zip(wire.shapes,
                                                    wire.dtype_names)],
            "specs": [[list(s), d] for s, d in wire.spec_names],
            "treedef": str(wire.treedef),
        }
    if int(tree_slots) > 0:
        desc["tree_slots"] = int(tree_slots)
    blob = json.dumps(desc, sort_keys=True).encode()
    return int.from_bytes(hashlib.blake2b(blob, digest_size=8).digest(),
                          "little")


def seal_frame(out: np.ndarray, payload: np.ndarray, fingerprint: int,
               step: int = 0, seq: int = 0,
               send_wall: Optional[float] = None,
               composed=None, tree_slots: int = 0) -> np.ndarray:
    """Write header + payload (+ a ``tree_slots`` trailer of
    ``composed``) into the uint8 buffer ``out`` and return the frame's
    view; the header's length and CRC cover payload and trailer."""
    if payload.dtype != np.uint8:
        payload = payload.view(np.uint8)
    payload = payload.reshape(-1)
    n = payload.nbytes
    out[HEADER_BYTES:HEADER_BYTES + n] = payload
    total = n
    if int(tree_slots) > 0:
        total += pack_trailer(out, HEADER_BYTES + n, composed or (),
                              tree_slots)
    body = out[HEADER_BYTES:HEADER_BYTES + total]
    _HEADER.pack_into(out, 0, FRAME_MAGIC, total,
                      zlib.crc32(body) & 0xFFFFFFFF, fingerprint,
                      int(step) & 0xFFFFFFFF, int(seq) & 0xFFFFFFFF,
                      time.time() if send_wall is None else float(send_wall))
    return out[:HEADER_BYTES + total]


def open_frame(buf: np.ndarray, fingerprint: int,
               expected_payload: Optional[int] = None
               ) -> Tuple[Optional[np.ndarray], Optional[str]]:
    """``(payload_view, None)`` for a valid frame, else ``(None, reason)``
    with reason ``"short"``, ``"version"``, ``"magic"``, ``"size"``,
    ``"config"`` or ``"corrupt"``, checked in that order."""
    if buf.nbytes < 4:
        return None, "short"
    (magic,) = struct.unpack_from("<I", buf)
    if magic == FRAME_MAGIC_V1:
        return None, "version"
    if magic != FRAME_MAGIC:
        return None, "magic"
    if buf.nbytes < HEADER_BYTES:
        return None, "short"
    _, plen, crc, fp, _, _, _ = _HEADER.unpack_from(buf)
    if plen != buf.nbytes - HEADER_BYTES or (
            expected_payload is not None and plen != expected_payload):
        return None, "size"
    if fp != fingerprint:
        return None, "config"
    payload = buf[HEADER_BYTES:]
    if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
        return None, "corrupt"
    return payload, None


def read_lineage(buf: np.ndarray) -> Tuple[int, int, float]:
    """``(step, seq, send_wall)`` of a validated frame."""
    step, seq, send_wall = _LINEAGE.unpack_from(buf, _LINEAGE_OFF)
    return int(step), int(seq), float(send_wall)


def _split_composed(server, wid: int, payload: np.ndarray):
    """``(codec payload, composed entries, ok)`` of a validated payload
    (``frames.py:346``): the identity on a server without tree slots; a
    malformed trailer is a counted ``"trailer"`` rejection. Every valid
    frame's composed count, stale drops included, advances
    ``server.tree_composed``."""
    slots = int(getattr(server, "tree_slots", 0) or 0)
    if not slots:
        return payload, None, True
    entries = read_composed(payload, server._wire_payload_bytes, slots)
    if entries is None:
        server._reject_frame(wid, "trailer")
        return None, None, False
    server.tree_composed += len(entries)
    log = getattr(server, "composed_log", None)
    if log is not None:  # the trace IDs, where a driver asked for them
        log.extend(entries)
    return payload[:server._wire_payload_bytes], entries, True


def _open_with_epochs(server, buf: np.ndarray):
    """Open a frame against the server's current wire agreement, else
    against a still-accepted older epoch (``frames.py:312``): a codec
    renegotiation keeps the retiring wire in ``server._epoch_table``, so
    an in-flight old-epoch frame is consumed, decoded with its own wire,
    and counted in ``server.epoch_old_frames``, never rejected. Returns
    ``(payload, err, wire, epoch)``; ``wire`` is None for a current-epoch
    frame."""
    payload, err = open_frame(buf, server._fingerprint,
                              server._expected_payload)
    if err is None:
        return payload, None, None, getattr(server, "_epoch", 0)
    table = getattr(server, "_epoch_table", None)
    if err in ("config", "size") and table:
        for fp_old, ep in table.items():
            payload, err2 = open_frame(buf, fp_old, ep["expected"])
            if err2 is None:
                server.epoch_old_frames += 1
                return payload, None, ep["wire"], ep["epoch"]
    return None, err, None, None


def note_epoch(server, wid: int, epoch: int) -> None:
    """The epoch of a worker's validated frame: ``server._epoch_seen``
    (the controller's retire signal), the per-worker count of frames a
    wire epoch (``server.epoch_frames``) and ``server.epoch_regressions``,
    frames older than the worker's last one."""
    seen = server.__dict__.setdefault("_epoch_seen", {})
    if epoch < seen.get(wid, epoch):
        server.epoch_regressions = getattr(server, "epoch_regressions",
                                           0) + 1
    seen[wid] = epoch
    per = server.__dict__.setdefault("epoch_frames", {}).setdefault(wid, {})
    per[epoch] = per.get(epoch, 0) + 1


def _consume(server, wid: int, version: int, payload, lineage, raw: bool,
             wire=None):
    """Count one validated push and apply bounded staleness: the
    ``((worker, version, grad or payload), meta)`` pair, or None for a
    malformed trailer or a stale drop. ``meta`` holds the push's trace
    ID, its bytes, send and receive walls, decode seconds and, on a tree
    wire, its composed entries; it feeds ``server.lineage_tracker`` when
    one is attached (a stale drop too, marked ``stale_drop``), and a
    consumed push is a ``serve.consume`` span in the flight recorder
    (``frames.py:433-540``). The composed count of a consumed push is
    queued on ``server._composed_queue``. ``wire`` is an old epoch's
    wire: its frame is decoded with it, in raw mode too."""
    recv_wall = time.time()
    full_bytes = payload.nbytes
    payload, composed, ok = _split_composed(server, wid, payload)
    if not ok:
        return None
    staleness = max(0, server.version - version)
    server.staleness_seen[staleness] = server.staleness_seen.get(
        staleness, 0) + 1
    server.grads_received += 1
    server.bytes_received += full_bytes
    step, seq, send_wall = lineage
    meta = {"worker": int(wid), "step": step, "seq": seq,
            "version_read": int(version), "staleness": int(staleness),
            "bytes": int(full_bytes), "send_wall": send_wall,
            "recv_wall": recv_wall}
    if composed is not None:
        meta["composed"] = composed
    lt = getattr(server, "lineage_tracker", None)
    if staleness > server.max_staleness:
        server.stale_drops += 1
        if lt is not None:
            meta["stale_drop"] = True
            lt.observe_consume(meta)
        return None
    t_dec = time.monotonic()
    if raw and wire is None:
        grad = payload
        meta["decode_s"] = 0.0  # deferred to the round's one decode
    else:
        grad = server._decode_payload(payload, wire=wire)
        meta["decode_s"] = round(time.monotonic() - t_dec, 6)
    # the server-side anchor of the cross-process flow arrow: the same
    # (worker, step, seq) trace ID the worker's push span carries
    record_event("serve.consume", kind="span", ts=t_dec,
                 dur=meta["decode_s"], step=step, src_worker=int(wid),
                 seq=seq, staleness=int(staleness))
    if lt is not None:
        lt.observe_consume(meta)
    if composed is not None:
        server._composed_queue.append(len(composed))
    return (int(wid), int(version), grad), meta


def framed_batch_consume(server, frames_iter, raw: bool = False) -> list:
    """The batched twin of :func:`framed_poll` (``frames.py:357``) for
    frames the native side already validated. ``frames_iter`` yields
    ``(worker, version, status, payload_view, step, seq, send_wall)``,
    status 0 meaning valid. Returns the consumed items; rejections and
    stale drops are counted, not returned. The consumed items' metas are
    ``server.last_batch_metas``, in the same order."""
    out, metas = [], []
    for wid, version, status, payload, step, seq, wall in frames_iter:
        server.last_seen[wid] = time.time()
        if status:
            server._reject_frame(wid, BATCH_REASONS.get(status, "magic"))
            continue
        note_epoch(server, wid, getattr(server, "_epoch", 0))
        got = _consume(server, wid, version, payload, (step, seq, wall), raw)
        if got is not None:
            out.append(got[0])
            metas.append(got[1])
    server.last_batch_metas = metas
    return out


def framed_poll(server, pop_once: Callable[[], Tuple[int, int, int]],
                raw: bool = False) -> Optional[Tuple[int, int, Any]]:
    """The frame-checking poll both transports share (``frames.py:433``):
    ``pop_once()`` gives ``(nbytes, worker, version)`` with the frame in
    ``server._grad_buf`` (``nbytes <= 0``: nothing pending). Each frame is
    validated before any bookkeeping; a bad one is a counted rejection
    and polling goes on; during a codec renegotiation an old epoch's
    frame is consumed with its own wire (:func:`_open_with_epochs`).
    ``raw=True`` returns the validated payload bytes (a view of the
    receive buffer) instead of decoding them. The consumed push's meta is
    ``server.last_push_meta``."""
    while True:
        n, wid, version = pop_once()
        if n <= 0:
            return None
        server.last_seen[wid] = time.time()
        payload, err, old_wire, epoch = _open_with_epochs(
            server, server._grad_buf[:n])
        if err is not None:
            server._reject_frame(wid, err)
            continue
        note_epoch(server, wid, epoch)
        got = _consume(server, wid, version, payload,
                       read_lineage(server._grad_buf), raw, wire=old_wire)
        if got is not None:
            server.last_push_meta = got[1]
            return got[0]

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
a server crash. The tree wire's lineage trailer (``tree_slots > 0``)
belongs to the aggregation tree, ROADMAP queue 1 item 3, and raises.
"""

from __future__ import annotations

import hashlib
import json
import struct
import time
import zlib
from typing import Any, Callable, Optional, Tuple

import numpy as np

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


def no_tree_slots(tree_slots: int) -> None:
    """Raise for a tree wire's lineage trailer, which the port lacks."""
    if int(tree_slots):
        raise NotImplementedError(
            "tree_slots > 0 (the aggregation tree's lineage trailer) is not "
            "ported yet: ROADMAP queue 1 item 3 (parallel/tree.py)")


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
    wire; ``template`` the JAX-layout parameter tree."""
    no_tree_slots(tree_slots)
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
    blob = json.dumps(desc, sort_keys=True).encode()
    return int.from_bytes(hashlib.blake2b(blob, digest_size=8).digest(),
                          "little")


def seal_frame(out: np.ndarray, payload: np.ndarray, fingerprint: int,
               step: int = 0, seq: int = 0,
               send_wall: Optional[float] = None) -> np.ndarray:
    """Write header + payload into the uint8 buffer ``out`` (at least
    ``HEADER_BYTES + payload.nbytes``) and return the frame's view."""
    if payload.dtype != np.uint8:
        payload = payload.view(np.uint8)
    payload = payload.reshape(-1)
    n = payload.nbytes
    out[HEADER_BYTES:HEADER_BYTES + n] = payload
    body = out[HEADER_BYTES:HEADER_BYTES + n]
    _HEADER.pack_into(out, 0, FRAME_MAGIC, n, zlib.crc32(body) & 0xFFFFFFFF,
                      fingerprint, int(step) & 0xFFFFFFFF,
                      int(seq) & 0xFFFFFFFF,
                      time.time() if send_wall is None else float(send_wall))
    return out[:HEADER_BYTES + n]


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


def _consume(server, wid: int, version: int, payload, full_bytes: int,
             raw: bool):
    """Count one validated push and apply bounded staleness: the
    ``(worker, version, grad or payload)`` item, or None for a stale
    drop."""
    staleness = max(0, server.version - version)
    server.staleness_seen[staleness] = server.staleness_seen.get(
        staleness, 0) + 1
    server.grads_received += 1
    server.bytes_received += full_bytes
    if staleness > server.max_staleness:
        server.stale_drops += 1
        return None
    grad = payload if raw else server._decode_payload(payload)
    return int(wid), int(version), grad


def framed_batch_consume(server, frames_iter, raw: bool = False) -> list:
    """The batched twin of :func:`framed_poll` (``frames.py:357``) for
    frames the native side already validated. ``frames_iter`` yields
    ``(worker, version, status, payload_view, step, seq, send_wall)``,
    status 0 meaning valid. Returns the consumed items; rejections and
    stale drops are counted, not returned."""
    out = []
    for wid, version, status, payload, _, _, _ in frames_iter:
        server.last_seen[wid] = time.time()
        if status:
            server._reject_frame(wid, BATCH_REASONS.get(status, "magic"))
            continue
        item = _consume(server, wid, version, payload, payload.nbytes, raw)
        if item is not None:
            out.append(item)
    return out


def framed_poll(server, pop_once: Callable[[], Tuple[int, int, int]],
                raw: bool = False) -> Optional[Tuple[int, int, Any]]:
    """The frame-checking poll both transports share (``frames.py:433``):
    ``pop_once()`` gives ``(nbytes, worker, version)`` with the frame in
    ``server._grad_buf`` (``nbytes <= 0``: nothing pending). Each frame is
    validated before any bookkeeping; a bad one is a counted rejection
    and polling goes on. ``raw=True`` returns the validated payload bytes
    (a view of the receive buffer) instead of decoding them."""
    while True:
        n, wid, version = pop_once()
        if n <= 0:
            return None
        server.last_seen[wid] = time.time()
        payload, err = open_frame(server._grad_buf[:n], server._fingerprint,
                                  server._expected_payload)
        if err is not None:
            server._reject_frame(wid, err)
            continue
        item = _consume(server, wid, version, payload, payload.nbytes, raw)
        if item is not None:
            return item

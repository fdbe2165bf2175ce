"""Version-to-version parameter deltas for the read tier
(``pytorch_ps_mpi_tpu/serving/delta.py``).

A reader holding version ``v`` asks for "v -> latest"; this module
builds (and applies) the answer. The flat float32 vector is cut into
sections by :func:`~pytorch_ps_mpi_tpu_torch.bucketing.plan_buckets`
over an all-float32 view of the template (so section boundaries follow
leaf boundaries), and each *changed* section ships sparse (the indices
and new values of its changed elements) or dense (its new values),
whichever is smaller; an unchanged section ships nothing.

**Exact by default**: changed elements are found by a *bit* compare
(uint32 views, so NaN and -0.0 count) and the payload carries the new
values, so ``apply(base, encode(base, latest))`` equals ``latest`` bit
for bit. **Lossy opt-in**: with a codec (a ``codecs.get_codec`` name) a
changed section may ship as the codec's payload of its float32 diff,
where that is smaller. At the probe cadence the encoder decodes what it
is about to ship and measures the relative L2 error; past
``max_rel_error`` it turns the lossy path off for good (counted in
``lossy_fallbacks``) and ships exact. The codec runs on ``device``:
the server's for its encodes and probes, the reader's for its applies
(the card unless the caller asks for the CPU); the exact mode is host
numpy and touches no device. Both ends construct the same config.

Payload format (little-endian), the JAX package's byte for byte::

  u32 magic 'PSD1' | u32 n_sections | u64 total_elems
  per section:
    u32 mode (0 sparse / 1 dense / 2 lossy) | u32 start | u32 count
    | u32 n  (sparse: nnz; dense: count; lossy: payload bytes)
    | body   (sparse: u32 idx[n] then f32 val[n]; dense: f32 val[count];
              lossy: the codec's payload arrays for a (count,) f32 diff,
              in sorted-key order)

``encode`` returns ``None`` when the delta would not beat the full
snapshot (the caller then serves a full read, counted).
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from pytorch_ps_mpi_tpu_torch.bucketing import plan_buckets
from pytorch_ps_mpi_tpu_torch.codecs.base import host_dtype
from pytorch_ps_mpi_tpu_torch.mesh import Device, resolve_device
from pytorch_ps_mpi_tpu_torch.utils.serialization import (read_arrays,
                                                          tree_flatten)

Tree = Any

MAGIC = 0x31445350  # "PSD1"
_HEADER = struct.Struct("<IIQ")
_SECTION = struct.Struct("<IIII")
MODE_SPARSE, MODE_DENSE, MODE_LOSSY = 0, 1, 2
#: the seed of a stochastic lossy codec's generator, fresh each encode
#: (the JAX package's ``jax.random.key(0x5EED)``)
LOSSY_SEED = 0x5EED

#: tuning knobs and their defaults (overridable via ``cfg["serving_kw"]``)
DELTA_KNOBS: Dict[str, Any] = {
    "delta_bucket_mb": 4.0,     # section granularity (0 = one section)
    "delta_codec": None,        # codec registry name; None = exact only
    "delta_codec_kw": {},       # constructor kwargs for the lossy codec
    "delta_max_rel_error": 0.05,  # fidelity gate for the lossy path
    "delta_probe_every": 16,    # lossy fidelity probe cadence (encodes)
    "delta_min_saving": 0.9,    # ship delta only if < this x full bytes
}


def _host_bytes(t: torch.Tensor) -> bytes:
    """A payload tensor's bytes on the host (bf16 as its bit pattern)."""
    flat = t.reshape(-1)
    if flat.dtype == torch.bfloat16:
        flat = flat.view(torch.int16)
    return flat.cpu().numpy().tobytes()


def _flat_segments(template: Tree, bucket_mb: float,
                   total: int) -> List[Tuple[int, int]]:
    """Contiguous ``(start, count)`` sections of the flat vector: the
    buckets of the plan over the template's leaves as float32 (one dtype
    group, so the buckets keep leaf order and their sizes are the flat
    offsets; ``delta.py:65-89``)."""
    if total == 0:
        return []
    if bucket_mb is None or bucket_mb <= 0:
        return [(0, total)]
    leaves = tree_flatten(template)[0]
    plan = plan_buckets({str(i): torch.empty(tuple(np.shape(x)),
                                             dtype=torch.float32,
                                             device="meta")
                         for i, x in enumerate(leaves)}, bucket_mb)
    segs, off = [], 0
    for b in plan.buckets:
        segs.append((off, int(b.size)))
        off += int(b.size)
    assert off == total, f"segment plan covers {off} of {total} elements"
    return segs


class DeltaCodec:
    """Encode/apply exact (or guarded-lossy) flat-vector deltas.

    Construct with the same arguments on server and reader: the config
    is part of the wire agreement (the exact mode describes itself, the
    lossy mode's payload layout does not). Counters: ``encodes``,
    ``lossy_encodes`` (codec encodes, one a changed section), ``probes``
    (codec decodes of a probed encode, one a section), ``lossy_fallbacks``.
    """

    def __init__(self, template: Tree, bucket_mb: float = 4.0,
                 codec: Optional[str] = None,
                 codec_kw: Optional[dict] = None,
                 max_rel_error: float = 0.05, probe_every: int = 16,
                 min_saving: float = 0.9, device: Device = "cuda"):
        from pytorch_ps_mpi_tpu_torch.parallel.dcn import flat_size

        self.total = int(flat_size(template))
        self.full_bytes = self.total * 4
        self.segments = _flat_segments(template, bucket_mb, self.total)
        self.max_rel_error = float(max_rel_error)
        self.probe_every = max(1, int(probe_every))
        self.min_saving = float(min_saving)
        self.code = None
        self.device = None
        if codec:
            from pytorch_ps_mpi_tpu_torch.codecs import get_codec

            self.code = get_codec(codec, **(codec_kw or {}))
            self.device = resolve_device(device)
        #: sticky lossy state: True until a fidelity probe fails
        self.lossy_ok = self.code is not None
        self.lossy_fallbacks = 0
        self.last_probe_rel_error: Optional[float] = None
        self.encodes = 0
        self.lossy_encodes = 0
        self.probes = 0
        self._codec_structs: Dict[int, Tuple[Optional[List[str]],
                                             List[Tuple[tuple,
                                                        torch.dtype]]]] = {}

    # -- lossy helpers ----------------------------------------------------
    def _struct_for(self, count: int):
        """The lossy codec's payload on a (count,) float32 input: its
        sorted keys (None for a bare tensor) and its tensors' (shape,
        dtype), from an encode of zeros on the CPU (cached per size)."""
        st = self._codec_structs.get(count)
        if st is None:
            gen = (torch.Generator().manual_seed(0)
                   if self.code.needs_rng else None)
            with torch.no_grad():
                payload, _ = self.code.encode(
                    torch.zeros(count, dtype=torch.float32),
                    self.code.init_state((count,), torch.float32,
                                         torch.device("cpu")), gen)
            keys = sorted(payload) if isinstance(payload, dict) else None
            tensors = [payload[k] for k in keys] if keys else [payload]
            st = (keys, [(tuple(t.shape), t.dtype) for t in tensors])
            self._codec_structs[count] = st
        return st

    def _lossy_encode(self, diff: np.ndarray,
                      probe: bool) -> Optional[bytes]:
        """The codec's payload bytes of one section's diff, encoded on
        ``device``; None when the fidelity probe rejects it (sticky) or
        the codec errors."""
        try:
            self.lossy_encodes += 1
            count = diff.size
            gen = (torch.Generator(device=self.device).manual_seed(LOSSY_SEED)
                   if self.code.needs_rng else None)
            x = torch.from_numpy(diff).to(self.device)
            with torch.no_grad():
                payload, _ = self.code.encode(
                    x, self.code.init_state((count,), torch.float32,
                                            self.device), gen)
                if probe:
                    self.probes += 1
                    rec = self.code.decode(payload, (count,), torch.float32)
                    rec = rec.cpu().numpy().astype(np.float32, copy=False)
                    dn = float(np.linalg.norm(diff))
                    rel = float(np.linalg.norm(rec - diff) / max(dn, 1e-30))
                    self.last_probe_rel_error = rel
                    if rel > self.max_rel_error:
                        # the codec measurably mangles this distribution
                        # of diffs: exact for the rest of the run
                        self.lossy_ok = False
                        self.lossy_fallbacks += 1
                        return None
            keys, _ = self._struct_for(count)
            tensors = [payload[k] for k in keys] if keys else [payload]
            return b"".join(_host_bytes(t) for t in tensors)
        except Exception:
            self.lossy_ok = False
            self.lossy_fallbacks += 1
            return None

    def _lossy_apply(self, base_seg: np.ndarray,
                     body: memoryview) -> np.ndarray:
        """``base_seg`` plus the decode of one lossy section, the decode
        on ``device`` and the add in float32 on the host."""
        count = base_seg.size
        keys, specs = self._struct_for(count)
        arrays = read_arrays(body, [(s, host_dtype(d)) for s, d in specs],
                             copy=True)
        tensors = [torch.from_numpy(a).view(d).to(self.device)
                   for a, (_, d) in zip(arrays, specs)]
        payload = dict(zip(keys, tensors)) if keys else tensors[0]
        with torch.no_grad():
            diff = self.code.decode(payload, (count,), torch.float32)
        return base_seg + diff.cpu().numpy().astype(np.float32, copy=False)

    # -- encode -----------------------------------------------------------
    def encode(self, base: np.ndarray,
               latest: np.ndarray) -> Optional[np.ndarray]:
        """Delta payload bytes (uint8 ndarray) for base -> latest, or
        ``None`` when a full snapshot is the better answer."""
        if base.size != self.total or latest.size != self.total:
            raise ValueError(
                f"flat size mismatch: template {self.total}, "
                f"base {base.size}, latest {latest.size}")
        self.encodes += 1
        probe = (self.encodes % self.probe_every) == 1 or self.probe_every == 1
        bv = base.view(np.uint32)
        lv = latest.view(np.uint32)
        sections: List[Tuple[int, int, int, bytes, Any, Any]] = []
        total_bytes = _HEADER.size
        for start, count in self.segments:
            idx = np.nonzero(bv[start:start + count]
                             != lv[start:start + count])[0]
            nnz = int(idx.size)
            if nnz == 0:
                continue
            vals = latest[start:start + count]
            sparse_bytes = 8 * nnz
            dense_bytes = 4 * count
            if self.code is not None and self.lossy_ok:
                diff = vals - base[start:start + count]
                body = self._lossy_encode(
                    np.ascontiguousarray(diff, np.float32), probe)
                if body is not None and len(body) < min(sparse_bytes,
                                                        dense_bytes):
                    sections.append((MODE_LOSSY, start, count, body,
                                     None, None))
                    total_bytes += _SECTION.size + len(body)
                    continue
            if sparse_bytes < dense_bytes:
                sections.append((MODE_SPARSE, start, count, b"",
                                 idx.astype(np.uint32), vals[idx]))
                total_bytes += _SECTION.size + sparse_bytes
            else:
                sections.append((MODE_DENSE, start, count, b"", None, vals))
                total_bytes += _SECTION.size + dense_bytes
        if total_bytes >= self.min_saving * self.full_bytes:
            return None  # delta not worth it: serve a full snapshot
        out = np.empty(total_bytes, np.uint8)
        _HEADER.pack_into(out, 0, MAGIC, len(sections), self.total)
        off = _HEADER.size
        for mode, start, count, body, idx, vals in sections:
            n = (len(body) if mode == MODE_LOSSY
                 else int(idx.size) if mode == MODE_SPARSE else count)
            _SECTION.pack_into(out, off, mode, start, count, n)
            off += _SECTION.size
            parts = ([np.frombuffer(body, np.uint8)] if mode == MODE_LOSSY
                     else [idx, vals] if mode == MODE_SPARSE else [vals])
            for p in parts:
                b = np.ascontiguousarray(p).view(np.uint8)
                out[off:off + b.nbytes] = b
                off += b.nbytes
        assert off == total_bytes
        return out

    # -- apply ------------------------------------------------------------
    def apply(self, base: np.ndarray, payload) -> np.ndarray:
        """Rebuild the latest flat vector from ``base`` + a delta payload
        (bytes-like). Returns a new array; ``base`` is untouched."""
        mv = memoryview(payload)
        if mv.nbytes < _HEADER.size:
            raise ValueError("truncated delta payload (no header)")
        magic, n_sections, total = _HEADER.unpack_from(mv, 0)
        if magic != MAGIC:
            raise ValueError(f"bad delta magic 0x{magic:08x}")
        if total != base.size:
            raise ValueError(
                f"delta for {total} elements applied to base of {base.size}")
        out = np.array(base, np.float32, copy=True)
        off = _HEADER.size
        for _ in range(n_sections):
            mode, start, count, n = _SECTION.unpack_from(mv, off)
            off += _SECTION.size
            if mode == MODE_SPARSE:
                idx = np.frombuffer(mv, np.uint32, n, off)
                off += 4 * n
                vals = np.frombuffer(mv, np.float32, n, off)
                off += 4 * n
                out[start:start + count][idx] = vals
            elif mode == MODE_DENSE:
                out[start:start + count] = np.frombuffer(mv, np.float32,
                                                         count, off)
                off += 4 * count
            elif mode == MODE_LOSSY:
                if self.code is None:
                    raise ValueError(
                        "lossy delta section but this DeltaCodec has no "
                        "codec configured (wire agreement drift)")
                out[start:start + count] = self._lossy_apply(
                    out[start:start + count], mv[off:off + n])
                off += n
            else:
                raise ValueError(f"unknown delta section mode {mode}")
        if off != mv.nbytes:
            raise ValueError(
                f"delta payload has {mv.nbytes - off} trailing bytes")
        return out

    @classmethod
    def from_knobs(cls, template: Tree, knobs: Dict[str, Any],
                   device: Device = "cuda") -> "DeltaCodec":
        """Construct from a ``DELTA_KNOBS``-shaped dict (the
        ``cfg["serving_kw"]`` path: both ends call this with the same
        cfg, which keeps the wire agreement single-sourced)."""
        k = dict(DELTA_KNOBS)
        k.update({key: v for key, v in knobs.items() if key in DELTA_KNOBS})
        return cls(
            template,
            bucket_mb=float(k["delta_bucket_mb"]),
            codec=k["delta_codec"],
            codec_kw=k["delta_codec_kw"],
            max_rel_error=float(k["delta_max_rel_error"]),
            probe_every=int(k["delta_probe_every"]),
            min_saving=float(k["delta_min_saving"]),
            device=device,
        )

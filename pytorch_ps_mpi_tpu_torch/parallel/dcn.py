"""The async parameter server across processes over shared memory
(``pytorch_ps_mpi_tpu/parallel/dcn.py``).

A server process owns the parameters and applies gradients in arrival
order; worker processes read the latest published snapshot whenever
they like (inconsistent reads) and push gradients tagged with the
version they read. The transport is ``native/psqueue.cpp`` (a seqlock
parameter board and one gradient mailbox a worker), bound by
``utils/native.py``; the server drops a gradient more than
``max_staleness`` versions old.

**The wire is the JAX package's, byte for byte.** Its template is the
JAX parameter tree (``utils.interop.params_to_jax``: nested dicts in
flax's names and layouts) and its units are that tree's leaves in
``jax.tree.flatten`` order, or, at ``bucket_mb > 0`` with a bucketable
codec, the dtype-grouped flat buckets of ``bucketing.plan_buckets`` over
them. Each unit's payload travels as its leaves in sorted-key order, and
the published snapshot is the template's leaves as one flat float32
vector. So a JAX server consumes a port worker's frames and the reverse.

:class:`CodecWire` encodes on the wire's device with the codec's kernels,
copies every payload tensor straight into one of two pinned ping-pong
wire buffers (``non_blocking``), and synchronizes once before the bytes
are handed to the transport. On the receive side it copies the payload
bytes to the device once and decodes each unit as a one-rank
``decode_sum`` (the kernels' decode-sum launches), or, under
compressed-domain aggregation, folds the bytes on the host into a
:class:`WireAggregator` and decodes once a published version.
"""

from __future__ import annotations

import collections
import ctypes
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from pytorch_ps_mpi_tpu_torch.bucketing import plan_buckets
from pytorch_ps_mpi_tpu_torch.codecs.base import (dtype_name, host_dtype,
                                                  numel, sparse_agg_release,
                                                  torch_dtype)
from pytorch_ps_mpi_tpu_torch.mesh import Device, resolve_device
from pytorch_ps_mpi_tpu_torch.resilience import frames as _frames
from pytorch_ps_mpi_tpu_torch.utils import native
from pytorch_ps_mpi_tpu_torch.utils.metrics import PSServerCounters
from pytorch_ps_mpi_tpu_torch.utils.serialization import (read_arrays,
                                                          tree_flatten)

Tree = Any
_FLOAT_NAMES = ("float16", "bfloat16", "float32", "float64")


def flat_size(template: Tree) -> int:
    """Elements of the template's leaves."""
    return sum(numel(tuple(np.shape(x))) for x in tree_flatten(template)[0])


def flatten_params(tree: Tree) -> np.ndarray:
    """The template's leaves as one float32 vector (JAX ``dcn._flatten``)."""
    leaves = tree_flatten(tree)[0]
    if not leaves:
        return np.zeros(0, np.float32)
    return np.concatenate([
        (x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x))
        .astype(np.float32, copy=False).reshape(-1) for x in leaves])


def unflatten_params(flat: np.ndarray, template: Tree) -> Tree:
    """A float32 vector as the template's tree of numpy views."""
    leaves, treedef = tree_flatten(template)
    out, off = [], 0
    for leaf in leaves:
        shape = tuple(np.shape(leaf))
        n = numel(shape)
        out.append(flat[off:off + n].reshape(shape))
        off += n
    return treedef.unflatten(out)


def _leaves_of(grad) -> list:
    return list(grad) if isinstance(grad, (list, tuple)) \
        else tree_flatten(grad)[0]


class KernelLoadError(RuntimeError):
    """A codec's kernel library did not build or load on the card: a
    fault of the installation, never a malformed request, so the
    controller and the workers let it propagate."""


class CodecWire:
    """The fixed-spec byte wire of a codec's payloads
    (``parallel/dcn.py:106``): encode before send, decode on receive.
    Payload shapes are static, so the spec (units, payload leaves, wire
    bytes) is agreed once, at construction, from the template.

    ``device`` is where the codec encodes and decodes (the card unless
    the caller asks for the CPU); ``seed`` seeds the generator of a
    stochastic codec. :meth:`encode_to_bytes` returns one of two
    ping-pong buffers, valid until the call after next."""

    def __init__(self, code, template: Tree, seed: int = 0,
                 bucket_mb: float = 0.0, device: Device = "cuda"):
        self.code = code
        self.device = resolve_device(device)
        leaves, self.treedef = tree_flatten(template)
        self.leaf_shapes = [tuple(np.shape(x)) for x in leaves]
        leaf_dtypes = [torch_dtype(x.dtype) for x in leaves]
        self.plan = None
        if bucket_mb > 0 and code.bucketable:
            self.plan = plan_buckets(
                {str(i): torch.empty(s, dtype=d, device="meta")
                 for i, (s, d) in enumerate(zip(self.leaf_shapes,
                                                leaf_dtypes))}, bucket_mb)
        if self.plan is not None:
            self.shapes = [(b.size,) for b in self.plan.buckets]
            self.dtypes = [b.dtype for b in self.plan.buckets]
        else:
            self.shapes = list(self.leaf_shapes)
            self.dtypes = leaf_dtypes
        self.dtype_names = [dtype_name(d) for d in self.dtypes]
        #: per unit: the payload's sorted keys (None for a bare tensor)
        #: and its leaves' (shape, torch dtype)
        self._structs = [self._payload_struct(s, d)
                         for s, d in zip(self.shapes, self.dtypes)]
        self._flat_specs = [spec for _, specs in self._structs
                            for spec in specs]
        self.spec_names = [(s, dtype_name(d)) for s, d in self._flat_specs]
        self._host_specs = [(s, host_dtype(d)) for s, d in self._flat_specs]
        self._offsets = []
        off = 0
        for s, d in self._flat_specs:
            self._offsets.append(off)
            off += numel(s) * d.itemsize
        self.wire_bytes = off
        self.raw_bytes = sum(numel(s) for s in self.leaf_shapes) * 4
        self._states = [code.init_state(s, d, self.device)
                        for s, d in zip(self.shapes, self.dtypes)]
        self._gen = None
        if code.needs_rng:
            self._gen = torch.Generator(device=self.device).manual_seed(seed)
        pin = self.device.type == "cuda"
        self._send = [torch.empty(self.wire_bytes, dtype=torch.uint8,
                                  pin_memory=pin) for _ in range(2)]
        # a payload tensor whose offset is not aligned to its element size
        # goes through a pinned staging tensor of its own: made here, so a
        # wire's first push costs what every later one does
        self._staging: Dict[Tuple[int, int], torch.Tensor] = {
            (idx, k): torch.empty(numel(s), dtype=d, pin_memory=pin)
            for idx in range(2)
            for k, ((s, d), off) in enumerate(zip(self._flat_specs,
                                                   self._offsets))
            if off % d.itemsize}
        self._send_idx = 0

    def load_kernels(self) -> None:
        """Build and load, on a card, the kernel libraries of the codec's
        encode and decode (the ``ops`` modules its ``kernel_ops`` names),
        without launching one. A build or load failure raises
        :class:`KernelLoadError` here, before anything switches to this
        wire. Nothing to do on the CPU, where the plain versions run."""
        if self.device.type != "cuda":
            return
        from importlib import import_module

        for name in self.code.kernel_ops:
            mod = import_module(f"pytorch_ps_mpi_tpu_torch.ops.{name}")
            try:
                mod._lib()
            except Exception as e:
                raise KernelLoadError(
                    f"{type(self.code).__name__}: the kernels of "
                    f"{mod.__name__} did not build or load: {e}") from e

    def retire(self) -> None:
        """Release the pinned ping-pong send buffers once the wire is
        retired: the device's stream is synchronized first, so the last
        non-blocking copy into them has completed."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        self._send = []
        self._staging = {}

    def _payload_struct(self, shape, dtype):
        """The payload layout of one unit, from an encode of zeros on the
        CPU (the plain versions of the kernels)."""
        gen = torch.Generator().manual_seed(0) if self.code.needs_rng else None
        with torch.no_grad():
            payload, _ = self.code.encode(
                torch.zeros(shape, dtype=dtype),
                self.code.init_state(shape, dtype, torch.device("cpu")), gen)
        if isinstance(payload, dict):
            keys = sorted(payload)
            return keys, [(tuple(payload[k].shape), payload[k].dtype)
                          for k in keys]
        return None, [(tuple(payload.shape), payload.dtype)]

    # -- send --------------------------------------------------------------
    def encode_to_bytes(self, grad) -> np.ndarray:
        """Encode ``grad`` (the template's tree or its leaves in order, in
        the JAX layout) on the wire's device and pack it into one
        preallocated wire buffer (uint8, exactly ``wire_bytes``)."""
        return self.pack(self.encode_payloads(grad))

    def encode_payloads(self, grad) -> list:
        """The units' payloads of ``grad`` on the wire's device."""
        leaves = [torch.as_tensor(g).to(self.device)
                  for g in _leaves_of(grad)]
        units = self.plan.pack_leaves(leaves) if self.plan is not None \
            else leaves
        payloads = []
        with torch.no_grad():
            for i, g in enumerate(units):
                p, self._states[i] = self.code.encode(g, self._states[i],
                                                      self._gen)
                payloads.append(p)
        return payloads

    def decode_payloads(self, payloads) -> List[torch.Tensor]:
        """The gradient's leaves that ``payloads`` (as
        :meth:`encode_payloads` gives them) decode to, on their device:
        each unit through the codec's ``decode``."""
        with torch.no_grad():
            units = [self.code.decode(p, s, d) for p, s, d in
                     zip(payloads, self.shapes, self.dtypes)]
        if self.plan is not None:
            units = self.plan.unpack_leaves(units)
        return units

    def pack(self, payloads) -> np.ndarray:
        """Pack device payloads into one of the two ping-pong wire buffers
        (valid until the call after next). Every payload tensor is copied
        with ``non_blocking`` straight to its place in a pinned buffer
        (through a pinned staging tensor where its offset is not aligned
        to its element size), and one synchronize precedes any host
        read."""
        buf = self._send[self._send_idx]
        late = []
        k = 0
        for (keys, specs), p in zip(self._structs, payloads):
            tensors = [p[key] for key in keys] if keys is not None else [p]
            for t, (shape, dtype) in zip(tensors, specs):
                off = self._offsets[k]
                nb = numel(shape) * dtype.itemsize
                if off % dtype.itemsize == 0:
                    dst = buf[off:off + nb].view(dtype)
                else:
                    dst = self._staging[(self._send_idx, k)]
                    late.append((off, nb, dst))
                dst.copy_(t.reshape(-1), non_blocking=True)
                k += 1
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        out = buf.numpy()
        for off, nb, src in late:
            out[off:off + nb] = src.view(torch.uint8).numpy()
        self._send_idx ^= 1
        return out

    def probe_fidelity(self, grad) -> Dict[str, Any]:
        """Online codec-fidelity probe on the largest wire unit (the
        largest bucket, or the biggest leaf on the per-leaf wire), on the
        wire's device through the codec's kernels
        (``Codec.fidelity_probe``): decode-after-encode relative L2
        error, cosine similarity and achieved bits-per-parameter, with
        the unit's index and the codec's name (``dcn.py:254``).
        Read-only: the wire's codec states and generator are untouched
        (a stochastic codec draws from a generator of its own, seeded
        alike every probe), so probing never perturbs what ships."""
        leaves = [torch.as_tensor(g).to(self.device)
                  for g in _leaves_of(grad)]
        units = self.plan.pack_leaves(leaves) if self.plan is not None \
            else leaves
        i = max(range(len(units)), key=lambda j: numel(self.shapes[j]) or 1)
        gen = (torch.Generator(device=self.device).manual_seed(0x9E3779B9)
               if self.code.needs_rng else None)
        out = self.code.fidelity_probe(units[i], self._states[i], gen)
        out["unit"] = i
        out["codec"] = type(self.code).__name__
        return out

    # -- receive -----------------------------------------------------------
    def payloads_from_bytes(self, buf) -> list:
        """The units' payloads as zero-copy numpy views of ``buf`` (valid
        while ``buf`` is; bf16 leaves as their uint16 bit patterns)."""
        arrays = read_arrays(buf, self._host_specs, copy=False)
        out, i = [], 0
        for keys, specs in self._structs:
            if keys is None:
                out.append(arrays[i])
            else:
                out.append(dict(zip(keys, arrays[i:i + len(keys)])))
            i += len(specs)
        return out

    def _device_payloads(self, buf) -> list:
        """The payloads as tensors on the wire's device, from one copy of
        the bytes there."""
        mv = memoryview(buf)
        if mv.nbytes < self.wire_bytes:
            raise ValueError(f"truncated buffer: the wire spec describes "
                             f"{self.wire_bytes} bytes, got {mv.nbytes}")
        host = torch.from_numpy(np.frombuffer(mv, np.uint8,
                                              count=self.wire_bytes))
        dev = host.to(self.device) if self.device.type == "cuda" \
            else host.clone()
        out, k = [], 0
        for keys, specs in self._structs:
            tensors = []
            for shape, dtype in specs:
                off = self._offsets[k]
                nb = numel(shape) * dtype.itemsize
                raw = dev[off:off + nb]
                if off % dtype.itemsize:
                    raw = raw.clone()
                tensors.append(raw.view(dtype).reshape(shape))
                k += 1
            out.append(dict(zip(keys, tensors)) if keys is not None
                       else tensors[0])
        return out

    def decode_leaves(self, buf) -> List[torch.Tensor]:
        """The gradient's leaves on the wire's device (JAX order and
        layout): each unit decoded as a one-rank ``decode_sum``."""
        units = []
        with torch.no_grad():
            for p, s, d in zip(self._device_payloads(buf), self.shapes,
                               self.dtypes):
                stacked = ({k: v.unsqueeze(0) for k, v in p.items()}
                           if isinstance(p, dict) else p.unsqueeze(0))
                units.append(self.code.decode_sum(stacked, s, d))
        if self.plan is not None:
            units = self.plan.unpack_leaves(units)
        return units

    def decode_from_bytes(self, buf) -> Tree:
        """The decoded gradient as the template's tree of tensors."""
        return self.treedef.unflatten(self.decode_leaves(buf))

    # -- compressed-domain aggregation --------------------------------------
    @property
    def agg_supported(self) -> bool:
        """True when every unit can aggregate in the compressed domain."""
        return bool(self.code.supports_aggregate) and all(
            self.code.can_aggregate(s, d)
            for s, d in zip(self.shapes, self.dtypes))

    def agg_begin(self) -> "WireAggregator":
        return WireAggregator(self)

    def payload_finite(self, buf) -> bool:
        """True when every float leaf of the payload is finite (for int8,
        one scale a unit): the aggregation path's non-finite screen."""
        for a, (_, name) in zip(read_arrays(buf, self._host_specs,
                                            copy=False), self.spec_names):
            if name not in _FLOAT_NAMES:
                continue
            if name == "bfloat16":
                a = (a.astype(np.uint32) << 16).view(np.float32)
            if not np.all(np.isfinite(a)):
                return False
        return True


class WireAggregator:
    """One round's compressed-domain accumulator over a :class:`CodecWire`
    (``parallel/dcn.py:347``): :meth:`fold` takes one push's payload
    bytes (host numpy, no device work), :meth:`finalize` decodes once and
    returns the summed gradient as the template's tree of numpy arrays."""

    def __init__(self, wire: CodecWire):
        self.wire = wire
        self._accs = [wire.code.agg_init(s, d)
                      for s, d in zip(wire.shapes, wire.dtypes)]
        self.frames = 0

    def fold(self, buf) -> None:
        code = self.wire.code
        for acc, p in zip(self._accs, self.wire.payloads_from_bytes(buf)):
            code.agg_fold(acc, p)
        self.frames += 1

    def finalize_leaves(self) -> List[np.ndarray]:
        """The summed gradient's leaves (JAX order and layout); pooled
        sparse buffers go back to the pool here."""
        wire = self.wire
        units = [np.asarray(wire.code.agg_finalize(acc, s, d))
                 for acc, s, d in zip(self._accs, wire.shapes, wire.dtypes)]
        if wire.plan is not None:
            units = [x.numpy() for x in wire.plan.unpack_leaves(
                [torch.from_numpy(u) for u in units])]
        return units

    def finalize(self) -> Tree:
        return self.wire.treedef.unflatten(self.finalize_leaves())

    def release(self) -> None:
        """Hand pooled sparse buffers back (a dropped round)."""
        for acc in self._accs:
            if isinstance(acc, dict):
                sparse_agg_release(acc)

    def __del__(self):
        try:
            self.release()
        except Exception:
            pass  # interpreter teardown


class _ServerBase(PSServerCounters):
    """What the shm and TCP servers share: the wire agreement, the
    counters, publishing and decoding."""

    def _init_wire(self, num_workers: int, template: Tree,
                   max_staleness: int, code, bucket_mb: float, frame: bool,
                   tree_slots: int, device: Device) -> int:
        self.template = template
        self.num_workers = num_workers
        self.max_staleness = max_staleness
        self.device = resolve_device(device)
        self.wire = (CodecWire(code, template, bucket_mb=bucket_mb,
                               device=self.device)
                     if code is not None else None)
        self._flat_params = flat_size(template)
        self._template_leaves, self._treedef = tree_flatten(template)
        payload = (self.wire.wire_bytes if self.wire
                   else self._flat_params * 4)
        # tree_slots > 0: an aggregation-tree parent, every push carrying
        # a composed-lineage trailer inside its frame
        self.tree_slots = int(tree_slots)
        self.tree_composed = 0
        self._wire_payload_bytes = payload
        self.frame = bool(frame)
        if self.tree_slots:
            if not self.frame:
                raise ValueError("tree_slots requires frame=True (the "
                                 "lineage trailer rides the framed wire)")
            payload += _frames.trailer_bytes(self.tree_slots)
            self._composed_queue: collections.deque = collections.deque()
        self._expected_payload = payload
        if self.frame:
            self._fingerprint = _frames.wire_fingerprint(
                self.wire, template, tree_slots=self.tree_slots)
            payload += _frames.HEADER_BYTES
        self.version = 0
        self.stale_drops = 0
        self.staleness_seen: Dict[int, int] = {}
        self.grads_received = 0
        self.bytes_received = 0
        self.last_seen: Dict[int, float] = {}
        # the trace IDs of the last consumed push, and of a batch's
        self.last_push_meta: Optional[Dict[str, Any]] = None
        self.last_batch_metas: List[Dict[str, Any]] = []
        self._t0 = time.time()
        self._t0_mono = time.monotonic()
        return payload

    def publish(self, params: Tree) -> None:
        self.publish_flat(flatten_params(params))

    def _decode_payload(self, payload: np.ndarray, wire=None) -> Tree:
        """Payload bytes (a view of the receive buffer) -> the gradient
        as the template's tree of tensors on the server's device.
        ``wire`` is an old epoch's wire during a codec renegotiation."""
        self.decodes_done += 1
        wire = wire if wire is not None else self.wire
        if wire is not None:
            return wire.decode_from_bytes(payload)
        flat = torch.from_numpy(np.frombuffer(payload, np.float32).copy())
        flat = flat.to(self.device)
        out, off = [], 0
        for shape in (tuple(np.shape(x)) for x in self._template_leaves):
            n = numel(shape)
            out.append(flat[off:off + n].reshape(shape))
            off += n
        return self._treedef.unflatten(out)

    # -- codec renegotiation (the controller's wire-epoch bump) -----------
    def renegotiate_wire(self, code, bucket_mb: float = 0.0) -> None:
        """Install a new codec wire as the current epoch
        (``dcn.py:404``, ``:601``): the new :class:`CodecWire` is built on
        the server's device with its kernels loaded, the old wire stays
        in ``_epoch_table`` so in-flight old-epoch frames are consumed
        with it, and the new fingerprint becomes current. The fingerprint
        is the epoch discriminator, so the transport protocol does not
        change. A ladder rung's frame may not exceed the boot wire's:
        every transport buffer was sized once, at boot."""
        if not self.frame:
            raise RuntimeError("wire renegotiation requires frame_check "
                               "(the fingerprint is the epoch handshake)")
        if self.wire is None:
            raise RuntimeError("wire renegotiation requires a codec wire")
        if self.tree_slots:
            raise RuntimeError("wire renegotiation is not supported on "
                               "tree wires (the hop codec is the tree's "
                               "own agreement)")
        if getattr(self, "agg_mode", 0.0):
            raise RuntimeError("suspend compressed-domain aggregation "
                               "before renegotiating (mixed-epoch payloads "
                               "cannot share one accumulator)")
        new_wire = CodecWire(code, self.template, bucket_mb=bucket_mb,
                             device=self.device)
        new_frame = new_wire.wire_bytes + _frames.HEADER_BYTES
        # the cap is the boot wire's frame, latched at the first
        # renegotiation, when self.wire is still the boot wire
        cap = self.__dict__.setdefault(
            "_reneg_frame_cap",
            self._expected_payload + _frames.HEADER_BYTES)
        if new_frame > cap:
            raise ValueError(
                f"renegotiated wire needs {new_frame} B frames but the "
                f"boot wire (and every worker's frame buffer) was sized "
                f"for {cap} B: ladder entries must not exceed the boot "
                "wire's payload size")
        new_wire.load_kernels()
        table = self.__dict__.setdefault("_epoch_table", {})
        table[self._fingerprint] = {"wire": self.wire,
                                    "expected": self._expected_payload,
                                    "epoch": getattr(self, "_epoch", 0)}
        while len(table) > 2:  # at most two retiring epochs in flight
            table.pop(next(iter(table)))["wire"].retire()
        self._epoch = getattr(self, "_epoch", 0) + 1
        self.wire = new_wire
        self._fingerprint = _frames.wire_fingerprint(new_wire,
                                                     self.template)
        self._expected_payload = new_wire.wire_bytes
        self._wire_payload_bytes = new_wire.wire_bytes
        self._epoch_transition = True

    def finish_renegotiation(self) -> None:
        """Retire every old epoch: a retired fingerprint's frames are
        counted ``"config"`` rejections again, and the old wires' pinned
        buffers are released."""
        for ep in getattr(self, "_epoch_table", {}).values():
            ep["wire"].retire()
        self._epoch_table = {}
        self._epoch_transition = False

    def _finish_pop(self, n: int, worker: int, version: int, raw: bool):
        """The unframed wire's bookkeeping of one popped push: the item,
        or None for a stale drop (``dcn.py:619-664``)."""
        staleness = max(0, self.version - version)
        self.staleness_seen[staleness] = self.staleness_seen.get(
            staleness, 0) + 1
        self.last_seen[worker] = time.time()
        self.grads_received += 1
        self.bytes_received += n
        if n != self._expected_payload:
            raise RuntimeError(
                f"payload size {n} != wire spec {self._expected_payload} "
                "bytes: worker and server codec configs disagree")
        if staleness > self.max_staleness:
            self.stale_drops += 1
            return None
        view = self._grad_buf[:n]
        return worker, version, view if raw else self._decode_payload(view)

    def _check_raw(self, raw: bool) -> None:
        if raw and not self.wire:
            raise ValueError("poll_grad(raw=True) needs a codec wire")


class ShmPSServer(_ServerBase):
    """Owns the parameters, publishes snapshots and consumes gradients in
    arrival order (``dcn.py:483``). With ``code=`` the mailboxes carry
    payload bytes and the server decodes them on ``device``."""

    def __init__(self, name: str, num_workers: int, template: Tree,
                 max_staleness: int = 4, code=None, bucket_mb: float = 0.0,
                 frame: bool = False, tree_slots: int = 0,
                 device: Device = "cuda"):
        self._h = None
        self._lib = native.psqueue_lib()
        slot = self._init_wire(num_workers, template, max_staleness, code,
                               bucket_mb, frame, tree_slots, device)
        self._h = self._lib.psq_create(name.encode(), num_workers,
                                       self._flat_params * 4, slot)
        if not self._h:
            raise RuntimeError(f"psq_create({name}) failed")
        self._grad_buf = np.empty(slot, np.uint8)
        self._cursor = ctypes.c_uint32(0)

    def publish_flat(self, flat: np.ndarray) -> None:
        """Publish a float32 snapshot of the template's leaves."""
        flat = np.ascontiguousarray(flat, np.float32)
        self.version += 1
        if self._lib.psq_publish_params(self._h, native.u8(flat.view(
                np.uint8)), flat.nbytes, self.version) != 0:
            raise RuntimeError("psq_publish_params failed")

    def _pop(self) -> Tuple[int, int, int]:
        worker, version = ctypes.c_uint32(), ctypes.c_uint64()
        n = self._lib.psq_pop_grad(self._h, native.u8(self._grad_buf),
                                   self._grad_buf.nbytes,
                                   ctypes.byref(worker),
                                   ctypes.byref(version),
                                   ctypes.byref(self._cursor))
        return int(n), int(worker.value), int(version.value)

    def poll_grad(self, raw: bool = False):
        """One pending gradient as ``(worker, version, grad_tree)``, or
        None. Stale gradients are dropped and counted; ``raw=True``
        returns the validated payload bytes (a view of the receive
        buffer) for the compressed-domain fold."""
        self._check_raw(raw)
        if self.frame:
            return _frames.framed_poll(self, self._pop, raw=raw)
        while True:
            n, worker, version = self._pop()
            if n <= 0:
                return None
            item = self._finish_pop(n, worker, version, raw)
            if item is not None:
                return item

    def reset_worker_slot(self, worker: int) -> None:
        """Empty a crashed worker's mailbox for its replacement (a process
        killed mid-write leaves the slot wedged) and restart its liveness
        clock (``dcn.py:704``). Only after its owner is dead."""
        rc = self._lib.psq_reset_slot(self._h, worker)
        if rc != 0:
            raise ValueError(f"psq_reset_slot({worker}) -> {rc}")
        self.last_seen[int(worker)] = time.time()

    def stragglers(self, timeout: float) -> Dict[int, float]:
        """Workers silent for ``timeout`` seconds, nothing pending in their
        mailbox; never-seen workers age from the server's start
        (``dcn.py:722``)."""
        now = time.time()
        out = {}
        for w in range(self.num_workers):
            if self._lib.psq_grad_pending(self._h, w) == 1:
                continue  # pushed, awaiting consumption: alive
            age = now - self.last_seen.get(w, self._t0)
            if age > timeout:
                out[w] = age
        return out

    def close(self) -> None:
        self._close_serving()
        if self._h:
            self._lib.psq_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class _WorkerBase:
    """What the shm and TCP workers share: the wire and the frame seal."""

    def _init_wire(self, worker_id: int, template: Tree, code, seed: int,
                   bucket_mb: float, frame: bool, tree_slots: int,
                   device: Device) -> None:
        self.worker_id = worker_id
        self.template = template
        self.device = resolve_device(device)
        self._seed = seed + worker_id  # a renegotiated wire's seed too
        self.wire = (CodecWire(code, template, seed=self._seed,
                               bucket_mb=bucket_mb, device=self.device)
                     if code is not None else None)
        self.frame = bool(frame)
        self._auto_seq = 0
        self._tamper = None  # one-shot outgoing-bytes hook (faults)
        self._wire_delay_s = 0.0  # one-shot post-seal delay (wire_delay)
        # tree_slots > 0: pushes to an aggregation-tree parent carry a
        # composed-lineage trailer (by default composing this worker)
        self.tree_slots = int(tree_slots)
        if self.tree_slots and not self.frame:
            raise ValueError("tree_slots requires frame=True")
        payload = (self.wire.wire_bytes if self.wire
                   else flat_size(template) * 4)
        if self.frame:
            self._fingerprint = _frames.wire_fingerprint(
                self.wire, template, tree_slots=self.tree_slots)
            self._frame_buf = np.empty(
                _frames.HEADER_BYTES + payload
                + _frames.trailer_bytes(self.tree_slots), np.uint8)
        self._param_buf = np.empty(flat_size(template), np.float32)
        self.reads_total = 0
        #: ladder rungs' wires built ahead of their epochs (prepare_wire)
        self._prepared: Dict[Any, CodecWire] = {}

    def set_tamper(self, fn) -> None:
        """Arm a one-shot hook on the next push's sealed bytes (faults)."""
        self._tamper = fn

    def set_wire_delay(self, delay_s: float) -> None:
        """Arm a one-shot sleep after the next push's seal (faults)."""
        self._wire_delay_s = float(delay_s)

    def encode(self, grad) -> np.ndarray:
        """The push's payload bytes: the codec wire's, or the raw float32
        leaves without a codec."""
        if self.wire is not None:
            return self.wire.encode_to_bytes(grad)
        return flatten_params(_leaves_of(grad))

    def push_grad(self, grad, version: int, timeout: float = 30.0,
                  lineage: Optional[Tuple[int, int]] = None,
                  composed=None) -> None:
        """Encode ``grad`` (the template's tree or its leaves, JAX layout)
        and push it tagged with ``version``. ``lineage=(step, seq)`` goes
        into the frame header; on a tree wire ``composed`` lists the
        trailer's trace IDs (default: this push alone)."""
        self.push_payload(self.encode(grad), version, timeout=timeout,
                          lineage=lineage, composed=composed)

    def _seal(self, flat: np.ndarray, lineage: Optional[Tuple[int, int]],
              composed=None) -> np.ndarray:
        """The bytes to send: the sealed frame (or ``flat`` unframed),
        then the one-shot fault hooks: a tamper corrupts the sealed bytes,
        a wire delay sleeps after the seal (``dcn.py:899-925``)."""
        if self.frame:
            step, seq = (lineage if lineage is not None
                         else (0, self._auto_seq))
            self._auto_seq += 1
            if self.tree_slots and composed is None:
                composed = [(self.worker_id, step, seq, time.time())]
            flat = _frames.seal_frame(self._frame_buf, flat,
                                      self._fingerprint, step=step, seq=seq,
                                      composed=composed,
                                      tree_slots=self.tree_slots)
        if self._tamper is not None:
            tamper, self._tamper = self._tamper, None
            tamper(flat.view(np.uint8))
        delay, self._wire_delay_s = self._wire_delay_s, 0.0
        if delay:
            time.sleep(delay)
        return flat

    def _new_wire(self, code, bucket_mb: float) -> Optional[CodecWire]:
        """A codec wire for a renegotiated epoch on this worker's device,
        seeded alike, its kernels loaded (a build or load failure
        raises); None when this worker cannot switch to it: an unframed
        or codec-less wire, a tree trailer wire, or a payload the
        boot-sized frame buffer cannot hold."""
        if not self.frame or self.wire is None or self.tree_slots:
            return None
        wire = CodecWire(code, self.template, seed=self._seed,
                         bucket_mb=bucket_mb, device=self.device)
        if _frames.HEADER_BYTES + wire.wire_bytes > self._frame_buf.nbytes:
            return None
        wire.load_kernels()
        return wire

    def prepare_wire(self, key, code, bucket_mb: float = 0.0) -> bool:
        """Build the wire of a ladder rung (named ``key``) before its
        epoch comes, so that :meth:`renegotiate` at a step swaps it in:
        the build (an encode of zeros of every unit on the CPU, for the
        payload layout, the codec's state and the pinned buffers) then
        falls outside any push, whose staleness the controller reads.
        A kernel build or load failure raises here. Returns False where
        :meth:`renegotiate` would decline."""
        wire = self._new_wire(code, bucket_mb)
        if wire is not None:
            self._prepared[key] = wire
        return wire is not None

    def renegotiate(self, code, bucket_mb: float = 0.0, key=None) -> bool:
        """Switch to a renegotiated codec epoch (``dcn.py:447``, ``:938``):
        the wire :meth:`prepare_wire` built for ``key``, else a new one
        (:meth:`_new_wire`: its kernels loaded before the switch), and
        its fingerprint. Returns False, declining, where
        :meth:`_new_wire` gives None; a declining worker keeps pushing
        its old epoch, which the server consumes until that epoch
        retires. The old wire's pinned buffers are released once its
        stream has drained."""
        new_wire = self._prepared.pop(key, None)
        if new_wire is None:
            new_wire = self._new_wire(code, bucket_mb)
        if new_wire is None:
            return False
        old, self.wire = self.wire, new_wire
        self._fingerprint = _frames.wire_fingerprint(new_wire, self.template)
        old.retire()
        return True

    def read_params(self, timeout: float = 30.0) -> Tuple[Tree, int]:
        """The latest snapshot as the template's tree of numpy arrays."""
        flat, version = self.read_flat(timeout)
        return unflatten_params(flat, self.template), version


class ShmPSWorker(_WorkerBase):
    """Reads the latest parameters whenever it likes and pushes
    version-tagged gradients (``dcn.py:763``)."""

    def __init__(self, name: str, worker_id: int, template: Tree,
                 timeout: float = 30.0, code=None, seed: int = 0,
                 bucket_mb: float = 0.0, frame: bool = False,
                 cached_reads: bool = False, tree_slots: int = 0,
                 device: Device = "cuda"):
        self._lib = native.psqueue_lib()
        self._h = None
        deadline = time.time() + timeout
        while time.time() < deadline:
            h = self._lib.psq_open(name.encode())
            if h:
                self._h = h
                break
            time.sleep(0.05)
        if not self._h:
            raise TimeoutError(f"psq_open({name}) timed out")
        self._init_wire(worker_id, template, code, seed, bucket_mb, frame,
                        tree_slots, device)
        self.cached_reads = bool(cached_reads)
        self._cached: Optional[Tuple[np.ndarray, int]] = None
        self.reads_not_modified = 0

    def read_flat(self, timeout: float = 30.0) -> Tuple[np.ndarray, int]:
        """The latest snapshot as a fresh float32 vector and its version;
        blocks until the first publish. With ``cached_reads`` an unchanged
        version returns the cached vector (do not mutate it)."""
        self.reads_total += 1
        if self.cached_reads and self._cached is not None:
            v = int(self._lib.psq_params_version(self._h))
            if v == self._cached[1] and v > 0:
                self.reads_not_modified += 1
                return self._cached
        version = ctypes.c_uint64()
        deadline = time.time() + timeout
        while True:
            n = self._lib.psq_read_params(
                self._h, native.u8(self._param_buf.view(np.uint8)),
                self._param_buf.nbytes, ctypes.byref(version))
            if n == -2:  # seqlock starved by a fast writer: retry
                if time.time() > deadline:
                    raise TimeoutError("psq_read_params starved (seqlock)")
                time.sleep(0.01)
                continue
            if n < 0:
                raise RuntimeError(f"psq_read_params -> {n}")
            if version.value > 0:
                break
            if time.time() > deadline:
                raise TimeoutError("no parameter snapshot published yet")
            time.sleep(0.002)
        out = (self._param_buf[:n // 4].copy(), int(version.value))
        if self.cached_reads:
            self._cached = out
        return out

    def push_payload(self, flat: np.ndarray, version: int,
                     timeout: float = 30.0,
                     lineage: Optional[Tuple[int, int]] = None,
                     composed=None) -> None:
        """Push pre-encoded payload bytes; a full mailbox is retried until
        ``timeout``."""
        flat = self._seal(flat, lineage, composed)
        deadline = time.time() + timeout
        while time.time() < deadline:
            rc = self._lib.psq_push_grad(self._h, self.worker_id,
                                         native.u8(flat.view(np.uint8)),
                                         flat.nbytes, version)
            if rc == 1:
                return
            if rc < 0:
                raise RuntimeError("psq_push_grad failed")
            time.sleep(0.002)  # mailbox full: the server has not popped it
        raise TimeoutError("push_grad timed out")

    def close(self) -> None:
        if self._h:
            self._lib.psq_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

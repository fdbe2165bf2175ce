"""The async parameter server over TCP (``pytorch_ps_mpi_tpu/parallel/tcp.py``).

The same protocol as ``parallel/dcn.py`` between hosts, through
``native/tcpps.cpp``: a worker's push is acknowledged by the server, so a
worker has at most one gradient in flight; a crashed worker's socket
closes, a positive liveness signal. With frame checking on,
:meth:`TcpPSServer.poll_grad_batch` drains every queued push with one
pump and one C++ pop, each frame already validated in C++ (magic,
version, size, fingerprint, CRC32), so the per-push Python cost is
bookkeeping. ``PS_NO_NATIVE=1`` sends the serve loop back to the
per-frame :meth:`TcpPSServer.poll_grad`.
"""

from __future__ import annotations

import ctypes
import socket
import time
from typing import Dict, Optional, Tuple

import numpy as np

from pytorch_ps_mpi_tpu_torch.mesh import Device
from pytorch_ps_mpi_tpu_torch.parallel.dcn import (Tree, _ServerBase,
                                                   _WorkerBase,
                                                   unflatten_params)
from pytorch_ps_mpi_tpu_torch.resilience import frames as _frames
from pytorch_ps_mpi_tpu_torch.utils import native


def native_profile_stats() -> Optional[dict]:
    """The epoll pump's cycle counters (calls, events, wall ns, frames
    validated), the native half of the sampling profiler
    (``tcp.py:222``). Reads an already loaded library only, never
    builds one: None when ``native/tcpps.cpp`` is not loaded."""
    lib = native._LIBS.get("tcpps")
    if lib is None:
        return None
    calls, events = ctypes.c_uint64(), ctypes.c_uint64()
    ns, frames = ctypes.c_uint64(), ctypes.c_uint64()
    lib.tps_profile_stats(ctypes.byref(calls), ctypes.byref(events),
                          ctypes.byref(ns), ctypes.byref(frames))
    return {"pump_calls": int(calls.value), "pump_events": int(events.value),
            "pump_ns": int(ns.value), "frames_validated": int(frames.value)}


class TcpPSServer(_ServerBase):
    """Serves snapshots and consumes gradients arriving over TCP in
    arrival order (``tcp.py:243``); ``port=0`` picks a free port (read
    back as ``.port``)."""

    def __init__(self, port: int, num_workers: int, template: Tree,
                 max_staleness: int = 4, code=None, bucket_mb: float = 0.0,
                 frame: bool = False, tree_slots: int = 0,
                 device: Device = "cuda"):
        self._h = None
        self._lib = native.tcpps_lib()
        grad_bytes = self._init_wire(num_workers, template, max_staleness,
                                     code, bucket_mb, frame, tree_slots,
                                     device)
        max_msg = max(self._flat_params * 4, grad_bytes)
        self._h = self._lib.tps_server_create(port, num_workers, max_msg)
        if not self._h:
            raise RuntimeError(f"tps_server_create(port={port}) failed")
        self.port = int(self._lib.tps_server_port(self._h))
        self._batch_max = 0
        if self.frame:
            payload = self._expected_payload
            self._lib.tps_server_set_frame_check(self._h, self._fingerprint,
                                                 payload)
            # up to 64 payloads, at most ~16 MB of batch buffer
            self._batch_max = max(1, min(64, (16 << 20) // max(payload, 1)))
            self._batch_buf = np.empty(self._batch_max * payload, np.uint8)
            self._batch_metas = (native.BatchMeta * self._batch_max)()
        self.native_batches = 0
        self.native_batch_frames = 0
        # the frame path keeps headroom to max_msg, so a mismatched
        # worker's larger frame pops whole and is judged by its header
        self._grad_buf = np.empty(max_msg if self.frame
                                  else self._expected_payload, np.uint8)

    def _refresh_read_stats(self) -> None:
        total, nm = ctypes.c_uint64(), ctypes.c_uint64()
        self._lib.tps_server_read_stats(self._h, ctypes.byref(total),
                                        ctypes.byref(nm))
        self._reads_total = int(total.value)
        self._reads_not_modified = int(nm.value)

    def hop_stamps_arm(self, capacity: int) -> bool:
        """Arm (``capacity > 0``) or disarm (0) the native per-frame
        ingest stamp ring the hop anatomy drains (``tcp.py:369``); True
        when it is live. ``PS_NO_NATIVE`` keeps the Python stamps. Call
        from the pump-owning thread only."""
        if native.fast_path_disabled():
            return False
        if int(self._lib.tps_abi_hop_stamp_bytes()) != ctypes.sizeof(
                native.HopStamp):
            raise RuntimeError("native/tcpps.cpp HopStamp ABI drift")
        ok = int(self._lib.tps_hop_stamps_arm(int(capacity))) == 0
        self._hop_stamps_armed = ok and capacity > 0
        return self._hop_stamps_armed

    def drain_hop_stamps(self, max_stamps: int = 4096
                         ) -> Optional[Tuple[list, int]]:
        """``([(t_ns, validate_ns, bytes, worker, status), ...], dropped)``
        from the armed stamp ring, oldest first, or None when it is not
        armed (``tcp.py:385``). Pump-owning thread only."""
        if not getattr(self, "_hop_stamps_armed", False):
            return None
        buf = (native.HopStamp * int(max_stamps))()
        dropped = ctypes.c_uint64()
        n = int(self._lib.tps_hop_stamps_drain(buf, int(max_stamps),
                                               ctypes.byref(dropped)))
        return ([(int(buf[i].t_ns), int(buf[i].validate_ns),
                  int(buf[i].bytes), int(buf[i].worker),
                  int(buf[i].status)) for i in range(n)],
                int(dropped.value))

    def finish_renegotiation(self) -> None:
        """Retire every old epoch (``tcp.py:448``) and point the native
        frame validator, and the batch buffer's sizing, at the current
        wire: the batched ingest, bypassed during the transition, is
        re-armed."""
        super().finish_renegotiation()
        if self._batch_max:
            payload = self._expected_payload
            self._lib.tps_server_set_frame_check(self._h, self._fingerprint,
                                                 payload)
            batch_max = max(1, min(64, (16 << 20) // max(payload, 1)))
            if batch_max * payload > self._batch_buf.nbytes:
                self._batch_buf = np.empty(batch_max * payload, np.uint8)
            if batch_max != self._batch_max:
                self._batch_metas = (native.BatchMeta * batch_max)()
                self._batch_max = batch_max

    def publish_flat(self, flat: np.ndarray) -> None:
        """Publish a float32 snapshot of the template's leaves."""
        flat = np.ascontiguousarray(flat, np.float32)
        self.version += 1
        if self._lib.tps_server_publish(self._h, native.u8(flat.view(
                np.uint8)), flat.nbytes, self.version) != 0:
            raise RuntimeError("tps_server_publish failed")
        self._lib.tps_server_pump(self._h)  # serve waiting readers promptly
        self._refresh_read_stats()

    def _pop(self) -> Tuple[int, int, int]:
        worker, version = ctypes.c_uint32(), ctypes.c_uint64()
        n = self._lib.tps_server_pop_grad(self._h, native.u8(self._grad_buf),
                                          self._grad_buf.nbytes,
                                          ctypes.byref(worker),
                                          ctypes.byref(version))
        if n < 0:
            raise RuntimeError("tps_server_pop_grad: payload exceeds the "
                               "wire spec: worker and server configs "
                               "disagree")
        return int(n), int(worker.value), int(version.value)

    def poll_grad(self, raw: bool = False):
        """One pending gradient as ``(worker, version, grad_tree)``, or
        None; pumps the sockets first. ``raw=True`` returns the validated
        payload bytes (a view of the receive buffer)."""
        self._check_raw(raw)
        self._lib.tps_server_pump(self._h)
        self._refresh_read_stats()
        if self.frame:
            return _frames.framed_poll(self, self._pop, raw=raw)
        while True:
            n, worker, version = self._pop()
            if n == 0:
                return None
            item = self._finish_pop(n, worker, version, raw)
            if item is not None:
                return item

    def poll_grad_batch(self, raw: bool = False) -> Optional[list]:
        """The native batched ingest (``tcp.py:520``): the consumed
        ``(worker, version, grad)`` list ([] when nothing is pending), or
        None when it is unavailable (frames off, ``PS_NO_NATIVE``, or a
        codec renegotiation in transition).
        Raw payload views alias the batch buffer until the next call."""
        if not self._batch_max or native.fast_path_disabled():
            return None
        if getattr(self, "_epoch_transition", False):
            # mid-renegotiation the C++ validator knows one fingerprint:
            # the Python framed poll consumes both epochs until
            # finish_renegotiation re-arms it
            return None
        self._check_raw(raw)
        self._lib.tps_server_pump(self._h)
        self._refresh_read_stats()
        n = self._lib.tps_server_pop_grad_batch(
            self._h, native.u8(self._batch_buf), self._batch_buf.nbytes,
            self._batch_metas, self._batch_max)
        if n <= 0:
            self.last_batch_metas = []
            return []
        self.native_batches += 1
        self.native_batch_frames += int(n)

        def gen():
            for i in range(n):
                m = self._batch_metas[i]
                wid = int(m.worker)
                payload = (self._batch_buf[int(m.off):int(m.off) + int(m.len)]
                           if not m.status else None)
                yield (wid, int(m.version), int(m.status), payload,
                       int(m.step), int(m.seq), float(m.send_wall))

        return _frames.framed_batch_consume(self, gen(), raw=raw)

    def connected(self, worker: int) -> bool:
        """Does a socket claiming this worker id exist now? A crashed
        worker's connection closes, a positive death signal
        (``tcp.py:618``)."""
        self._lib.tps_server_pump(self._h)
        return bool(self._lib.tps_server_connected(self._h, worker))

    def stragglers(self, timeout: float) -> Dict[int, float]:
        """Workers with nothing queued and no open socket, silent for
        ``timeout`` seconds (``tcp.py:626``); one never seen is reported
        at once."""
        self._lib.tps_server_pump(self._h)
        now = time.time()
        out = {}
        for w in range(self.num_workers):
            if self._lib.tps_server_pending(self._h, w) > 0:
                continue  # pushed, awaiting consumption: alive
            if self._lib.tps_server_connected(self._h, w) == 1:
                continue  # an open socket: alive, maybe slow
            if w not in self.last_seen:
                out[w] = now - self._t0
                continue
            age = now - self.last_seen[w]
            if age > timeout:
                out[w] = age
        return out

    def close(self) -> None:
        self._close_serving()
        if self._h:
            self._lib.tps_server_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class TcpPSWorker(_WorkerBase):
    """Connects to a :class:`TcpPSServer`, reads the latest parameters and
    pushes version-tagged gradients (``tcp.py:677``). Reads are
    version-conditional by default: an unchanged snapshot comes back as a
    header-only not-modified reply."""

    def __init__(self, host: str, port: int, worker_id: int, template: Tree,
                 timeout: float = 30.0, code=None, seed: int = 0,
                 bucket_mb: float = 0.0, frame: bool = False,
                 cached_reads: bool = True, tree_slots: int = 0,
                 device: Device = "cuda"):
        self._h = None
        self._lib = native.tcpps_lib()
        try:
            addr = socket.gethostbyname(host)
        except OSError as e:
            raise RuntimeError(f"cannot resolve PS host {host!r}: {e}") from e
        self._addr = (addr, port, int(timeout * 1000))
        self._h = self._lib.tps_worker_connect(addr.encode(), port, worker_id,
                                               int(timeout * 1000))
        if not self._h:
            raise TimeoutError(f"tps_worker_connect({host}={addr}:{port}) "
                               "timed out")
        self._init_wire(worker_id, template, code, seed, bucket_mb, frame,
                        tree_slots, device)
        self.cached_reads = bool(cached_reads)
        self._cached: Optional[Tuple[np.ndarray, int]] = None
        self.reads_not_modified = 0

    def read_flat(self, timeout: float = 30.0) -> Tuple[np.ndarray, int]:
        """The latest snapshot as a float32 vector and its version (the
        cached vector on a not-modified reply: do not mutate it)."""
        self.reads_total += 1
        version = ctypes.c_uint64()
        deadline = time.time() + timeout
        have = self._cached[1] if (self.cached_reads
                                   and self._cached is not None) else 0
        while True:
            left_ms = max(1, int((deadline - time.time()) * 1000))
            n = self._lib.tps_worker_read_params(
                self._h, native.u8(self._param_buf.view(np.uint8)),
                self._param_buf.nbytes, ctypes.byref(version), left_ms, have)
            if n == -4:
                self.reads_not_modified += 1
                return self._cached
            if n == -2:
                self._reopen()
                raise TimeoutError("tps_worker_read_params timed out")
            if n < 0:
                raise RuntimeError(f"tps_worker_read_params -> {n}")
            if version.value > 0:
                break
            if time.time() > deadline:
                raise TimeoutError("no parameter snapshot published yet")
            time.sleep(0.002)
        out = (self._param_buf[:n // 4].copy(), int(version.value))
        if self.cached_reads:
            self._cached = out
        return out

    def read_params(self, timeout: float = 30.0) -> Tuple[Tree, int]:
        flat, version = self.read_flat(timeout)
        return unflatten_params(flat.copy(), self.template), version

    def push_payload(self, flat: np.ndarray, version: int,
                     timeout: float = 30.0,
                     lineage: Optional[Tuple[int, int]] = None,
                     composed=None) -> None:
        """Push pre-encoded payload bytes and wait for the server's ack."""
        flat = self._seal(flat, lineage, composed)
        rc = self._lib.tps_worker_push_grad(self._h,
                                            native.u8(flat.view(np.uint8)),
                                            flat.nbytes, version,
                                            int(timeout * 1000))
        if rc == -2:
            self._reopen()
            raise TimeoutError("push_grad timed out awaiting server ack")
        if rc != 1:
            raise RuntimeError(f"tps_worker_push_grad -> {rc}")

    def _reopen(self) -> None:
        """A call that timed out can leave the rest of its reply on the
        socket, where the next call would read it as its own header (the
        JAX worker's next call then fails with a bad magic, ROADMAP queue
        3 item 17): start a new connection instead. Raises
        ``RuntimeError`` when the server is gone."""
        addr, port, timeout_ms = self._addr
        self.close()
        # a short connect: a refused port is a dead server, not a slow one
        self._h = self._lib.tps_worker_connect(addr.encode(), port,
                                               self.worker_id,
                                               min(timeout_ms, 1000))
        if not self._h:
            raise RuntimeError(f"tps_worker_connect({addr}:{port}) failed "
                               "after a timed-out call")

    def close(self) -> None:
        if self._h:
            self._lib.tps_worker_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

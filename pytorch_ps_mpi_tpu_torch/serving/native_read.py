"""The native PSR1 read tier: ctypes bindings and the server wrapper
(``pytorch_ps_mpi_tpu/serving/native_read.py``).

The C++ half is ``native/tcpps.cpp``'s ``tps_read_*`` exports, shared
with the JAX package and unchanged: an epoll loop that accepts,
validates and answers PSR1 reads in C++, with zero-copy ``writev`` of
frozen snapshot and delta views and replies byte for byte those of the
``serving/net.py`` loop (the fallback, armed by ``PS_NO_NATIVE`` or
``cfg["read_native"] = False``). The library is built and loaded by the
port's ``utils/native.py``.

:class:`NativeReadServer` has the surface :class:`~.net.ReadTierServer`
shows the :class:`~.core.ServingCore` (``port``, ``queue_depth()``,
``connections()``, ``close()``) plus the publish hook: on each publish it
pins the frozen snapshot, encodes the ring's ``base -> latest`` deltas
once (on the publishing thread, the serve loop's) and hands
``(ptr, len, token)`` views to C++. When the last send of a superseded
buffer drains, its token comes back through ``tps_read_released`` and
the pump thread releases the pin. Every ``tps_read_*`` entry point takes
the server's own mutex in C++, so the pump, publish and scrape threads
may all call it.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Callable, Dict, Optional

import numpy as np

from pytorch_ps_mpi_tpu_torch.utils import native

_read_lib: Optional[ctypes.CDLL] = None
_read_lib_failed = False


class _ReadStats(ctypes.Structure):
    """Mirror of native/tcpps.cpp ReadStats (128 bytes, packed)."""

    _pack_ = 1
    _fields_ = [(name, ctypes.c_uint64) for name in (
        "conns", "accepted_total", "pending", "reads_total", "reads_full",
        "reads_delta", "reads_not_modified", "reads_shed", "reads_error",
        "rejected_frames", "eof_mid_request", "coalesce_hits",
        "delta_bytes_saved", "bytes_sent", "pump_calls", "pump_ns")]


assert ctypes.sizeof(_ReadStats) == 128


class _ReadFreshStats(ctypes.Structure):
    """Mirror of native/tcpps.cpp ReadFreshStats (32 bytes, packed)."""

    _pack_ = 1
    _fields_ = [
        ("latest_version", ctypes.c_uint64),
        ("last_publish_wall", ctypes.c_double),
        ("fresh_replies", ctypes.c_uint64),
        ("min_have_version", ctypes.c_uint64),
    ]


assert ctypes.sizeof(_ReadFreshStats) == 32


def get_read_lib() -> Optional[ctypes.CDLL]:
    """The ``tps_read_*`` entry points of ``native/tcpps.cpp``, built and
    bound once; None when the library does not build (the core's
    ``read_native="auto"`` then takes the Python loop,
    ``serving/core.py:186-212``). An ABI drift raises."""
    global _read_lib, _read_lib_failed
    if _read_lib is not None:
        return _read_lib
    if _read_lib_failed:
        return None
    try:
        lib = native.tcpps_lib()
    except (RuntimeError, OSError):
        _read_lib_failed = True
        return None
    vp, u8p, u64 = ctypes.c_void_p, native._u8p, ctypes.c_uint64
    native._bind(lib, {
        "tps_read_create": (vp, [ctypes.c_char_p, ctypes.c_uint16, u64,
                                 ctypes.c_double, ctypes.c_char_p]),
        "tps_read_port": (ctypes.c_uint16, [vp]),
        "tps_read_publish": (None, [vp, ctypes.c_char_p, u64, u8p, u64,
                                    u64]),
        "tps_read_add_delta": (None, [vp, ctypes.c_char_p, u64, u8p, u64,
                                      u64]),
        "tps_read_pump": (ctypes.c_int, [vp, ctypes.c_int]),
        "tps_read_released": (ctypes.c_int, [vp, native._u64p,
                                             ctypes.c_int]),
        "tps_read_stats": (None, [vp, ctypes.POINTER(_ReadStats)]),
        "tps_read_set_fresh": (None, [vp, ctypes.c_char_p, u8p, u64,
                                      ctypes.c_double]),
        "tps_read_fresh_stats": (ctypes.c_int, [
            vp, ctypes.c_char_p, ctypes.POINTER(_ReadFreshStats)]),
        "tps_read_set_admission": (None, [vp, u64, ctypes.c_double]),
        "tps_read_wake": (None, [vp]),
        "tps_read_close": (None, [vp]),
        "tps_abi_psr_magic": (ctypes.c_uint32, []),
        "tps_abi_psr_req_bytes": (ctypes.c_uint32, []),
        "tps_abi_psr_rep_bytes": (ctypes.c_uint32, []),
        "tps_abi_read_stats_bytes": (ctypes.c_uint32, []),
        "tps_abi_read_fresh_stats_bytes": (ctypes.c_uint32, []),
    })
    _verify_read_abi(lib)
    _read_lib = lib
    return _read_lib


def _verify_read_abi(lib: ctypes.CDLL) -> None:
    """Refuse a library whose PSR1 sizes or magic differ from this
    package's ``serving/net.py`` (``native_read.py:143-171``)."""
    from pytorch_ps_mpi_tpu_torch.serving import net as _net

    checks = (
        ("PSR1 magic", int(lib.tps_abi_psr_magic()), _net.MAGIC),
        ("PSR1 request bytes", int(lib.tps_abi_psr_req_bytes()),
         _net._REQ.size),
        ("PSR1 reply bytes", int(lib.tps_abi_psr_rep_bytes()),
         _net._REP.size),
        ("ReadStats bytes", int(lib.tps_abi_read_stats_bytes()),
         ctypes.sizeof(_ReadStats)),
        ("ReadFreshStats bytes", int(lib.tps_abi_read_fresh_stats_bytes()),
         ctypes.sizeof(_ReadFreshStats)),
    )
    for what, native_v, py_v in checks:
        if native_v != py_v:
            raise RuntimeError(
                f"native/tcpps.cpp read-tier ABI drift: {what} is "
                f"{native_v} in the loaded library but {py_v} in "
                "serving/net.py")


class NativeReadServer:
    """The C++ read tier behind a :class:`~.core.ServingCore`.

    The pump runs on a daemon thread that blocks in ``tps_read_pump``
    (the GIL released) and drains release tokens. Raises
    ``RuntimeError`` when the listener cannot be created (the core then
    takes the Python loop).
    """

    native = True

    def __init__(self, core, port: int = 0, host: str = "0.0.0.0"):
        lib = get_read_lib()
        if lib is None:
            raise RuntimeError("native read tier unavailable")
        self.core = core
        self._lib = lib
        self._handle = lib.tps_read_create(
            host.encode(), int(port), int(core.admission_depth),
            float(core.retry_after_s), core.default_tenant.encode())
        if not self._handle:
            raise RuntimeError(
                f"tps_read_create failed (host {host!r} port {port})")
        self.port = int(lib.tps_read_port(self._handle))
        # token -> release hook, shared by the publish thread (insert) and
        # the pump thread (pop)
        self._pins: Dict[int, Callable[[], None]] = {}
        self._pins_lock = threading.Lock()
        self._next_token = 1
        self._final_stats: Dict[str, int] = {}
        self._tenants: set = {core.default_tenant}
        self._final_fresh: Dict[str, Dict[str, float]] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._pump_loop, daemon=True,
            name=f"read-native:{self.port}")
        self._thread.start()

    # -- pump thread ------------------------------------------------------
    def _pump_loop(self) -> None:
        toks = (ctypes.c_uint64 * 64)()
        while not self._stop.is_set():
            self._lib.tps_read_pump(self._handle, 50)
            while True:
                n = self._lib.tps_read_released(self._handle, toks, 64)
                if n <= 0:
                    break
                for i in range(n):
                    self._release(int(toks[i]))

    def _release(self, token: int) -> None:
        with self._pins_lock:
            hook = self._pins.pop(token, None)
        if hook is not None:
            hook()

    def _token(self, hook: Callable[[], None]) -> int:
        with self._pins_lock:
            tok = self._next_token
            self._next_token += 1
            self._pins[tok] = hook
        return tok

    # -- publish boundary -------------------------------------------------
    def on_publish(self, tenant: str, version: int, store,
                   fresh: bytes = b"", publish_wall: float = 0.0) -> None:
        """Pin the new latest, install it and its FRS1 trailer, then
        encode ``base -> latest`` for every older version in the ring and
        install each delta that beats a full read (``native_read.py:
        237-280``). Called on the publishing thread right after
        ``store.put``."""
        self._tenants.add(tenant)
        latest = store.acquire(int(version))
        if latest is None:
            return  # evicted already (ring 1 races): nothing to serve
        flat_u8 = latest.flat.view(np.uint8)
        tok = self._token(lambda s=latest, st=store: st.release(s))
        self._lib.tps_read_publish(
            self._handle, tenant.encode(), int(version),
            native.u8(flat_u8), flat_u8.nbytes, tok)
        self.set_fresh(tenant, fresh, publish_wall)
        try:
            codec = self.core._delta(tenant)
        except ValueError:
            return  # no template recorded: full reads only
        for base_version in store.versions():
            if base_version >= int(version):
                continue
            base = store.acquire(base_version)
            if base is None:
                continue
            try:
                payload = codec.encode(base.flat, latest.flat)
            except Exception:
                payload = None  # size drift etc: full fallback
            finally:
                store.release(base)
            if payload is None:
                continue  # delta not worth it: native serves full
            dtok = self._token(lambda p=payload: None)  # keeps it alive
            self._lib.tps_read_add_delta(
                self._handle, tenant.encode(), int(base_version),
                native.u8(payload), payload.nbytes, dtok)

    # -- ReadTierServer surface -------------------------------------------
    def stats(self) -> Dict[str, int]:
        """The C++ counter block; after :meth:`close` the block captured
        at teardown."""
        if self._handle is None:
            return dict(self._final_stats)
        st = _ReadStats()
        self._lib.tps_read_stats(self._handle, ctypes.byref(st))
        return {name: int(getattr(st, name)) for name, _ in st._fields_}

    def set_fresh(self, tenant: str, fresh: bytes,
                  publish_wall: float = 0.0) -> None:
        """Install (or clear, ``b""``) the FRS1 trailer the C++ tier
        attaches to want_fresh full and delta replies for ``tenant``."""
        if self._handle is None:
            return
        buf = (ctypes.c_uint8 * max(len(fresh), 1)).from_buffer_copy(
            fresh or b"\x00")
        self._lib.tps_read_set_fresh(
            self._handle, tenant.encode(),
            ctypes.cast(buf, native._u8p), len(fresh), float(publish_wall))

    def fresh_stats_all(self) -> Dict[str, Dict[str, float]]:
        """Per-tenant ``latest_version``, ``last_publish_wall``,
        ``fresh_replies`` and ``min_have_version``; after :meth:`close`
        the capture taken at teardown."""
        if self._handle is None:
            return {t: dict(v) for t, v in self._final_fresh.items()}
        out: Dict[str, Dict[str, float]] = {}
        fs = _ReadFreshStats()
        for tenant in sorted(self._tenants):
            if not self._lib.tps_read_fresh_stats(
                    self._handle, tenant.encode(), ctypes.byref(fs)):
                continue
            out[tenant] = {
                "latest_version": int(fs.latest_version),
                "last_publish_wall": float(fs.last_publish_wall),
                "fresh_replies": int(fs.fresh_replies),
                "min_have_version": int(fs.min_have_version),
            }
        return out

    def queue_depth(self) -> int:
        return self.stats()["pending"]

    def connections(self) -> int:
        return self.stats()["conns"]

    def set_admission(self, depth: int, retry_after_s: float) -> None:
        """Live admission change (``native_read.py:333``): the C++ loop
        reads the bound at every enqueue, under its own mutex."""
        self._lib.tps_read_set_admission(self._handle, int(depth),
                                         float(retry_after_s))

    def close(self) -> None:
        if self._stop.is_set():
            return
        self._stop.set()
        self._lib.tps_read_wake(self._handle)
        self._thread.join(timeout=5)
        self._final_stats = self.stats()
        self._final_fresh = self.fresh_stats_all()
        self._lib.tps_read_close(self._handle)
        self._handle = None
        # the C++ side is gone, so no view can still be in flight: drop
        # every pin the released queue never surfaced
        with self._pins_lock:
            hooks = list(self._pins.values())
            self._pins.clear()
        for hook in hooks:
            hook()

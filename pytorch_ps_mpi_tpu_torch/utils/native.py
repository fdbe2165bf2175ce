"""The port's ctypes layer over the repo's host C++ (``native/``).

The counterpart of ``pytorch_ps_mpi_tpu/utils/native.py`` together with
the library loaders of ``parallel/dcn.py`` and ``parallel/tcp.py``. The
three sources carry no framework and are shared with the JAX package,
unchanged:

- ``wirecodec.cpp``: the shuffle + zero-run-length checkpoint codec
  (:func:`compress`/:func:`decompress`) and the ``wc_fold_*`` folds of
  the streaming aggregators (``codecs/base.py``);
- ``psqueue.cpp``: the shared-memory transport (a seqlock parameter
  board and one gradient mailbox a worker; :func:`psqueue_lib`);
- ``tcpps.cpp``: the TCP transport with its batched, in-C++ validated
  frame ingest (:func:`tcpps_lib`).

Each is built with g++ (``-O3 -std=c++17 -ffp-contract=off``; the folds
must not contract a multiply and an add into an FMA, or native and numpy
would differ) into the git-ignored ``pytorch_ps_mpi_tpu_torch/_build/``,
again whenever the source's hash changes, through a temporary file and
an ``os.replace``, so processes that build at once never load a partial
library. A failed build raises, naming the compiler's error: nothing
falls back silently. ``PS_NO_NATIVE=1`` selects the numpy folds and the
per-frame Python ingest instead of the native fast paths, as in the JAX
package; it does not replace the transports themselves.

``compress`` wire format (little-endian): magic ``b'WC02'`` | u8
elem_size | u8 flags (1 = shuffled) | u64 raw_len | u32 crc32(raw) |
payload (rle0, or raw bytes when elem_size == 0).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import sys
import tempfile
import zlib
from pathlib import Path
from typing import Dict, Optional

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
NATIVE_DIR = _REPO / "native"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O3", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC")

_MAGIC = b"WC02"
_HDR = struct.Struct("<4sBBQI")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _stale(src: Path, lib: Path, stamp: Path) -> Optional[str]:
    digest = hashlib.sha256(src.read_bytes()).hexdigest()
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return None
    return digest


def build(*names: str) -> None:
    """Compile each ``native/<name>.cpp`` whose library is missing or
    stale, one g++ each, all started together. Raises ``RuntimeError``
    with the compiler's output when one fails."""
    running = []
    for name in names:
        src = NATIVE_DIR / f"{name}.cpp"
        lib = BUILD_DIR / f"lib{name}.so"
        stamp = BUILD_DIR / f"lib{name}.sha256"
        digest = _stale(src, lib, stamp)
        if digest is None:
            continue
        BUILD_DIR.mkdir(exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        # -lrt after the source: shm_open lives in librt before glibc 2.34
        libs = ["-lrt"] if sys.platform.startswith("linux") else []
        proc = subprocess.Popen(["g++", *GXX_FLAGS, "-o", tmp, str(src),
                                 *libs], stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        running.append((name, proc, tmp, lib, stamp, digest))
    failed = []
    for name, proc, tmp, lib, stamp, digest in running:
        _, err = proc.communicate(timeout=300)
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"g++ failed on native/{name}.cpp:\n{err}")
            continue
        os.replace(tmp, lib)
        fd, tmp_stamp = tempfile.mkstemp(dir=BUILD_DIR)
        with os.fdopen(fd, "w") as f:
            f.write(digest)
        os.replace(tmp_stamp, stamp)
    if failed:
        raise RuntimeError("\n".join(failed))


def _load(name: str) -> ctypes.CDLL:
    if name not in _LIBS:
        build(name)
        _LIBS[name] = ctypes.CDLL(str(BUILD_DIR / f"lib{name}.so"))
    return _LIBS[name]


_u8p = ctypes.POINTER(ctypes.c_uint8)
_f32p = ctypes.POINTER(ctypes.c_float)
_i8p = ctypes.POINTER(ctypes.c_int8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_u16p = ctypes.POINTER(ctypes.c_uint16)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_u64p = ctypes.POINTER(ctypes.c_uint64)
_size = ctypes.c_size_t


def _bind(lib: ctypes.CDLL, table: dict) -> ctypes.CDLL:
    for fn, (restype, argtypes) in table.items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib


def wirecodec_lib() -> ctypes.CDLL:
    """``native/wirecodec.cpp``, built and bound on the first call."""
    if "wirecodec" in _LIBS:
        return _LIBS["wirecodec"]
    return _bind(_load("wirecodec"), {
        "wc_shuffle": (None, [_u8p, _u8p, _size, _size]),
        "wc_unshuffle": (None, [_u8p, _u8p, _size, _size]),
        "wc_rle0_max_out": (_size, [_size]),
        "wc_rle0_encode": (_size, [_u8p, _size, _u8p, _size]),
        "wc_rle0_decode": (_size, [_u8p, _size, _u8p, _size]),
        "wc_fold_scaled_i8": (None, [_f32p, _i8p, ctypes.c_float, _size]),
        "wc_fold_tern": (None, [_f32p, _u8p, ctypes.c_float, _size]),
        "wc_fold_sign": (None, [_i32p, _u8p, _size]),
        "wc_fold_sparse": (None, [_f32p, _f32p, _i32p, _size, _size]),
        "wc_zero_sparse": (None, [_f32p, _i32p, _size, _size]),
        "wc_fold_sparse_q8": (None, [_f32p, _i8p, _f32p, _i32p, _size,
                                     _size, _size]),
        "wc_fold_dense_f32": (None, [_f32p, _f32p, _size]),
        "wc_fold_dense_bf16": (None, [_f32p, _u16p, _size]),
        "wc_profile_stats": (None, [_u64p, _u64p, _u64p]),
        "wc_abi_fold_span_bytes": (ctypes.c_uint32, []),
        "wc_fold_spans_arm": (ctypes.c_int, [ctypes.c_uint32]),
        "wc_fold_spans_drain": (ctypes.c_uint32, [
            ctypes.POINTER(FoldSpan), ctypes.c_uint32, _u64p]),
    })


class FoldSpan(ctypes.Structure):
    """Mirror of ``native/wirecodec.cpp``'s ``FoldSpan`` (24 bytes,
    packed): one ``(start_ns, end_ns, elems)`` interval a ``wc_fold_*``
    call, captured by the armed span ring for the hop anatomy."""

    _pack_ = 1
    _fields_ = [
        ("start_ns", ctypes.c_uint64),
        ("end_ns", ctypes.c_uint64),
        ("elems", ctypes.c_uint64),
    ]


assert ctypes.sizeof(FoldSpan) == 24


def fold_profile_stats() -> Optional[dict]:
    """The ``wc_fold_*`` cycle counters (calls, elements, wall ns), the
    native half of the sampling profiler (``utils/native.py:210``). Reads
    an already loaded library only: a process that folded nothing
    reports None, not zeros."""
    lib = _LIBS.get("wirecodec")
    if lib is None:
        return None
    calls, elems, ns = ctypes.c_uint64(), ctypes.c_uint64(), ctypes.c_uint64()
    lib.wc_profile_stats(ctypes.byref(calls), ctypes.byref(elems),
                         ctypes.byref(ns))
    return {"fold_calls": int(calls.value), "fold_elems": int(elems.value),
            "fold_ns": int(ns.value)}


def fold_spans_arm(capacity: int) -> bool:
    """Arm (``capacity > 0``) or disarm (0) the native fold-span ring the
    hop anatomy drains (``utils/native.py:231``); True when it is live.
    ``PS_NO_NATIVE`` keeps the Python timing. Call from the fold-running
    thread only."""
    if fast_path_disabled():
        return False
    lib = wirecodec_lib()
    if int(lib.wc_abi_fold_span_bytes()) != ctypes.sizeof(FoldSpan):
        raise RuntimeError("native/wirecodec.cpp FoldSpan ABI drift")
    return int(lib.wc_fold_spans_arm(int(capacity))) == 0


def fold_spans_drain(max_spans: int = 4096) -> Optional[tuple]:
    """``([(start_ns, end_ns, elems), ...], dropped)`` from the armed span
    ring, oldest first (the drop counter resets a drain), or None when
    the library is not loaded."""
    lib = _LIBS.get("wirecodec")
    if lib is None:
        return None
    buf = (FoldSpan * int(max_spans))()
    dropped = ctypes.c_uint64()
    n = int(lib.wc_fold_spans_drain(buf, int(max_spans),
                                    ctypes.byref(dropped)))
    return ([(int(buf[i].start_ns), int(buf[i].end_ns), int(buf[i].elems))
             for i in range(n)], int(dropped.value))


def psqueue_lib() -> ctypes.CDLL:
    """``native/psqueue.cpp`` (``parallel/dcn.py:33``)."""
    if "psqueue" in _LIBS:
        return _LIBS["psqueue"]
    vp = ctypes.c_void_p
    return _bind(_load("psqueue"), {
        "psq_create": (vp, [ctypes.c_char_p, ctypes.c_uint32,
                            ctypes.c_uint64, ctypes.c_uint64]),
        "psq_open": (vp, [ctypes.c_char_p]),
        "psq_close": (None, [vp]),
        "psq_n_workers": (ctypes.c_uint32, [vp]),
        "psq_publish_params": (ctypes.c_int, [vp, _u8p, ctypes.c_uint64,
                                              ctypes.c_uint64]),
        "psq_read_params": (ctypes.c_int64, [vp, _u8p, ctypes.c_uint64,
                                             _u64p]),
        "psq_push_grad": (ctypes.c_int, [vp, ctypes.c_uint32, _u8p,
                                         ctypes.c_uint64, ctypes.c_uint64]),
        "psq_pop_grad": (ctypes.c_int64, [vp, _u8p, ctypes.c_uint64, _u32p,
                                          _u64p, _u32p]),
        "psq_grad_pending": (ctypes.c_int, [vp, ctypes.c_uint32]),
        "psq_reset_slot": (ctypes.c_int, [vp, ctypes.c_uint32]),
        "psq_params_version": (ctypes.c_uint64, [vp]),
    })


class BatchMeta(ctypes.Structure):
    """Mirror of ``native/tcpps.cpp``'s ``BatchMeta`` (48 bytes, packed)."""

    _pack_ = 1
    _fields_ = [
        ("worker", ctypes.c_uint32),
        ("status", ctypes.c_uint32),
        ("version", ctypes.c_uint64),
        ("off", ctypes.c_uint64),
        ("len", ctypes.c_uint64),
        ("step", ctypes.c_uint32),
        ("seq", ctypes.c_uint32),
        ("send_wall", ctypes.c_double),
    ]


assert ctypes.sizeof(BatchMeta) == 48


class HopStamp(ctypes.Structure):
    """Mirror of ``native/tcpps.cpp``'s ``HopStamp`` (32 bytes, packed):
    one validate/ingest stamp a frame of the batched pop, drained by the
    hop anatomy (``parallel/tcp.py:76``)."""

    _pack_ = 1
    _fields_ = [
        ("t_ns", ctypes.c_uint64),
        ("validate_ns", ctypes.c_uint64),
        ("bytes", ctypes.c_uint64),
        ("worker", ctypes.c_uint32),
        ("status", ctypes.c_uint32),
    ]


assert ctypes.sizeof(HopStamp) == 32


def tcpps_lib() -> ctypes.CDLL:
    """``native/tcpps.cpp`` (``parallel/tcp.py:96``), its PSF2 constants
    checked against ``resilience/frames.py`` at load."""
    if "tcpps" in _LIBS:
        return _LIBS["tcpps"]
    vp = ctypes.c_void_p
    lib = _bind(_load("tcpps"), {
        "tps_server_create": (vp, [ctypes.c_uint16, ctypes.c_uint32,
                                   ctypes.c_uint64]),
        "tps_server_port": (ctypes.c_uint16, [vp]),
        "tps_server_publish": (ctypes.c_int, [vp, _u8p, ctypes.c_uint64,
                                              ctypes.c_uint64]),
        "tps_server_pump": (ctypes.c_int, [vp]),
        "tps_server_pop_grad": (ctypes.c_int64, [vp, _u8p, ctypes.c_uint64,
                                                 _u32p, _u64p]),
        "tps_server_pending": (ctypes.c_int, [vp, ctypes.c_uint32]),
        "tps_server_connected": (ctypes.c_int, [vp, ctypes.c_uint32]),
        "tps_server_read_stats": (None, [vp, _u64p, _u64p]),
        "tps_server_close": (None, [vp]),
        "tps_server_set_frame_check": (None, [vp, ctypes.c_uint64,
                                              ctypes.c_uint64]),
        "tps_server_pop_grad_batch": (ctypes.c_int, [
            vp, _u8p, ctypes.c_uint64, ctypes.POINTER(BatchMeta),
            ctypes.c_int]),
        "tps_worker_connect": (vp, [ctypes.c_char_p, ctypes.c_uint16,
                                    ctypes.c_uint32, ctypes.c_int]),
        "tps_worker_read_params": (ctypes.c_int64, [
            vp, _u8p, ctypes.c_uint64, _u64p, ctypes.c_int,
            ctypes.c_uint64]),
        "tps_worker_push_grad": (ctypes.c_int, [vp, _u8p, ctypes.c_uint64,
                                                ctypes.c_uint64,
                                                ctypes.c_int]),
        "tps_worker_close": (None, [vp]),
        "tps_abi_psf_magic": (ctypes.c_uint32, []),
        "tps_abi_psf_magic_v1": (ctypes.c_uint32, []),
        "tps_abi_psf_header_bytes": (ctypes.c_uint32, []),
        "tps_abi_batch_meta_bytes": (ctypes.c_uint32, []),
        "tps_abi_frame_status_name": (ctypes.c_char_p, [ctypes.c_uint32]),
        "tps_profile_stats": (None, [_u64p, _u64p, _u64p, _u64p]),
        "tps_abi_hop_stamp_bytes": (ctypes.c_uint32, []),
        "tps_hop_stamps_arm": (ctypes.c_int, [ctypes.c_uint32]),
        "tps_hop_stamps_drain": (ctypes.c_uint32, [
            ctypes.POINTER(HopStamp), ctypes.c_uint32, _u64p]),
    })
    verify_abi(lib)
    return lib


def verify_abi(lib: ctypes.CDLL) -> None:
    """Refuse a ``tcpps`` library whose PSF2 constants differ from
    ``resilience/frames.py`` (``parallel/tcp.py:176``): a drift is a
    loud load failure, never a silent mis-decode."""
    from pytorch_ps_mpi_tpu_torch.resilience import frames

    checks = (
        ("PSF2 header bytes", int(lib.tps_abi_psf_header_bytes()),
         frames.HEADER_BYTES),
        ("PSF2 magic", int(lib.tps_abi_psf_magic()), frames.FRAME_MAGIC),
        ("PSF1 magic", int(lib.tps_abi_psf_magic_v1()),
         frames.FRAME_MAGIC_V1),
        ("BatchMeta bytes", int(lib.tps_abi_batch_meta_bytes()),
         ctypes.sizeof(BatchMeta)),
    )
    for what, native_v, py_v in checks:
        if native_v != py_v:
            raise RuntimeError(
                f"native/tcpps.cpp ABI drift: {what} is {native_v} in the "
                f"loaded library but {py_v} on the Python side")
    for code, want in frames.BATCH_REASONS.items():
        got = lib.tps_abi_frame_status_name(code)
        got = got.decode() if got is not None else None
        if got != want:
            raise RuntimeError(
                f"native/tcpps.cpp ABI drift: frame-status code {code} is "
                f"{got!r} in the loaded library but {want!r} in "
                "frames.BATCH_REASONS")


# -- pointers ------------------------------------------------------------------

def u8(arr: np.ndarray):
    return arr.ctypes.data_as(_u8p)


def f32(arr: np.ndarray):
    return arr.ctypes.data_as(_f32p)


def _i8(arr: np.ndarray):
    return arr.ctypes.data_as(_i8p)


def _i32(arr: np.ndarray):
    return arr.ctypes.data_as(_i32p)


# -- the folds -------------------------------------------------------------------

def fast_path_disabled() -> bool:
    """True when ``PS_NO_NATIVE`` asks for the numpy folds and the
    per-frame ingest (any value but empty, ``0`` or ``false``). Read per
    call, so a test can flip it."""
    return os.environ.get("PS_NO_NATIVE", "0").strip().lower() not in (
        "", "0", "false")


def fold_lib() -> Optional[ctypes.CDLL]:
    """The wirecodec library for the ``wc_fold_*`` folds, or None when
    ``PS_NO_NATIVE`` selects the numpy folds."""
    return None if fast_path_disabled() else wirecodec_lib()


def fold_scaled_i8(lib, acc: np.ndarray, q: np.ndarray, scale) -> None:
    """acc += scale * q (int8 payload, f32 accumulator) in one pass."""
    lib.wc_fold_scaled_i8(f32(acc), _i8(q), ctypes.c_float(float(scale)),
                          acc.size)


def fold_tern(lib, acc: np.ndarray, packed: np.ndarray, scale) -> None:
    """acc += scale * (base-4 digit - 1) over the flat TernGrad layout."""
    lib.wc_fold_tern(f32(acc), u8(packed), ctypes.c_float(float(scale)),
                     acc.size)


def fold_sign(lib, votes: np.ndarray, packed: np.ndarray) -> None:
    """votes += the unpacked bits (little bit order), int32 counters."""
    lib.wc_fold_sign(_i32(votes), u8(packed), votes.size)


def fold_sparse(lib, acc: np.ndarray, values: np.ndarray,
                indices: np.ndarray, acc_ptr=None) -> None:
    """acc[idx] += val in payload order; out-of-range indices dropped."""
    lib.wc_fold_sparse(acc_ptr if acc_ptr is not None else f32(acc),
                       f32(values), _i32(indices), values.size, acc.size)


def zero_sparse(lib, acc: np.ndarray, indices: np.ndarray,
                acc_ptr=None) -> None:
    """acc[idx] = 0 for in-range idx: a pooled buffer's recycle pass."""
    lib.wc_zero_sparse(acc_ptr if acc_ptr is not None else f32(acc),
                       _i32(indices), indices.size, acc.size)


def fold_sparse_q8(lib, acc: np.ndarray, q: np.ndarray, scales: np.ndarray,
                   indices: np.ndarray, acc_ptr=None) -> None:
    """The per-block int8 × scale dequantize and the scatter-add, one pass."""
    nb = scales.size
    kb = q.size // max(nb, 1)
    lib.wc_fold_sparse_q8(acc_ptr if acc_ptr is not None else f32(acc),
                          _i8(q), f32(scales), _i32(indices), nb, kb,
                          acc.size)


def fold_dense_f32(lib, acc: np.ndarray, x: np.ndarray) -> None:
    lib.wc_fold_dense_f32(f32(acc), f32(x), acc.size)


def fold_dense_bf16(lib, acc: np.ndarray, x: np.ndarray) -> None:
    """acc += f32(x) for x the bf16 bit patterns as uint16."""
    lib.wc_fold_dense_bf16(f32(acc), x.ctypes.data_as(_u16p), acc.size)


# -- compress / decompress (checkpoints) -----------------------------------------

def _shuffle(data: np.ndarray, elem_size: int, inverse: bool) -> np.ndarray:
    lib = wirecodec_lib()
    out = np.empty_like(data)
    fn = lib.wc_unshuffle if inverse else lib.wc_shuffle
    fn(u8(data), u8(out), data.size // elem_size, elem_size)
    return out


def _rle0_encode(data: np.ndarray) -> bytes:
    lib = wirecodec_lib()
    cap = lib.wc_rle0_max_out(data.size)
    out = np.empty(cap, np.uint8)
    size = lib.wc_rle0_encode(u8(data), data.size, u8(out), cap)
    if size == 0 and data.size > 0:
        raise RuntimeError("rle0 encode capacity overflow")
    return out[:size].tobytes()


def compress(data: bytes, elem_size: int = 4) -> bytes:
    """Byte shuffle by ``elem_size`` + zero-run-length coding with a CRC32
    of the raw bytes (the JAX package's ``native.compress``, the same
    bytes). Stores the raw bytes when coding would not shrink them."""
    raw = np.frombuffer(data, np.uint8)
    crc = zlib.crc32(data) & 0xFFFFFFFF
    if elem_size > 1 and raw.size % elem_size == 0:
        payload = _rle0_encode(_shuffle(raw, elem_size, inverse=False))
        flags = 1
    else:
        payload = _rle0_encode(np.ascontiguousarray(raw))
        flags = 0
        elem_size = 1
    if len(payload) >= raw.size:
        return _HDR.pack(_MAGIC, 0, 0, raw.size, crc) + bytes(data)
    return _HDR.pack(_MAGIC, elem_size, flags, raw.size, crc) + payload


def decompress(blob: bytes) -> bytes:
    """Inverse of :func:`compress`; raises ``ValueError`` on a foreign or
    corrupt blob."""
    magic, elem_size, flags, raw_len, crc = _HDR.unpack_from(blob, 0)
    if magic != _MAGIC:
        raise ValueError("not a wirecodec blob")
    payload = bytes(blob[_HDR.size:])
    if elem_size == 0:
        out_bytes = payload[:raw_len]
    else:
        lib = wirecodec_lib()
        src = np.frombuffer(payload, np.uint8)
        out = np.empty(raw_len, np.uint8)
        if lib.wc_rle0_decode(u8(src), src.size, u8(out), raw_len) != raw_len:
            raise ValueError("corrupt rle0 stream")
        if flags & 1:
            out = _shuffle(out, elem_size, inverse=True)
        out_bytes = out.tobytes()
    if (zlib.crc32(out_bytes) & 0xFFFFFFFF) != crc:
        raise ValueError("wirecodec blob failed CRC32 check (corrupt)")
    return out_bytes

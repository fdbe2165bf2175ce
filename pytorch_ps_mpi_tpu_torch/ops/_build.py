"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` (``sign``, ``quant``, ``topk``, ``tern``,
``attention``; :data:`SOURCES`) is compiled by
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface
(``_build/lib<name>.so``, listed in ``.gitignore``) and loaded with
``ctypes``. A library is built at its first use, from the package's own
sources, and again whenever the source's hash changes; ``build`` can
also compile several sources at once, one ``nvcc`` each. Nothing here
runs at import time: the CPU tests import every module on a machine with
no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

#: every kernel source of the package, by name
SOURCES = ("sign", "quant", "topk", "tern", "attention")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _paths(name: str):
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()
    return src, digest, BUILD_DIR / f"lib{name}.so", \
        BUILD_DIR / f"lib{name}.sha256"


def build(*names: str) -> Dict[str, float]:
    """Compile each ``csrc/<name>.cu`` whose library is missing or stale,
    one ``nvcc`` per source, all started together. Returns, per source,
    the seconds from the start until its build was collected (0.0 for a
    library that was up to date)."""
    t0 = time.perf_counter()
    seconds, running = {}, {}
    for name in names:
        src, digest, lib, stamp = _paths(name)
        if lib.exists() and stamp.exists() and stamp.read_text() == digest:
            seconds[name] = 0.0
            continue
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.so"
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        running[name] = (proc, tmp, lib, stamp, digest)
    failed = []
    for name, (proc, tmp, lib, stamp, digest) in running.items():
        _, err = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu:\n{err}")
            continue
        os.replace(tmp, lib)
        stamp.write_text(digest)
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def load(name: str, signatures: Optional[dict] = None) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built on first call).
    ``signatures`` maps each C function to ``(restype, argtypes)``."""
    if name not in _LIBS:
        build(name)
        cdll = ctypes.CDLL(str(BUILD_DIR / f"lib{name}.so"))
        for fn, (restype, argtypes) in (signatures or {}).items():
            getattr(cdll, fn).restype = restype
            getattr(cdll, fn).argtypes = argtypes
        _LIBS[name] = cdll
    return _LIBS[name]

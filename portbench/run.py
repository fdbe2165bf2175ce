#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (``pytorch_ps_mpi_tpu_torch``):
one run of one cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for. The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``; with ``--trace 1``
also ``breakdown``; ``compared`` last: each number held to a limit,
beside it). The last lines of standard error give the same numbers.
``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics. The run exits non-zero and prints no result without
CUDA or the cards the cell asks for, or where JAX or the JAX package was
loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: fixed cache directories inside the checkout
CACHE = ROOT / ".portbench_cache"
FORBIDDEN = {"jax", "jaxlib", "flax", "pytorch_ps_mpi_tpu"}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``pytorch_ps_mpi_tpu_torch`` is not one)."""
    return sorted({n.split(".")[0] for n in sys.modules} & FORBIDDEN)


def card() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi gave nothing"


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    # the checkout's root in place of this script's folder, whose
    # subfolders (codecs/, metrics/, ...) would shadow modules by name
    sys.path[0] = str(ROOT)
    import torch

    from portbench.harness import measure, spec

    cell = spec.load(args.workload)
    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result = measure.run(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda", T0, card())
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded {found}: the port may not load JAX or "
              f"the JAX package", file=sys.stderr)
        return 3
    for line in result.pop("notes"):
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

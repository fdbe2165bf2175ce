#!/usr/bin/env python3
"""The readings a cell's limits are set from, in one process:

- ``--seeds``: the program's first steps against the reference (what a
  run of ``run.py`` compares, by the same code), one line a seed;
- ``--control-seeds``: the control, the reference put in the program's
  place with its products' operands rounded to the configuration's
  ``control_precision``, against the float32 reference;
- ``--fault-seeds``: the program with half of every batch left out (the
  loss the mean over the rest), against the reference.

    python3 portbench/readings.py --workload <name> --seeds 1,2 \\
        --control-seeds 3,4,5 --fault-seeds 6,7,8 [--out FILE]

Each reading is one JSON line (``kind``, ``seed``, the three numbers and
where each is largest), printed and, with ``--out``, appended to FILE.
Needs the card, as ``run.py`` does.
"""

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s.strip()]


def program_reading(cell, seed: int, device, fault: bool = False) -> dict:
    import torch

    from portbench.harness import judge
    from portbench.harness.program import Program

    prog = Program(cell, seed, device)
    if fault:
        prog.feed = cell.family.half
    mine = prog.first_steps(seed, judge.FIRST_STEPS)
    order = list(prog.shapes)
    prog.close()
    del prog
    gc.collect()
    torch.cuda.empty_cache()
    return judge.gaps(mine, judge.reference(cell, seed, device, order))


def control_reading(cell, seed: int, device) -> dict:
    from portbench.harness import judge
    from portbench.harness.program import weights

    order = list(weights(cell, seed, device))  # the optimizer's leaf order
    low = judge.reference(cell, seed, device, order,
                          cell.cfg["control_precision"])
    return judge.gaps(low, judge.reference(cell, seed, device, order))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="readings of the program, "
                                 "its control and a planted fault")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, default=[])
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--fault-seeds", type=_seeds, default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    # the checkout's root in place of this script's folder, whose
    # subfolders (codecs/, metrics/, ...) would shadow modules by name
    sys.path[0] = str(ROOT)
    import torch

    from portbench.harness import measure, spec

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load(args.workload)
    device = torch.device("cuda")
    measure.build_kernels(device)
    jobs = ([("program", s) for s in args.seeds]
            + [("control", s) for s in args.control_seeds]
            + [("half_batch", s) for s in args.fault_seeds])
    for kind, seed in jobs:
        if kind == "control":
            found = control_reading(cell, seed, device)
        else:
            found = program_reading(cell, seed, device, kind == "half_batch")
        line = json.dumps({"workload": cell.name, "kind": kind, "seed": seed,
                           **{k: v["value"] for k, v in found.items()},
                           "at": {k: v["at"] for k, v in found.items()}})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

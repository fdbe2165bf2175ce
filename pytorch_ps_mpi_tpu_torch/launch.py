"""Multi-process launcher: ``python -m pytorch_ps_mpi_tpu_torch.launch
[flags] script.py [script args]`` (``pytorch_ps_mpi_tpu/launch.py``).

The bootstrap the reference got from ``mpirun -n 2`` (reference
``Makefile:2-3``): every process runs the same script, and this module
joins the default ``torch.distributed`` process group from flags or
environment variables before it runs the script as ``__main__``, so the
topology is explicit. The group is NCCL on the card, each process on
card ``process_id % device_count``; ``--platform cpu`` makes it gloo and
sets ``PS_PLATFORM=cpu``, which ``train.py`` reads to run on the CPU.
Without ``--coordinator`` the script runs as one process.

  python -m pytorch_ps_mpi_tpu_torch.launch \\
      --coordinator host0:1234 --num-processes 2 --process-id 0 train.py
"""

from __future__ import annotations

import argparse
import os
import runpy
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--coordinator", default=os.environ.get("PS_COORDINATOR"),
                    help="host:port of process 0 (PS_COORDINATOR)")
    ap.add_argument("--num-processes", type=int,
                    default=int(os.environ.get("PS_NUM_PROCESSES", "0"))
                    or None, help="world size (PS_NUM_PROCESSES)")
    ap.add_argument("--process-id", type=int,
                    default=int(os.environ.get("PS_PROCESS_ID", "-1")),
                    help="this process's rank (PS_PROCESS_ID)")
    ap.add_argument("--platform", default=os.environ.get("PS_PLATFORM"),
                    choices=["cpu", "cuda"],
                    help="'cpu': gloo on the CPU; default NCCL on the card "
                         "(PS_PLATFORM)")
    ap.add_argument("script", help="training script (runs as __main__)")
    ap.add_argument("script_args", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)

    given = (args.num_processes is not None, args.process_id >= 0)
    if args.coordinator is None and any(given):
        ap.error("--num-processes/--process-id given without --coordinator "
                 "(or PS_COORDINATOR): the job would silently run "
                 "single-process")
    if args.coordinator is not None and not all(given):
        ap.error("--coordinator needs --num-processes and --process-id (or "
                 "PS_NUM_PROCESSES and PS_PROCESS_ID): nothing here "
                 "discovers a cluster")

    import torch
    import torch.distributed as dist

    from pytorch_ps_mpi_tpu_torch.mesh import initialize_distributed

    cpu = args.platform == "cpu"
    if cpu:
        os.environ["PS_PLATFORM"] = "cpu"
    if args.coordinator is not None:
        if not cpu:
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device for the NCCL group; pass "
                                   "--platform cpu to run on the CPU")
            torch.cuda.set_device(args.process_id
                                  % torch.cuda.device_count())
        initialize_distributed(f"tcp://{args.coordinator}",
                               world_size=args.num_processes,
                               rank=args.process_id,
                               backend="gloo" if cpu else "nccl")
    sys.argv = [args.script] + args.script_args
    # as `python script.py` does: the script's directory is importable
    sys.path.insert(0, os.path.dirname(os.path.abspath(args.script)))
    try:
        runpy.run_path(args.script, run_name="__main__")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()

"""Same-card A/B of ``chip_smoke.py``'s main paths between two checkouts
of the repository.

    python3 chip_main_path_ab.py PARENT_DIR CHANGE_DIR [CODE ...]

CODE is ``sign``, ``int8``, ``qsgd`` or ``ef_topk`` (ResNets, through
each checkout's ``chip_smoke.run_main_path``) or ``bert_identity`` or
``bert_terngrad`` (BERT-base MLM b4 s512 bf16 with flash attention,
through its ``chip_smoke.run_bert_path``) or ``flash`` (BERT-base's 12
bf16 flash attention calls at [48, 512, 64], forward and backward, the
device ms of each kernel from 5 profiled rounds) or ``codec`` (one
ResNet-18 step's 62 ``quantize_int8`` and 20 ``encode_signs`` calls: the
device ms and device rows from 5 profiled rounds, and the calls' ms by
CUDA events, host launch cost included); default: ``int8``, ``qsgd``
and ``ef_topk``. Each path runs from each checkout in a process of its
own (5 loss steps, 1 grads-only step, the launch counts asserted, 1
profiled step), in turns: parent, change, change, parent, parent,
change. Each run prints its ``main_path``, ``profile``, ``flash_ab`` or
``codec_ab`` lines prefixed with ``ab=<parent|change> run=<i>``; the
card's name and power limit come first. Needs one CUDA device.
"""

from __future__ import annotations

import subprocess
import sys

SNIPPET = r"""
import sys
import torch
import chip_smoke as C
from pytorch_ps_mpi_tpu_torch import mesh
from pytorch_ps_mpi_tpu_torch.models import (BertConfig, BertMLM, ResNet18,
                                             ResNet50)
from pytorch_ps_mpi_tpu_torch.ops import topk as T

code = sys.argv[1]
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = True
torch.cuda.set_device(0)
C.build_kernels()
mesh.initialize_distributed(f"tcp://localhost:{C.free_port()}",
                            world_size=1, rank=0, backend="nccl")
try:
    if code == "flash":
        gen = torch.Generator(device="cuda").manual_seed(0)
        sets = [C._flash_inputs(torch.bfloat16, gen) for _ in range(12)]

        def step():
            for q, k, v, g, _ in sets:
                C._flash_both(q, k, v, g, None)

        for _ in range(5):
            events = C._profiled(step)
            print("phase=flash_ab calls=12 " + " ".join(
                f"{n}_device_ms={sum(e.self_device_time_total for e in events if f'flash_{n}_tc' in e.key) / 1e3:.4f}"
                for n in ("fwd", "bwd_dq", "bwd_dkv")), flush=True)
    elif code == "codec":
        from pytorch_ps_mpi_tpu_torch.ops import quant as Q
        from pytorch_ps_mpi_tpu_torch.ops import sign as S

        model = ResNet18(num_classes=10, small_inputs=True, seed=0,
                         device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(0)
        xs = [1e-2 * torch.randn(p.numel(), generator=gen, device="cuda")
              for p in model.parameters()]
        calls = {"quantize_int8": (Q.quantize_int8, xs),
                 "encode_signs": (S.encode_signs,
                                  [x for x in xs if x.numel() % 1024 == 0])}
        for _ in range(5):
            fields = []
            for name, (fn, args) in calls.items():
                def step(fn=fn, args=args):
                    for x in args:
                        fn(x)

                events = C._profiled(step)
                fields += [
                    f"{name}_calls={len(args)}",
                    f"{name}_device_ms={sum(e.self_device_time_total for e in events) / 1e3:.4f}",
                    f"{name}_rows={sum(e.count for e in events)}",
                    f"{name}_ms={C.cuda_ms(step, reps=5, rounds=3):.4f}"]
            print("phase=codec_ab " + " ".join(fields), flush=True)
    elif code.startswith("bert_"):
        # 12 flash forward and 12 + 12 backward launches a loss step;
        # TernGrad packs 61 leaves whole and 2 in 23 chunks, unpack-sums 63
        flash = {"flash_fwd": 12, "flash_bwd": 24}
        tern = {"tern_pack": 61 + 2 * 23, "tern_unpack": 63}
        model = BertMLM(BertConfig(dtype=torch.bfloat16, attention="flash"),
                        seed=0, device="cuda")
        if code == "bert_identity":
            C.run_bert_path(model, "identity", flash, {})
        else:
            C.run_bert_path(model, "terngrad", {**flash, **tern}, tern)
    elif code == "ef_topk":
        model = ResNet50(num_classes=1000, seed=0, device="cuda")
        # launches a leaf: 31 count passes before the radix select
        per_leaf = getattr(T, "LAUNCHES", T.PASSES)
        C.run_main_path(model, code, "imagenet", C.BATCH_IMAGENET,
                        {"exact_topk": per_leaf * 53},
                        "ResNet50-imagenet-gn-f32")
    else:
        model = ResNet18(num_classes=10, small_inputs=True, seed=0,
                         device="cuda")
        if code == "sign":
            per = {"encode_signs": 20, "unpack_signs": 20}
        else:
            per = {"dequantize_int8": 62}
        if code == "int8":
            per["quantize_int8"] = 62
        C.run_main_path(model, code, "cifar10", C.BATCH, per,
                        "ResNet18-cifar-gn-f32")
finally:
    torch.distributed.destroy_process_group()
"""


def main() -> int:
    if len(sys.argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    trees = {"parent": sys.argv[1], "change": sys.argv[2]}
    codes = sys.argv[3:] or ["int8", "qsgd", "ef_topk"]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    failed = 0
    for code in codes:
        for i, side in enumerate(["parent", "change", "change", "parent",
                                  "parent", "change"]):
            run = subprocess.run([sys.executable, "-c", SNIPPET, code],
                                 cwd=trees[side], capture_output=True,
                                 text=True)
            for line in run.stdout.splitlines():
                if line.startswith(("phase=main_path", "phase=flash_ab",
                                    "phase=codec_ab")):
                    print(f"ab={side} run={i} {line}", flush=True)
                elif line.startswith("phase=profile"):
                    print(f"ab={side} run={i} {line[:160]}", flush=True)
            if run.returncode:
                failed += 1
                print(f"ab={side} run={i} code={code} failed:\n"
                      f"{run.stderr[-2000:]}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

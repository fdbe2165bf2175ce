"""Same-card A/B of ``chip_smoke.py``'s main paths between two checkouts
of the repository.

    python3 chip_main_path_ab.py PARENT_DIR CHANGE_DIR [CODE ...]

CODE is ``identity``, ``sign``, ``int8``, ``qsgd`` or ``ef_topk``
(ResNets, through each checkout's ``chip_smoke.run_main_path``, the
collective calls a step asserted too) or ``bert_identity`` or
``bert_terngrad`` (BERT-base MLM b4 s512 bf16 with flash attention,
through its ``chip_smoke.run_bert_path``) or ``flash`` (BERT-base's 12
bf16 flash attention calls at [48, 512, 64], forward and backward, the
device ms of each kernel from 5 profiled rounds) or ``codec`` (one
ResNet-18 step's 62 ``quantize_int8`` and 20 ``encode_signs`` calls: the
device ms and device rows from 5 profiled rounds, and the calls' ms by
CUDA events, host launch cost included) or ``decode``
(``SignCodec.decode_sum`` over ResNet-18's 20 kernel-layout leaves at
world 1 and 8, the same figures and the unpack launches counted);
default: ``int8``, ``qsgd`` and ``ef_topk``; or ``smoke`` (the whole
``chip_smoke.py`` of each checkout, see below). Each path runs from each
checkout in a process of its own (5 loss steps, 1 grads-only step, the
launch counts asserted, 1 profiled step), in turns: parent, change,
change, parent, parent, change. Each run prints its ``main_path``,
``profile``, ``flash_ab``, ``codec_ab`` or ``decode_ab`` lines prefixed
with ``ab=<parent|change> run=<i>``; the card's name and power limit
come first. Needs one CUDA device.

``smoke`` runs each checkout's ``python3 chip_smoke.py`` whole, in the
same turns, each run's output kept in
``$AB_LOG_DIR/ab_smoke_<side>_<i>.log`` (default ``ab_logs``). It
prints each run's exit code and ``done`` seconds, then one ``ab_row``
line a main path (``phase=main_path``, keyed by code, model, mode and
bucket_mb) and a training path (``phase=training path=...`` with a
median step): the median step ms, grads-only ms and profiled idle share
of every run of each side, and ``verdict=worse`` where every change
run's median step is slower than every parent run's (``better`` the
other way round, ``change_only`` where the parent has no such path,
else ``within_spread``).
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
from typing import Dict, List

ORDER = ["parent", "change", "change", "parent", "parent", "change"]

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
    elif code == "decode":
        from pytorch_ps_mpi_tpu_torch.codecs import get_codec
        from pytorch_ps_mpi_tpu_torch.ops import sign as S

        # the parent has no unpack_signs_sum: count what each tree has
        counters = [getattr(S, n) for n in ("unpack_signs",
                                            "unpack_signs_sum")
                    if hasattr(S, n)]
        model = ResNet18(num_classes=10, small_inputs=True, seed=0,
                         device="cuda")
        sign = get_codec("sign")
        gen = torch.Generator(device="cuda").manual_seed(0)
        shapes = [tuple(p.shape) for p in model.parameters()
                  if p.numel() % 1024 == 0]
        for world in (1, 8):
            calls = []
            for shape in shapes:
                payloads = [sign.encode(1e-2 * torch.randn(
                    shape, generator=gen, device="cuda"))[0]
                    for _ in range(world)]
                calls.append(({k: torch.stack([p[k] for p in payloads])
                               for k in ("packed", "scale")}, shape))

            def step():
                for stacked, shape in calls:
                    sign.decode_sum(stacked, shape, torch.float32)

            for _ in range(5):
                events = C._profiled(step)
                for c in counters:
                    c.launches = 0
                step()
                torch.cuda.synchronize()
                print(f"phase=decode_ab world={world} leaves={len(calls)} "
                      f"device_ms={sum(e.self_device_time_total for e in events) / 1e3:.4f} "
                      f"rows={sum(e.count for e in events)} "
                      f"launches={sum(c.launches for c in counters)} "
                      f"ms={C.cuda_ms(step, reps=5, rounds=3):.4f}",
                      flush=True)
    elif code.startswith("bert_"):
        # 12 flash forward and 12 + 12 backward launches a loss step;
        # TernGrad packs 61 leaves whole and 2 in 23 chunks, unpack-sums 63
        flash = {"flash_fwd": 12, "flash_bwd": 24}
        tern = {"tern_pack": 61 + 2 * 23, "tern_unpack": 63}
        model = BertMLM(BertConfig(dtype=torch.bfloat16, attention="flash"),
                        seed=0, device="cuda")
        if code == "bert_identity":
            C.run_bert_path(model, "identity", flash, {},
                            {"all_reduce": 150})
        else:
            C.run_bert_path(model, "terngrad", {**flash, **tern}, tern,
                            {"all_gather": 300})
    elif code == "ef_topk":
        model = ResNet50(num_classes=1000, seed=0, device="cuda")
        # launches a leaf: 31 count passes before the radix select
        per_leaf = getattr(T, "LAUNCHES", T.PASSES)
        C.run_main_path(model, code, "imagenet", C.BATCH_IMAGENET,
                        {"exact_topk": per_leaf * 53}, {"all_gather": 322},
                        "ResNet50-imagenet-gn-f32")
    else:
        model = ResNet18(num_classes=10, small_inputs=True, seed=0,
                         device="cuda")
        if code == "sign":
            from pytorch_ps_mpi_tpu_torch.ops import sign as S

            unpack = ("unpack_signs_sum" if hasattr(S, "unpack_signs_sum")
                      else "unpack_signs")
            per = {"encode_signs": 20, unpack: 20}
        elif code == "identity":
            per = {}
        else:
            per = {"dequantize_int8": 62}
        if code == "int8":
            per["quantize_int8"] = 62
        calls = ({"all_reduce": 62} if code == "identity"
                 else {"all_gather": 124})
        C.run_main_path(model, code, "cifar10", C.BATCH, per, calls,
                        "ResNet18-cifar-gn-f32")
finally:
    torch.distributed.destroy_process_group()
"""


def _field(line: str, name: str) -> str:
    m = re.search(rf"(?:^| ){name}=(\S+)", line)
    return m.group(1) if m else ""


def _row_key(line: str) -> str:
    if line.startswith("phase=main_path"):
        return " ".join(f"{n}={_field(line, n)}"
                        for n in ("code", "model", "mode", "bucket_mb"))
    return " ".join(f"{n}={_field(line, n)}" for n in
                    ("path", "model", "code", "instrument", "bucket_mb")
                    if _field(line, n))


def smoke_ab(trees: Dict[str, str]) -> int:
    """Both checkouts' whole ``chip_smoke.py`` in turns; see the module
    docstring."""
    log_dir = os.environ.get("AB_LOG_DIR", "ab_logs")
    os.makedirs(log_dir, exist_ok=True)
    rows: Dict[str, Dict[str, Dict[str, List[str]]]] = {}
    failed = 0
    for i, side in enumerate(ORDER):
        run = subprocess.run([sys.executable, "chip_smoke.py"],
                             cwd=trees[side], capture_output=True, text=True)
        with open(os.path.join(log_dir, f"ab_smoke_{side}_{i}.log"),
                  "w") as f:
            f.write(run.stdout + "\n--- stderr ---\n" + run.stderr)
        failed += run.returncode != 0
        done, idle = "", ""
        for line in run.stdout.splitlines():
            if line.startswith("phase=done"):
                done = _field(line, "seconds")
            elif line.startswith("phase=profile"):
                # a main path's profiled step is printed before its row
                idle = _field(line, "idle_share")
            elif line.startswith("phase=main_path") or (
                    line.startswith("phase=training")
                    and _field(line, "median_step_ms")):
                got = rows.setdefault(_row_key(line), {}).setdefault(
                    side, {"median": [], "grads": [], "idle": []})
                got["median"].append(_field(line, "median_step_ms"))
                got["grads"].append(_field(line, "grads_step_ms"))
                got["idle"].append(idle if line.startswith("phase=main")
                                   else _field(line, "idle_share"))
        print(f"ab={side} run={i} smoke exit={run.returncode} "
              f"done_seconds={done}", flush=True)
    for key, sides in rows.items():
        med = {side: [float(x) for x in sides.get(side, {}).get("median", [])
                      if x] for side in ("parent", "change")}
        verdict = "within_spread" if med["parent"] else "change_only"
        if med["parent"] and med["change"]:
            if min(med["change"]) > max(med["parent"]):
                verdict = "worse"
            elif max(med["change"]) < min(med["parent"]):
                verdict = "better"
        fields = " ".join(
            f"{side}_{k}=[{','.join(sides.get(side, {}).get(k, []))}]"
            for side in ("parent", "change")
            for k in ("median", "grads", "idle"))
        print(f"ab_row {key} {fields} verdict={verdict}", flush=True)
    return 1 if failed else 0


def main() -> int:
    if len(sys.argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    trees = {"parent": sys.argv[1], "change": sys.argv[2]}
    codes = sys.argv[3:] or ["int8", "qsgd", "ef_topk"]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    if codes == ["smoke"]:
        return smoke_ab(trees)
    failed = 0
    for code in codes:
        for i, side in enumerate(ORDER):
            run = subprocess.run([sys.executable, "-c", SNIPPET, code],
                                 cwd=trees[side], capture_output=True,
                                 text=True)
            for line in run.stdout.splitlines():
                if line.startswith(("phase=main_path", "phase=flash_ab",
                                    "phase=codec_ab", "phase=decode_ab")):
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

"""TernGrad's kernels against the parent commit's, on one NVIDIA GPU.

    python3 chip_tern_ab.py --parent DIR

``DIR`` holds a checkout of the commit before the TernGrad redesign
(``git archive <commit> | tar -x -C DIR``, into a directory that
``.gitignore`` lists). Its ``pytorch_ps_mpi_tpu_torch/csrc/tern.cu``,
with the C entry points ``tern_pack(x, bits, scale, n, out, stream)``
(float32 x, one byte a thread) and ``tern_unpack_sum(packed, scales,
world, m, out, stream)``, is compiled with the package's nvcc flags into
the git-ignored ``_build/`` as ``libtern_parent.so`` and called through
``_build.launch``, as this tree's kernels are.

At BERT-base's sublane-layout units (the 63 leaves of a per-leaf step
and the 15 buckets at ``bucket_mb=16``, sized from the model built on
the meta device), the device time of a step's calls summed from
torch.profiler, in turns parent, new, new, parent:

- the unpack-sum at world 1 and 8 over the leaves and at world 1 over
  the buckets;
- the pack over the 107 calls of a per-leaf step: the parent's kernel on
  the float32 cast (its route's input), this tree's given-scale
  ``tern_pack`` on the same float32 and on the bf16 gradient, and this
  tree's route (61 ``tern_encode``, 2 ``tern_scale`` and 46 chunk
  ``tern_pack`` launches on bf16).

Every output is held bit for bit against the other side's first. Then,
per leaf size, one call's device µs of each unpack-sum at world 1; the
unpack-sum at world 8 in the variants of :data:`VARIANTS` (built from
this tree's source, one text replaced) against the shipped kernel; and
the host µs a call (best of 3 runs of 5,000 calls, in
turns) of the parent's Python wrappers (their code, on the parent's
library) against this tree's, at BERT-base's smallest sublane leaf
(3,072 elements): the pack on float32, the unpack-sum at world 1, and a
whole leaf's encode from bf16 (the parent's route: a float32 copy, abs,
amax, clamp, then its pack; this tree's ``tern_encode``). Prints the
card's name and power limit first, then one line each.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

import chip_smoke as cs


def parent_lib(parent: str) -> ctypes.CDLL:
    from pytorch_ps_mpi_tpu_torch.ops import _build

    src = os.path.join(parent, "pytorch_ps_mpi_tpu_torch", "csrc", "tern.cu")
    _build.BUILD_DIR.mkdir(exist_ok=True)
    lib = _build.BUILD_DIR / "libtern_parent.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), src],
                   check=True)
    cdll = ctypes.CDLL(str(lib))
    p, n = ctypes.c_void_p, ctypes.c_longlong
    cdll.tern_pack.restype = ctypes.c_int
    cdll.tern_pack.argtypes = [p, p, p, n, p, p]
    cdll.tern_unpack_sum.restype = ctypes.c_int
    cdll.tern_unpack_sum.argtypes = [p, p, ctypes.c_int, n, p, p]
    return cdll


_BATCH = "tern_unpack_sum_kernel<4><<<"
_BOUNDS = "__launch_bounds__(kThreads)\ntern_unpack_sum_kernel("
#: the world > 1 unpack-sum's variants: this tree's source with one text
#: replaced (the rank batch, or a minimum of resident blocks an SM, which
#: caps the registers a thread)
VARIANTS = {
    "batch8": (_BATCH, "tern_unpack_sum_kernel<8><<<"),
    "batch2": (_BATCH, "tern_unpack_sum_kernel<2><<<"),
    "min_blocks6": (_BOUNDS, "__launch_bounds__(kThreads, kBatch == 1 ? 1 "
                             ": 6)\ntern_unpack_sum_kernel("),
    "min_blocks8": (_BOUNDS, "__launch_bounds__(kThreads, kBatch == 1 ? 1 "
                             ": 8)\ntern_unpack_sum_kernel("),
}


def variant_lib(name: str) -> ctypes.CDLL:
    """This tree's ``csrc/tern.cu`` with :data:`VARIANTS`' replacement
    ``name``, built and loaded."""
    from pytorch_ps_mpi_tpu_torch.ops import _build

    src = (_build.CSRC / "tern.cu").read_text()
    old, new = VARIANTS[name]
    if src.count(old) != 1:
        raise AssertionError(f"{name}: the text to replace is not where "
                             f"expected")
    path = _build.BUILD_DIR / f"tern_{name}.cu"
    path.write_text(src.replace(old, new))
    lib = _build.BUILD_DIR / f"libtern_{name}.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(path)], check=True)
    cdll = ctypes.CDLL(str(lib))
    p, n = ctypes.c_void_p, ctypes.c_longlong
    cdll.tern_unpack_sum.restype = ctypes.c_int
    cdll.tern_unpack_sum.argtypes = [p, p, ctypes.c_int, n, p, p]
    return cdll


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="a checkout of the parent commit")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_tern_ab: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.cuda.set_device(0)
    from pytorch_ps_mpi_tpu_torch.models import BertConfig, BertMLM
    from pytorch_ps_mpi_tpu_torch.ops import _build
    from pytorch_ps_mpi_tpu_torch.ops import tern as TG

    lib = parent_lib(args.parent)
    _build.build("tern")
    meta = BertMLM(BertConfig(dtype=torch.bfloat16, attention="flash"),
                   seed=0, device="meta")
    leaves = cs.tern_calls(meta)
    buckets = cs.tern_units(cs.bucket_sizes(meta))
    gen = torch.Generator(device="cuda").manual_seed(17)

    def parent_unpack(packed, scales):
        out = torch.empty(4 * packed.shape[1], device="cuda")
        _build.launch(lib.tern_unpack_sum, 0, packed.data_ptr(),
                      scales.data_ptr(), packed.shape[0], packed.shape[1],
                      out.data_ptr())
        return out

    def parent_pack(x, bits, scale):
        out = torch.empty(x.numel() // 4, dtype=torch.uint8, device="cuda")
        _build.launch(lib.tern_pack, 0, x.data_ptr(), bits.data_ptr(),
                      scale.data_ptr(), x.numel(), out.data_ptr())
        return out

    def turns(what: str, parent, new, **fields) -> None:
        got = {"parent": [], "new": []}
        for side in ("parent", "new", "new", "parent"):
            fn = parent if side == "parent" else new
            got[side].append(cs.device_ms(fn))
        print(f"phase=tern_ab what={what} turns=parent,new,new,parent "
              f"parent_device_ms={json.dumps([round(v, 4) for v in got['parent']])} "
              f"new_device_ms={json.dumps([round(v, 4) for v in got['new']])} "
              + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)

    for what, units, world in (("unpack_sum_leaves", leaves, 1),
                               ("unpack_sum_leaves", leaves, 8),
                               ("unpack_sum_buckets", buckets, 1)):
        calls = [(torch.randint(0, 256, (world, sum(u) // 4), generator=gen,
                                device="cuda", dtype=torch.uint8),
                  torch.rand(world, generator=gen, device="cuda"))
                 for u in units]
        for a in calls:
            if not torch.equal(parent_unpack(*a).view(torch.int32),
                               TG.tern_unpack_sum(*a).view(torch.int32)):
                raise AssertionError(f"{what}: the unpack-sums differ")
        turns(what, lambda: [parent_unpack(*a) for a in calls],
              lambda: [TG.tern_unpack_sum(*a) for a in calls],
              world=world, calls=len(calls))
        if what == "unpack_sum_leaves" and world == 1:
            by_size = {a[0].shape[1]: a for a in calls}
            sizes = sorted(by_size)
            rows = {side: cs._profiled(lambda: [fn(*by_size[m])
                                                for m in sizes])
                    for side, fn in (("parent", parent_unpack),
                                     ("new", TG.tern_unpack_sum))}
            print("phase=tern_ab what=unpack_sum_us_a_call world=1 "
                  + " ".join(f"{side}={json.dumps({4 * m: round(e.self_device_time_total, 3) for m, e in zip(sizes, r)}, separators=(',', ':'))}"
                             for side, r in rows.items()), flush=True)
        del calls

    # a per-leaf step's pack calls: the chunks of a chunked leaf share
    # their leaf's scale
    data = []
    for unit in leaves:
        x = (1e-3 * torch.randn(sum(unit), generator=gen, device="cuda")
             ).to(torch.bfloat16)
        bits = torch.randint(-2**31, 2**31, (sum(unit),), generator=gen,
                             device="cuda", dtype=torch.int32)
        data.append((x, bits, unit))
    calls = []
    for x, bits, unit in data:
        g = x.float()
        s = g.abs().amax()
        start = 0
        for c in unit:
            calls.append((g[start:start + c], x[start:start + c],
                          bits[start:start + c], s))
            start += c
    for g, x, b, s in calls:
        want = parent_pack(g, b, s)
        if not (torch.equal(TG.tern_pack(g, b, s), want)
                and torch.equal(TG.tern_pack(x, b, s), want)):
            raise AssertionError("the packs differ")
    turns("pack_float32", lambda: [parent_pack(g, b, s)
                                   for g, _, b, s in calls],
          lambda: [TG.tern_pack(g, b, s) for g, _, b, s in calls],
          calls=len(calls))
    turns("pack_new_on_bf16", lambda: [parent_pack(g, b, s)
                                        for g, _, b, s in calls],
          lambda: [TG.tern_pack(x, b, s) for _, x, b, s in calls],
          calls=len(calls))

    def new_route():
        for x, bits, unit in data:
            if len(unit) == 1:
                TG.tern_encode(x, bits)
                continue
            s = TG.tern_scale(x)
            start = 0
            for c in unit:
                TG.tern_pack(x[start:start + c], bits[start:start + c], s)
                start += c

    turns("route_kernels", lambda: [parent_pack(g, b, s)
                                    for g, _, b, s in calls],
          new_route, parent_route="float32_packs",
          new_route="bf16_encode_scale_pack", parent_calls=len(calls),
          new_calls=json.dumps(cs.TERN_LEAF, separators=(",", ":")))

    # world 8: the rank batch
    variants = {name: variant_lib(name) for name in VARIANTS}
    calls = [(torch.randint(0, 256, (8, sum(u) // 4), generator=gen,
                            device="cuda", dtype=torch.uint8),
              torch.rand(8, generator=gen, device="cuda")) for u in leaves]

    def variant(lib):
        def run():
            outs = []
            for packed, scales in calls:
                out = torch.empty(4 * packed.shape[1], device="cuda")
                _build.launch(lib.tern_unpack_sum, 0, packed.data_ptr(),
                              scales.data_ptr(), 8, packed.shape[1],
                              out.data_ptr())
                outs.append(out)
            return outs
        return run

    for b, vlib in variants.items():
        for got, a in zip(variant(vlib)(), calls):
            if not torch.equal(got.view(torch.int32),
                               TG.tern_unpack_sum(*a).view(torch.int32)):
                raise AssertionError(f"{b} differs")
        turns(f"unpack_sum_world8_{b}_against_shipped",
              lambda: [TG.tern_unpack_sum(*a) for a in calls],
              variant(vlib), calls=len(calls), parent_side="shipped",
              new_side=b)
    del calls

    # host µs a call: the parent's wrappers (their code, on its library)
    # against this tree's
    def check(x, dtype, dim):
        if x.dim() != dim or x.dtype != dtype or x.numel() == 0:
            raise ValueError("shape or type")
        if x.device.type not in ("cpu", "cuda"):
            raise ValueError("device")

    def parent_wrapper_pack(flat, bits, scale):
        check(flat, torch.float32, 1)
        check(bits, torch.int32, 1)
        n = flat.numel()
        if n % TG.GROUP or bits.numel() != n or scale.numel() != 1:
            raise ValueError("tern_pack")
        if not (bits.device == scale.device == flat.device):
            raise ValueError("tern_pack: flat, bits and scale must share a "
                             "device")
        scale = scale.to(torch.float32)
        if flat.device.type == "cpu":
            raise ValueError("the card's path only")
        flat, bits, scale = (flat.contiguous(), bits.contiguous(),
                             scale.contiguous())
        out = torch.empty(n // 4, dtype=torch.uint8, device=flat.device)
        with torch.cuda.device(flat.device):
            err = lib.tern_pack(flat.data_ptr(), bits.data_ptr(),
                                scale.data_ptr(), n, out.data_ptr(),
                                torch.cuda.current_stream(
                                    flat.device).cuda_stream)
        if err:
            raise RuntimeError(err)
        return out

    def parent_wrapper_unpack(packed, scales):
        check(packed, torch.uint8, 2)
        check(scales, torch.float32, 1)
        world, m = packed.shape
        if m % TG.LANE or scales.shape[0] != world \
                or scales.device != packed.device:
            raise ValueError("tern_unpack_sum")
        if packed.device.type == "cpu":
            raise ValueError("the card's path only")
        packed, scales = packed.contiguous(), scales.contiguous()
        out = torch.empty(4 * m, dtype=torch.float32, device=packed.device)
        with torch.cuda.device(packed.device):
            err = lib.tern_unpack_sum(
                packed.data_ptr(), scales.data_ptr(), world, m,
                out.data_ptr(),
                torch.cuda.current_stream(packed.device).cuda_stream)
        if err:
            raise RuntimeError(err)
        return out

    def parent_encode(x, bits):
        g = x.to(torch.float32)
        scale = torch.clamp(g.abs().amax(), min=1e-12)
        return parent_wrapper_pack(g, bits, scale), scale

    n = min(sum(u) for u in leaves)
    x = torch.randn(n, generator=gen, device="cuda").to(torch.bfloat16)
    g = x.float()
    bits = torch.randint(-2**31, 2**31, (n,), generator=gen, device="cuda",
                         dtype=torch.int32)
    s = g.abs().amax()
    packed = TG.tern_pack(g, bits, s).reshape(1, -1)
    scales = s.reshape(1)
    for what, parent_fn, new_fn in (
            ("pack_float32", lambda: parent_wrapper_pack(g, bits, s),
             lambda: TG.tern_pack(g, bits, s)),
            ("unpack_sum_world1", lambda: parent_wrapper_unpack(packed,
                                                                scales),
             lambda: TG.tern_unpack_sum(packed, scales)),
            ("encode_whole_leaf", lambda: parent_encode(x, bits),
             lambda: TG.tern_encode(x, bits))):
        got = {"parent": [], "new": []}
        for side in ("parent", "new", "new", "parent"):
            got[side].append(cs.host_us(parent_fn if side == "parent"
                                        else new_fn, 5000))
            torch.cuda.synchronize()
        print(f"phase=tern_ab what=host_us_a_call_{what} n={n} "
              f"turns=parent,new,new,parent "
              f"parent_us={json.dumps([round(v, 3) for v in got['parent']])} "
              f"new_us={json.dumps([round(v, 3) for v in got['new']])}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

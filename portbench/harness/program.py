"""The port as a cell drives it: its model built as a user builds it,
the benchmark's weights loaded into it, its optimizer with the mix's
codec, and a pool of batches, all made on the device from the run's
seed. Every step is ``MPI_PS.step(loss_fn=..., batch=...)``."""

from __future__ import annotations

import time
from typing import Callable, Dict, List

import torch

#: odd 64-bit constants of splitmix64, to derive independent seeds
_MIX = (0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9)


def sub_seed(seed: int, k: int) -> int:
    """The ``k``-th seed derived from the run's ``--seed``: 1 the
    weights, 2 the batches, 3 the codec's."""
    return (seed * _MIX[0] + k * _MIX[1]) & (2**63 - 1)


def codec_seed(seed: int) -> int:
    """The ``seed`` the optimizer is given (its codec's generator takes
    ``seed * 1_000_003 + rank``)."""
    return sub_seed(seed, 3) % 2**31


def generator(device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def weights(cell, seed: int, device) -> Dict[str, torch.Tensor]:
    return cell.family.weights(cell.cfg, generator(device, sub_seed(seed, 1)),
                               device)


def batches(cell, seed: int, device) -> List[dict]:
    return cell.family.pool(cell.cfg, cell.mix,
                            generator(device, sub_seed(seed, 2)), device)


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's ``launches`` counter in the port's ``ops``."""
    import importlib
    import pkgutil

    from pytorch_ps_mpi_tpu_torch import ops

    out = {}
    for info in pkgutil.iter_modules(ops.__path__):
        if info.name.startswith("_"):
            continue
        mod = importlib.import_module(f"{ops.__name__}.{info.name}")
        for name, fn in vars(mod).items():
            if callable(fn) and isinstance(getattr(fn, "launches", None),
                                           int):
                out[f"{info.name}.{name}"] = fn.launches
    return out


class Program:
    """One cell's program. ``feed`` maps a batch of the pool to what the
    step is given (the identity; a planted fault replaces it)."""

    def __init__(self, cell, seed: int, device):
        from pytorch_ps_mpi_tpu_torch.codecs import get_codec

        self.cell, self.device = cell, torch.device(device)
        t0 = time.perf_counter()
        self.model = cell.family.program_model(cell.cfg, self.device)
        #: seconds of set-up by part, for the notes
        self.times = {"model": time.perf_counter() - t0}
        w = weights(cell, seed, self.device)
        named = dict(self.model.named_parameters())
        if [(k, tuple(p.shape)) for k, p in named.items()] != \
                [(k, tuple(t.shape)) for k, t in w.items()]:
            raise ValueError(f"{cell.name}: the port's parameters are not the "
                             f"benchmark's weights, in their order")
        with torch.no_grad():
            for k, p in named.items():
                p.copy_(w[k])
        del w
        #: the leaves in the order the optimizer is given them
        self.shapes = {k: tuple(p.shape) for k, p in named.items()}
        code = get_codec(cell.mix["codec"], **cell.mix["codec_args"])
        self.opt = cell.optimizer.build(self.model, code, cell.mix,
                                        codec_seed(seed), self.device)
        self.pool = batches(cell, seed, self.device)
        self.loss_fn = cell.family.program_loss(self.model)
        self.times["weights_optimizer_pool"] = (time.perf_counter() - t0
                                                - self.times["model"])
        self.feed: Callable[[dict], dict] = lambda b: b
        self.steps = 0

    def step(self, loss_fn=None):
        batch = self.feed(self.pool[self.steps % len(self.pool)])
        self.steps += 1
        return self.opt.step(loss_fn=loss_fn or self.loss_fn, batch=batch)

    def first_steps(self, seed: int, steps: int) -> dict:
        """The first ``steps`` steps, each through :meth:`step` on its own
        batch of the pool, and what the reference is held to: each step's
        loss, each leaf's first step's gradient as the optimizer received
        it, the family's head leaves' gradient before the codec (where the
        codec's state gives it back), and each leaf's change after the
        last of these steps (copied to the host, out of the card's
        memory)."""
        if steps > len(self.pool):
            raise ValueError("the first steps need batches that all differ")
        losses, grads, head = [], None, None
        for j in range(steps):
            loss, _ = self.step()
            losses.append(loss.detach().float())
            if j == 0:
                got = self.cell.optimizer.first_gradient(self.opt,
                                                         self.cell.mix)
                grads = {k: g.to("cpu", copy=True) for k, g in got.items()}
                raw = self.cell.codec.raw_first_gradient(self.opt, got)
                if raw is not None:
                    head = {k: raw[k].to("cpu", copy=True)
                            for k in self.cell.family.HEAD}
                del got, raw
        start = weights(self.cell, seed, self.device)
        with torch.no_grad():
            change = {k: (p.detach() - start[k]).to("cpu")
                      for k, p in self.model.named_parameters()}
        del start
        return {"losses": torch.stack(losses).tolist(), "grads": grads,
                "change": change, "head": head}

    def close(self) -> None:
        """Drop every tensor of the program's state."""
        for name in ("opt", "model", "pool", "loss_fn"):
            setattr(self, name, None)


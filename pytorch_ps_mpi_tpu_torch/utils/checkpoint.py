"""Step-indexed checkpoints (``pytorch_ps_mpi_tpu/utils/checkpoint.py``).

The JAX package saves its training tree with Orbax (or numpy ``.npz``);
the port saves it with ``torch.save`` and loads it with
``torch.load(weights_only=True)``, so a checkpoint holds tensors, numbers
and plain containers and loading it runs no code. Named tuples (the
optimizer states) are saved as tuples and rebuilt from the template
given to :meth:`CheckpointManager.restore`, whose tensors also say where
each restored tensor goes: onto the template's device (the parameters').

Every rank holds its own state (its generator, its shards in leader
mode), so at a world above one each rank writes its own file,
``ckpt_<step>.rank<r>.pt``; at world one the file is ``ckpt_<step>.pt``.
"""

from __future__ import annotations

import os
import re
from typing import Any, List, Optional

import torch

from pytorch_ps_mpi_tpu_torch import mesh

Tree = Any


def _plain(tree: Tree) -> Tree:
    """``tree`` with named tuples as tuples and tensors detached."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return tuple(_plain(v) for v in tree) if isinstance(tree, tuple) \
            else [_plain(v) for v in tree]
    if torch.is_tensor(tree):
        return tree.detach()
    return tree


def _like(template: Tree, loaded: Tree, path: str = "") -> Tree:
    """``loaded`` in the structure of ``template``: named tuples rebuilt,
    each tensor on its template tensor's device. Raises ``ValueError``
    where the two differ (another schema)."""
    where = path or "<root>"
    if isinstance(template, dict):
        if not isinstance(loaded, dict) or set(loaded) != set(template):
            raise ValueError(f"checkpoint keys at {where} differ from the "
                             "template's")
        return {k: _like(v, loaded[k], f"{path}/{k}")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        if (not isinstance(loaded, (list, tuple))
                or len(loaded) != len(template)):
            raise ValueError(f"checkpoint sequence at {where} differs from "
                             "the template's")
        items = [_like(t, x, f"{path}/{i}")
                 for i, (t, x) in enumerate(zip(template, loaded))]
        if hasattr(template, "_fields"):
            return type(template)(*items)
        return type(template)(items)
    if torch.is_tensor(template):
        if not torch.is_tensor(loaded) or loaded.shape != template.shape:
            raise ValueError(f"checkpoint tensor at {where} has another "
                             "shape than the template's")
        return loaded.to(template.device)
    if torch.is_tensor(loaded) or isinstance(loaded, (dict, list, tuple)):
        raise ValueError(f"checkpoint leaf at {where} differs from the "
                         "template's")
    return loaded


class CheckpointManager:
    """``save(step, state)``, ``restore(template, step=None)`` and
    ``latest_step()`` over a directory, keeping the newest
    ``max_to_keep`` steps. ``state`` is a tree of dicts, tuples (named
    ones too), lists, tensors and numbers."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        world = mesh.world_size()
        self._suffix = f".rank{mesh.rank()}.pt" if world > 1 else ".pt"

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}{self._suffix}")

    def save(self, step: int, state: Tree) -> None:
        """Write ``state`` for ``step`` (through a temporary file and a
        rename, so a crash leaves no partial checkpoint), then drop the
        steps past ``max_to_keep``."""
        path = self._path(step)
        tmp = path + ".tmp"
        torch.save(_plain(state), tmp)
        os.replace(tmp, path)
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def steps(self) -> List[int]:
        """This rank's saved steps, oldest first."""
        pattern = re.compile(r"ckpt_(\d+)" + re.escape(self._suffix) + "$")
        return sorted(int(m.group(1)) for m in map(
            pattern.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, template: Tree, step: Optional[int] = None) -> Tree:
        """The state saved at ``step`` (default the latest) in the
        structure of ``template``, each tensor on its template tensor's
        device. Raises ``FileNotFoundError`` without a checkpoint and
        ``ValueError`` when the saved tree is not ``template``'s."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        loaded = torch.load(self._path(step), map_location="cpu",
                            weights_only=True)
        return _like(template, loaded)

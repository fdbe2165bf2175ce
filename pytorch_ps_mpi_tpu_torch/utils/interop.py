"""Carry weights between the JAX package's flax models and the port's.

Name map (port parameter -> flax path under ``params``):

=====================================  ==============================================
port (``named_parameters``)            flax
=====================================  ==============================================
``stem.weight``                        ``Conv_0/kernel``
``stem_norm.{weight,bias}``            ``stem_norm/GroupNorm_0/{scale,bias}``
``blocks.{i}.conv{k}.weight``          ``{Block}_{i}/Conv_{k-1}/kernel``
``blocks.{i}.norm{k}.{weight,bias}``   ``{Block}_{i}/AdaptiveGroupNorm_{k-1}/GroupNorm_0/{scale,bias}``
``blocks.{i}.shortcut.weight``         ``{Block}_{i}/shortcut/kernel``
``blocks.{i}.shortcut_norm.*``         ``{Block}_{i}/shortcut_norm/GroupNorm_0/{scale,bias}``
``head.{weight,bias}``                 ``Dense_0/{kernel,bias}``
``layers.{i}.{weight,bias}`` (MLP)     ``Dense_{i}/{kernel,bias}``
``a.b.c`` (``BertMLM``)                ``a/b/c``
=====================================  ==============================================

``{Block}`` is ``ResNetBlock`` or ``BottleneckBlock``. Layouts: a conv
kernel is HWIO in flax and OIHW here; a Dense kernel ``[in, out]`` is a
Linear weight ``[out, in]``; GroupNorm's scale is the weight. ``BertMLM``
keeps flax's names and layouts (``tok_emb/embedding``,
``layer_{i}/SelfAttention_0/{qkv,out}/{kernel,bias}``,
``layer_{i}/LayerNorm_{0,1}/{scale,bias}``,
``layer_{i}/Dense_{0,1}/{kernel,bias}``, ``LayerNorm_0``, ``mlm_head``),
so its leaves cross unchanged.

Leaf order: ``jax.tree.flatten`` visits dict keys in sorted order, so
the JAX package's leaf order is the sort of the flax paths (note that
``ResNetBlock_10`` sorts before ``ResNetBlock_2``). :func:`jax_leaf_order`
gives the port's names in that order, and :func:`params_from_jax`
returns its dict in it, so the optimizer iterates leaves as the JAX
package does.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from pytorch_ps_mpi_tpu_torch.models.bert import BertMLM
from pytorch_ps_mpi_tpu_torch.models.mlp import MLP
from pytorch_ps_mpi_tpu_torch.models.resnet import BottleneckBlock, ResNet

Path = Tuple[str, ...]


def _norm_path(prefix: Path, leaf: str) -> Path:
    return prefix + ("GroupNorm_0", "scale" if leaf == "weight" else "bias")


def _resnet_path(model: ResNet, name: str) -> Path:
    parts = name.split(".")
    if parts[0] == "stem":
        return ("Conv_0", "kernel")
    if parts[0] == "stem_norm":
        return _norm_path(("stem_norm",), parts[1])
    if parts[0] == "head":
        return ("Dense_0", "kernel" if parts[1] == "weight" else "bias")
    i, mod, leaf = int(parts[1]), parts[2], parts[3]
    kind = ("BottleneckBlock" if isinstance(model.blocks[i], BottleneckBlock)
            else "ResNetBlock")
    block = f"{kind}_{i}"
    if mod == "shortcut":
        return (block, "shortcut", "kernel")
    if mod == "shortcut_norm":
        return _norm_path((block, "shortcut_norm"), leaf)
    k = int(re.fullmatch(r"(?:conv|norm)(\d)", mod).group(1)) - 1
    if mod.startswith("conv"):
        return (block, f"Conv_{k}", "kernel")
    return _norm_path((block, f"AdaptiveGroupNorm_{k}"), leaf)


def flax_path(model: nn.Module, name: str) -> Path:
    """The flax path (under ``params``) of the port parameter ``name``."""
    if isinstance(model, ResNet):
        return _resnet_path(model, name)
    if isinstance(model, MLP):
        _, i, leaf = name.split(".")
        return (f"Dense_{i}", "kernel" if leaf == "weight" else "bias")
    if isinstance(model, BertMLM):
        return tuple(name.split("."))
    raise TypeError(f"no flax name map for {type(model).__name__}")


def jax_leaf_order(model: nn.Module) -> List[str]:
    """The port's parameter names in the JAX package's leaf order."""
    return sorted((n for n, _ in model.named_parameters()),
                  key=lambda n: flax_path(model, n))


def _flax_layout_kept(model: nn.Module) -> bool:
    return isinstance(model, BertMLM)


def torch_layout(path: Path, a: np.ndarray) -> np.ndarray:
    """A flax leaf at ``path`` in the port's layout (ResNet, MLP)."""
    if path[-1] == "kernel" and a.ndim == 4:
        return a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if path[-1] == "kernel" and a.ndim == 2:
        return a.T                      # [in, out] -> [out, in]
    return a


def flax_layout(path: Path, a: np.ndarray) -> np.ndarray:
    """A port leaf bound for flax ``path``, in flax's layout (ResNet,
    MLP)."""
    if path[-1] == "kernel" and a.ndim == 4:
        return a.transpose(2, 3, 1, 0)  # OIHW -> HWIO
    if path[-1] == "kernel" and a.ndim == 2:
        return a.T
    return a


@torch.no_grad()
def params_from_jax(flax_params, model: nn.Module) -> Dict[str, torch.Tensor]:
    """Copy a flax parameter tree (numpy leaves; the variables dict with
    a ``"params"`` key or the inner dict) into ``model``'s parameters.
    Returns the model's ``name -> parameter`` dict in JAX leaf order."""
    tree = flax_params.get("params", flax_params)
    named = dict(model.named_parameters())
    out = {}
    for name in jax_leaf_order(model):
        path = flax_path(model, name)
        node = tree
        for key in path:
            node = node[key]
        src = np.asarray(node)
        if not _flax_layout_kept(model):
            src = torch_layout(path, src)
        src = np.array(src, order="C")
        p = named[name]
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"{name}: flax {'/'.join(path)} has shape "
                             f"{src.shape}, the port {tuple(p.shape)}")
        p.copy_(torch.from_numpy(src))
        out[name] = p
    return out


def params_to_jax(model: nn.Module) -> Dict[str, dict]:
    """``model``'s parameters as a flax variables dict of numpy arrays,
    ``{"params": {...}}``."""
    tree: dict = {}
    for name, p in model.named_parameters():
        path = flax_path(model, name)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        a = p.detach().cpu().numpy()
        node[path[-1]] = np.ascontiguousarray(
            a if _flax_layout_kept(model) else flax_layout(path, a))
    return {"params": tree}

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

``{Block}`` is ``ResNetBlock`` or ``BottleneckBlock``. With
``norm="batch"`` flax names the norms otherwise: ``stem_norm/{scale,bias}``,
``{Block}_{i}/BatchNorm_{k-1}/{scale,bias}`` and
``{Block}_{i}/shortcut_norm/{scale,bias}``; their running statistics
(the port's buffers ``*.mean``, ``*.var``) sit at the same paths under
``batch_stats`` (:func:`aux_from_jax`, :func:`aux_to_jax`). Layouts: a conv
kernel is HWIO in flax and OIHW here; a Dense kernel ``[in, out]`` is a
Linear weight ``[out, in]``; GroupNorm's scale is the weight. ``BertMLM``
keeps flax's names and layouts (``tok_emb/embedding``,
``layer_{i}/SelfAttention_0/{qkv,out}/{kernel,bias}``,
``layer_{i}/LayerNorm_{0,1}/{scale,bias}``,
``layer_{i}/Dense_{0,1}/{kernel,bias}``, ``LayerNorm_0``, ``mlm_head``),
so its leaves cross unchanged; so do ``GPTLM``'s (``tok_emb``,
``pos_emb``, the layers, ``LayerNorm_0``; its head is the tied
embedding) and ``SwitchMLM``'s (``layer_{i}/MoEFFN_0/{wr,w1,w2}``, the
experts stacked ``[E, ...]``). Under ``scan_layers`` the layers are
flax's ``layers/EncoderLayer_0/...``, each leaf stacked ``[L, ...]``,
and the port's names are the same path joined by dots.

Model-parallel shards: a rank's shard of a leaf is its block of the JAX
global array under the leaf's spec (``mesh.Mesh.shard``).
:func:`params_from_jax` cuts a ``SwitchMLM``'s expert stacks so (or any
leaves, given ``param_specs``), and :func:`shards_from_jax` cuts a plain
parameter tree (the TP, PP and EP layers' ``[tp, ...]``, ``[pipe, ...]``
and ``[E, ...]`` stacks) into this rank's ``name -> tensor`` dict.

Leaf order: ``jax.tree.flatten`` visits dict keys in sorted order, so
the JAX package's leaf order is the sort of the flax paths (note that
``ResNetBlock_10`` sorts before ``ResNetBlock_2``). :func:`jax_leaf_order`
gives the port's names in that order, and :func:`params_from_jax`
returns its dict in it, so the optimizer iterates leaves as the JAX
package does.

Codecs whose result depends on the order of a leaf's elements see a
ResNet or MLP kernel in the flax layout (its ``codec_view``,
``models.init.mark_flax_views``) and keep their codec state in that view;
:func:`codec_state_from_jax` carries the JAX package's codec state (error
feedback's memory, PowerSGD's Q and residual, threshold's tau) across in
the port's leaf order and in the layout the port's step keeps it.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from pytorch_ps_mpi_tpu_torch.models.bert import BertMLM
from pytorch_ps_mpi_tpu_torch.models.gpt import GPTLM
from pytorch_ps_mpi_tpu_torch.models.mlp import MLP
from pytorch_ps_mpi_tpu_torch.models.moe import SwitchMLM, moe_param_spec
from pytorch_ps_mpi_tpu_torch.models.resnet import BottleneckBlock, ResNet

Path = Tuple[str, ...]


def _norm_path(model: ResNet, prefix: Path, leaf: str) -> Path:
    """A norm's leaf: GroupNorm's sit one module deeper; BatchNorm's
    running ``mean`` and ``var`` keep their names."""
    name = {"weight": "scale", "bias": "bias"}.get(leaf, leaf)
    if model.norm == "batch":
        return prefix + (name,)
    return prefix + ("GroupNorm_0", name)


def _resnet_path(model: ResNet, name: str) -> Path:
    parts = name.split(".")
    if parts[0] == "stem":
        return ("Conv_0", "kernel")
    if parts[0] == "stem_norm":
        return _norm_path(model, ("stem_norm",), parts[1])
    if parts[0] == "head":
        return ("Dense_0", "kernel" if parts[1] == "weight" else "bias")
    i, mod, leaf = int(parts[1]), parts[2], parts[3]
    kind = ("BottleneckBlock" if isinstance(model.blocks[i], BottleneckBlock)
            else "ResNetBlock")
    block = f"{kind}_{i}"
    if mod == "shortcut":
        return (block, "shortcut", "kernel")
    if mod == "shortcut_norm":
        return _norm_path(model, (block, "shortcut_norm"), leaf)
    k = int(re.fullmatch(r"(?:conv|norm)(\d)", mod).group(1)) - 1
    if mod.startswith("conv"):
        return (block, f"Conv_{k}", "kernel")
    norm = "BatchNorm" if model.norm == "batch" else "AdaptiveGroupNorm"
    return _norm_path(model, (block, f"{norm}_{k}"), leaf)


def flax_path(model: nn.Module, name: str) -> Path:
    """The flax path (under ``params``) of the port parameter ``name``, or
    (under ``batch_stats``) of a BatchNorm buffer."""
    if isinstance(model, ResNet):
        return _resnet_path(model, name)
    if isinstance(model, MLP):
        _, i, leaf = name.split(".")
        return (f"Dense_{i}", "kernel" if leaf == "weight" else "bias")
    if isinstance(model, (BertMLM, GPTLM, SwitchMLM)):
        return tuple(name.split("."))
    raise TypeError(f"no flax name map for {type(model).__name__}")


def jax_leaf_order(model: nn.Module) -> List[str]:
    """The port's parameter names in the JAX package's leaf order."""
    return sorted((n for n, _ in model.named_parameters()),
                  key=lambda n: flax_path(model, n))


def _flax_layout_kept(model: nn.Module) -> bool:
    return isinstance(model, (BertMLM, GPTLM, SwitchMLM))


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


def codec_state_from_jax(jax_state, model: nn.Module, code,
                         rank: int = 0) -> Dict[str, Any]:
    """The JAX package's ``MPI_PS.codec_state`` (a tree shaped like the
    parameters, each array stacked ``[world, ...]``) as this rank's
    ``codec_state`` of the port: ``name -> state`` in JAX leaf order, each
    array a numpy copy of row ``rank``. An order-dependent ``code`` keeps
    its state in the flax layout (the codec's view), so it crosses
    unchanged; error feedback's ``memory`` around another codec is turned
    into the port's layout."""
    tree = jax_state.get("params", jax_state)
    relayout = not (code.order_dependent or _flax_layout_kept(model))

    def row(node, path, key=None):
        if isinstance(node, dict):
            return {k: row(v, path, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(row(v, path) for v in node)
        a = np.array(np.asarray(node)[rank])
        return (np.ascontiguousarray(torch_layout(path, a))
                if relayout and key == "memory" else a)

    out = {}
    for name in jax_leaf_order(model):
        path = flax_path(model, name)
        node = tree
        for key in path:
            node = node[key]
        out[name] = row(node, path)
    return out


@torch.no_grad()
def params_from_jax(flax_params, model: nn.Module, param_specs=None,
                    mesh=None) -> Dict[str, torch.Tensor]:
    """Copy a flax parameter tree (numpy leaves; the variables dict with
    a ``"params"`` key or the inner dict) into ``model``'s parameters.
    Returns the model's ``name -> parameter`` dict in JAX leaf order.
    ``param_specs`` (``name -> mesh.P``): the model holds this rank's
    shards, each cut from the global leaf under its spec on ``mesh`` (by
    default the model's own); a ``SwitchMLM`` with an expert axis takes
    ``moe_param_spec`` by default."""
    tree = flax_params.get("params", flax_params)
    named = dict(model.named_parameters())
    if param_specs is None and isinstance(model, SwitchMLM) \
            and model.cfg.expert_axis is not None:
        param_specs = moe_param_spec(named, model.cfg.expert_axis)
    if mesh is None:
        mesh = getattr(model, "mesh", None)
    out = {}
    for name in jax_leaf_order(model):
        path = flax_path(model, name)
        node = tree
        for key in path:
            node = node[key]
        src = np.asarray(node)
        if not _flax_layout_kept(model):
            src = torch_layout(path, src)
        if param_specs and param_specs.get(name):
            src = mesh.shard(src, param_specs[name])
        src = np.array(src, order="C")
        p = named[name]
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"{name}: flax {'/'.join(path)} has shape "
                             f"{src.shape}, the port {tuple(p.shape)}")
        p.copy_(torch.from_numpy(src))
        out[name] = p
    return out


def flat_from_jax(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested dict of arrays (a JAX parameter tree) as ``"a.b" ->
    array``, in JAX leaf order (sorted keys at every level)."""
    out: Dict[str, np.ndarray] = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flat_from_jax(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def shards_from_jax(tree, param_specs=None, mesh=None,
                    device="cpu") -> Dict[str, torch.Tensor]:
    """This rank's shard of every leaf of a JAX parameter tree (a nested
    dict of arrays, or ``name -> array``) as float tensors on ``device``,
    ``name -> tensor`` in JAX leaf order: its block under
    ``param_specs[name]`` (``name -> mesh.P``, flat dotted names; missing:
    the whole leaf) on ``mesh``."""
    flat = flat_from_jax(tree)
    specs = param_specs or {}
    out = {}
    for k, a in flat.items():
        if specs.get(k):
            a = mesh.shard(a, specs[k])
        out[k] = torch.from_numpy(np.array(a, order="C")).to(device)
    return out


@torch.no_grad()
def aux_from_jax(batch_stats, model: ResNet) -> Dict[str, torch.Tensor]:
    """flax's ``batch_stats`` (the variables dict or the inner dict) as the
    port's ``aux_state``, ``buffer name -> tensor`` in JAX leaf order, on
    the model's device; the model's own buffers are set to them too."""
    tree = batch_stats.get("batch_stats", batch_stats)
    named = dict(model.named_buffers())
    out = {}
    for name in sorted(named, key=lambda n: flax_path(model, n)):
        node = tree
        for key in flax_path(model, name):
            node = node[key]
        named[name].copy_(torch.from_numpy(np.array(node, np.float32)))
        out[name] = named[name].detach().clone()
    return out


def aux_to_jax(aux_state: Dict[str, torch.Tensor],
               model: ResNet) -> Dict[str, dict]:
    """The port's ``aux_state`` as flax's ``{"batch_stats": {...}}`` of
    numpy arrays."""
    tree: dict = {}
    for name, t in aux_state.items():
        path = flax_path(model, name)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t.detach().cpu().numpy()
    return {"batch_stats": tree}


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

"""The port's long-context trainer (``train_longcontext``) and the CLIs of
this slice:

- over gloo at worlds 2 (1 × 2) and 4 (2 × 2) on a (data, seq) mesh, one
  step of ``LongContextTrainer`` with ring and with Ulysses attention,
  from the JAX GPT's weights: the loss and the updated parameters
  against the dense JAX GPT on one device with the same shard-local
  targets and static denominator ``batch · (seq − sp)``, in float32 to
  rtol 1e-5 (the parameters' atol 1e-7);
- the JAX script's own step (a ``shard_map`` with ``check_vma=False``)
  takes ``dp · sp`` times that gradient (ROADMAP queue 3 item 26): shown
  here, and not copied;
- ``train_longcontext`` and ``train_tp`` run end to end at world 4
  through their ``main``;
- the port's train CLIs accept the JAX scripts' flags (read from the
  JAX sources without running them): ``train`` with ``--donate``
  (ROADMAP queue 3 item 25) and its own ``--accum-steps`` and ``--norm``,
  ``train_longcontext`` and ``train_tp`` exactly theirs.
"""

from __future__ import annotations

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as JP

from pytorch_ps_mpi_tpu.mesh import make_mesh as jax_make_mesh
from pytorch_ps_mpi_tpu.models import GPTLM as JGPTLM
from pytorch_ps_mpi_tpu.models import gpt_config as jgpt_config
from pytorch_ps_mpi_tpu_torch.utils.interop import flat_from_jax
from torch_parity import ROOT, spawn_ranks

ARGS = ["--seq", "64", "--hidden", "32", "--layers", "2", "--heads", "4",
        "--vocab", "128", "--batch", "2", "--lr", "0.01", "--steps", "1"]

_WORKER = """
import json, sys
import numpy as np
import torch
from pytorch_ps_mpi_tpu_torch import mesh, train_longcontext as tl
from pytorch_ps_mpi_tpu_torch.utils.interop import params_from_jax
from test_torch_longcontext import ARGS

rank, world, port, src, dst = sys.argv[1:6]
rank, world = int(rank), int(world)
torch.set_num_threads(1)
mesh.initialize_distributed(f"tcp://localhost:{port}", world_size=world,
                            rank=rank, backend="gloo")
data = np.load(src)
tree = {}
for key in data.files:
    if key.startswith("p/"):
        node = tree
        parts = key[2:].split(".")
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = data[key]
out = {}
for att in ("ring", "ulysses"):
    args = tl.parse_args(ARGS + ["--dp", str(world // 2), "--sp", "2",
                                 "--attention", att])
    trainer = tl.LongContextTrainer(args, torch.device("cpu"))
    params_from_jax(tree, trainer.model)
    out[att + "_loss"] = float(trainer.step(torch.from_numpy(data["tokens"])))
    for n, p in trainer.params.items():
        out[f"{att}/{n}"] = p.detach().numpy()
np.savez(f"{dst}.{rank}.npz", **out)
torch.distributed.destroy_process_group()
"""


def _jax_setup(dp: int, sp: int = 2):
    from pytorch_ps_mpi_tpu_torch import train_longcontext as tl

    args = tl.parse_args(ARGS + ["--dp", str(dp), "--sp", str(sp)])
    cfg = jgpt_config(vocab_size=args.vocab, hidden_size=args.hidden,
                      num_layers=args.layers, num_heads=args.heads,
                      intermediate_size=2 * args.hidden,
                      max_position=args.seq)
    toks = tl.make_tokens(args).numpy()
    params = jax.tree.map(np.asarray, JGPTLM(cfg).init(
        jax.random.key(0), jnp.asarray(toks[:1, :16])))
    den = float(args.batch * (args.seq - sp))
    return args, cfg, toks, params, den


def _dense_loss(cfg, toks, sp, den):
    l_local = toks.shape[1] // sp

    def loss(p):
        logits = JGPTLM(cfg).apply(p, jnp.asarray(toks))
        total = 0.0
        for i in range(sp):
            lg = logits[:, i * l_local:(i + 1) * l_local]
            tk = jnp.asarray(toks)[:, i * l_local:(i + 1) * l_local]
            lp = jax.nn.log_softmax(lg[:, :-1], axis=-1)
            total = total + jnp.take_along_axis(lp, tk[:, 1:, None],
                                                axis=-1).sum()
        return -total / den

    return loss


@pytest.mark.parametrize("world", [2, 4])
def test_one_step_matches_the_dense_jax_gradient(tmp_path, world):
    args, cfg, toks, params, den = _jax_setup(world // 2)
    np.savez(tmp_path / "in.npz", tokens=toks,
             **{"p/" + k: v for k, v in flat_from_jax(params).items()})
    spawn_ranks(_WORKER, world, [tmp_path / "in.npz", tmp_path / "out"])
    ranks = [np.load(tmp_path / f"out.{r}.npz") for r in range(world)]
    loss, g = jax.value_and_grad(_dense_loss(cfg, toks, 2, den))(params)
    # SGD with momentum, first step: p - lr * g
    new = flat_from_jax(jax.tree.map(lambda p, d: p - args.lr * d, params,
                                     g)["params"])
    for att in ("ring", "ulysses"):
        for r in ranks:
            np.testing.assert_allclose(float(r[att + "_loss"]), float(loss),
                                       rtol=1e-5, err_msg=att)
            for name, w in new.items():
                np.testing.assert_allclose(r[f"{att}/{name}"], w, rtol=1e-5,
                                           atol=1e-7,
                                           err_msg=f"{att} {name}")


def test_the_jax_scripts_step_scales_the_gradient_by_the_world():
    """``examples/train_longcontext.py:144-160``: the loss sums over the
    mesh inside a ``check_vma=False`` ``shard_map``, whose transpose of
    that sum sums the cotangent again, and the gradients are summed over
    the mesh once more: ``dp · sp`` times the loss's gradient."""
    dp, sp = 1, 2
    args, cfg, toks, params, den = _jax_setup(dp, sp)
    mesh = jax_make_mesh(shape=(dp, sp), axis_names=("data", "seq"),
                         devices=jax.devices()[:dp * sp])
    model = JGPTLM(jgpt_config(**{**cfg.__dict__, "attention": "ring"}))
    l_local = args.seq // sp

    def spmd(p, t):
        off = lax.axis_index("seq") * l_local

        def loss_fn(p):
            logits = model.apply(p, t, position_offset=off)
            lp = jax.nn.log_softmax(logits[:, :-1], axis=-1)
            ll = jnp.take_along_axis(lp, t[:, 1:, None], axis=-1)[..., 0]
            return -lax.psum(ll.sum(), ("seq", "data")) / den

        g = jax.grad(loss_fn)(p)
        return jax.tree.map(lambda x: lax.psum(x, ("seq", "data")), g)

    g_script = jax.jit(jax.shard_map(
        spmd, mesh=mesh, in_specs=(JP(), JP("data", "seq")), out_specs=JP(),
        check_vma=False))(params, jnp.asarray(toks))
    g_true = jax.grad(_dense_loss(cfg, toks, sp, den))(params)
    for a, b in zip(jax.tree.leaves(g_script), jax.tree.leaves(g_true)):
        np.testing.assert_allclose(np.asarray(a), dp * sp * np.asarray(b),
                                   rtol=1e-4, atol=1e-6)


_MAINS = """
import json, sys
import torch
from pytorch_ps_mpi_tpu_torch import mesh, train_longcontext, train_tp

rank, world, port, dst = sys.argv[1:5]
rank, world = int(rank), int(world)
torch.set_num_threads(1)
mesh.initialize_distributed(f"tcp://localhost:{port}", world_size=world,
                            rank=rank, backend="gloo")
a = train_longcontext.main(["--dp", "2", "--sp", "2", "--seq", "64",
                            "--batch", "2", "--steps", "2",
                            "--attention", "ulysses"])
b = train_tp.main(["--dp", "2", "--tp", "2", "--steps", "3", "--mode",
                   "leader", "--optim", "adam", "--lr", "0.01"])
with open(f"{dst}.{rank}.json", "w") as f:
    json.dump({"lc": a, "tp": b}, f)
torch.distributed.destroy_process_group()
"""


def test_the_entry_points_run_at_world_4(tmp_path, monkeypatch):
    monkeypatch.setenv("PS_PLATFORM", "cpu")
    spawn_ranks(_MAINS, 4, [tmp_path / "out"])
    outs = [json.loads((tmp_path / f"out.{r}.json").read_text())
            for r in range(4)]
    for o in outs:
        assert o["lc"]["finite"] and o["tp"]["finite"]
        assert o["lc"]["losses"] == outs[0]["lc"]["losses"]
        assert o["tp"]["tp_leaves_sharded_over"] == "PartitionSpec('model')"
        assert o["tp"]["losses"][-1] < o["tp"]["losses"][0]


def _flags(path: Path) -> set:
    """The option strings of every ``add_argument`` call in a script,
    read from its source."""
    tree = ast.parse(path.read_text())
    return {a.value for node in ast.walk(tree)
            if isinstance(node, ast.Call)
            and getattr(node.func, "attr", "") == "add_argument"
            for a in node.args
            if isinstance(a, ast.Constant) and str(a.value).startswith("--")}


@pytest.mark.parametrize("script,module,extra", [
    ("train.py", "train", {"--accum-steps", "--norm"}),
    ("train_longcontext.py", "train_longcontext", set()),
    ("train_tp.py", "train_tp", set())])
def test_cli_flags_are_the_jax_scripts(script, module, extra):
    jax_flags = _flags(ROOT / "examples" / script)
    ours = _flags(ROOT / "pytorch_ps_mpi_tpu_torch" / f"{module}.py")
    assert ours == jax_flags | extra
    if module == "train":
        from pytorch_ps_mpi_tpu_torch import train

        assert "--donate" in jax_flags
        assert train.parser().parse_args(["--donate"]).donate

"""Every public signature of the JAX package's training entry points binds
to the port's counterpart (ROADMAP queue 3 item 14): ``MPI_PS``,
``step``, ``run_steps``, ``step_accumulate``, ``Trainer`` and
``CheckpointManager``, and of the model-parallel and long-context layers
(``ring_attention``, ``ulysses_attention``, ``GPTLM``, ``SwitchMLM``, the
``tp_*``, ``pipeline_*`` and ``moe_*`` functions). A JAX argument binds
to a port parameter of its own name. The JAX defaults then
run: ``donate_buffers`` and ``run_steps(unroll=)`` are no-ops,
``CheckpointManager(d, True)`` keeps three steps and ``compress=True``
round-trips through the native codec, and ``step_memory_analysis``
raises on the CPU with its reason."""

from __future__ import annotations

import inspect

import numpy as np
import pytest
import torch

from pytorch_ps_mpi_tpu import ps as jps
from pytorch_ps_mpi_tpu.trainer import Trainer as JTrainer
from pytorch_ps_mpi_tpu.utils.checkpoint import CheckpointManager as JCkpt
from pytorch_ps_mpi_tpu_torch import SGD, models
from pytorch_ps_mpi_tpu_torch import ps as tps
from pytorch_ps_mpi_tpu_torch.trainer import Trainer
from pytorch_ps_mpi_tpu_torch.utils.checkpoint import CheckpointManager

_MISSING = object()
PAIRS = [
    ("MPI_PS", jps.MPI_PS.__init__, tps.MPI_PS.__init__),
    ("step", jps.MPI_PS.step, tps.MPI_PS.step),
    ("run_steps", jps.MPI_PS.run_steps, tps.MPI_PS.run_steps),
    ("step_accumulate", jps.MPI_PS.step_accumulate,
     tps.MPI_PS.step_accumulate),
    ("step_memory_analysis", jps.MPI_PS.step_memory_analysis,
     tps.MPI_PS.step_memory_analysis),
    ("Trainer", JTrainer.__init__, Trainer.__init__),
    ("CheckpointManager", JCkpt.__init__, CheckpointManager.__init__),
]


def _jax_call(fn):
    """The JAX signature's arguments, each passed as the JAX caller may:
    positional ones by position, keyword-only ones by name, every one at
    its default (or a placeholder where it has none)."""
    pos, kw = [], {}
    for p in list(inspect.signature(fn).parameters.values())[1:]:
        value = _MISSING if p.default is p.empty else p.default
        if p.kind is p.POSITIONAL_OR_KEYWORD:
            pos.append(value)
        elif p.kind is p.KEYWORD_ONLY:
            kw[p.name] = value
    return pos, kw


@pytest.mark.parametrize("name,jfn,tfn", PAIRS, ids=[p[0] for p in PAIRS])
def test_jax_signature_binds_to_the_port(name, jfn, tfn):
    pos, kw = _jax_call(jfn)
    bound = inspect.signature(tfn).bind(None, *pos, **kw)
    tparams = inspect.signature(tfn).parameters
    jnames = list(inspect.signature(jfn).parameters)[1:]
    for jname in jnames:
        # every option is the port's own parameter, none lands in **hyper
        assert jname in tparams, jname
    # positional arguments land on the same names
    tpos = [n for n, p in list(tparams.items())[1:]
            if p.kind is p.POSITIONAL_OR_KEYWORD]
    jpos = [n for n, p in list(inspect.signature(jfn).parameters.items())[1:]
            if p.kind is p.POSITIONAL_OR_KEYWORD]
    assert tpos[:len(jpos)] == jpos
    assert bound.arguments


def _layer_pairs():
    from pytorch_ps_mpi_tpu.models import GPTLM as JGPTLM
    from pytorch_ps_mpi_tpu.models.moe import SwitchMLM as JSwitchMLM
    from pytorch_ps_mpi_tpu.parallel import ep as jep
    from pytorch_ps_mpi_tpu.parallel import pp as jpp
    from pytorch_ps_mpi_tpu.parallel import ring as jring
    from pytorch_ps_mpi_tpu.parallel import tp as jtp
    from pytorch_ps_mpi_tpu.parallel import ulysses as jul
    from pytorch_ps_mpi_tpu_torch.models.gpt import GPTLM
    from pytorch_ps_mpi_tpu_torch.models.moe import SwitchMLM
    from pytorch_ps_mpi_tpu_torch.parallel import ep, pp, ring, tp, ulysses

    pairs = [("ring_attention", jring.ring_attention, ring.ring_attention),
             ("ulysses_attention", jul.ulysses_attention,
              ulysses.ulysses_attention),
             ("GPTLM", JGPTLM, GPTLM), ("GPTLM.__call__", JGPTLM.__call__,
                                         GPTLM.forward),
             ("SwitchMLM", JSwitchMLM, SwitchMLM),
             ("SwitchMLM.__call__", JSwitchMLM.__call__, SwitchMLM.forward)]
    for mod, jmod, names in (
            (tp, jtp, ("column_parallel", "row_parallel", "tp_mlp",
                       "tp_self_attention", "init_tp_mlp",
                       "init_tp_attention", "tp_param_spec",
                       "dense_equivalent_mlp", "dense_equivalent_attention")),
            (pp, jpp, ("pipeline_apply", "pipeline_loss", "init_stage_stack",
                       "stage_spec")),
            (ep, jep, ("moe_apply", "load_balance_loss", "moe_dense_oracle",
                       "init_moe", "moe_spec"))):
        pairs += [(n, getattr(jmod, n), getattr(mod, n)) for n in names]
    return pairs


#: flax's own constructor fields, not the model's
_FLAX_FIELDS = ("parent", "name")


@pytest.mark.parametrize("name,jfn,tfn", _layer_pairs(),
                         ids=[p[0] for p in _layer_pairs()])
def test_jax_layer_signature_binds_to_the_port(name, jfn, tfn):
    jsig, tsig = inspect.signature(jfn), inspect.signature(tfn)
    jparams = [p for p in jsig.parameters.values()
               if p.name not in _FLAX_FIELDS + ("self",)]
    tparams = {n: p for n, p in tsig.parameters.items() if n != "self"}
    pos = [_MISSING for p in jparams if p.kind is p.POSITIONAL_OR_KEYWORD]
    kw = {p.name: (_MISSING if p.default is p.empty else p.default)
          for p in jparams if p.kind is p.KEYWORD_ONLY}
    args = ([None] if "self" in tsig.parameters else []) + pos
    tsig.bind(*args, **kw)
    for p in jparams:
        assert p.name in tparams, p.name
        q = tparams[p.name]
        # the same kind, and the JAX default where the JAX one has one
        assert q.kind is p.kind, p.name
        if p.default is not p.empty and isinstance(p.default,
                                                   (int, float, str, bool)):
            assert q.default == p.default, p.name
    jpos = [p.name for p in jparams if p.kind is p.POSITIONAL_OR_KEYWORD]
    tpos = [n for n, q in tparams.items()
            if q.kind is q.POSITIONAL_OR_KEYWORD]
    assert tpos[:len(jpos)] == jpos


def _mlp():
    return models.MLP(features=(16, 4), in_features=8, device="cpu")


def _loss(model):
    def loss_fn(params, batch):
        x, y = batch
        out = torch.func.functional_call(model, params, (x,))
        return torch.mean((out - y) ** 2)
    return loss_fn


@pytest.mark.parametrize("donate", [False, True])
def test_mpi_ps_takes_every_jax_default(donate):
    _, kw = _jax_call(jps.MPI_PS.__init__)
    kw["donate_buffers"] = donate
    model = _mlp()
    opt = SGD(model, device="cpu", lr=0.1,
              **{k: v for k, v in kw.items() if k != "optim"})
    x, y = torch.randn(3, 4, 8), torch.randn(3, 4, 4)
    losses, data = opt.run_steps(_loss(model), (x, y), unroll=2)
    assert losses.shape == (3,) and data["n_steps"] == 3.0
    assert bool(torch.isfinite(losses).all())


def test_run_steps_unroll_is_a_no_op():
    a, b = _mlp(), _mlp()
    oa, ob = SGD(a, device="cpu", lr=0.1), SGD(b, device="cpu", lr=0.1)
    x, y = torch.randn(4, 4, 8), torch.randn(4, 4, 4)
    la, _ = oa.run_steps(_loss(a), (x, y))
    lb, _ = ob.run_steps(_loss(b), (x, y), unroll=4)
    torch.testing.assert_close(la, lb, rtol=0, atol=0)
    for p, q in zip(a.parameters(), b.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0)


def test_step_memory_analysis_names_its_reason_on_the_cpu():
    model = _mlp()
    opt = SGD(model, device="cpu", lr=0.1)
    with pytest.raises(NotImplementedError, match="max_memory_allocated"):
        opt.step_memory_analysis(_loss(model),
                                 (torch.randn(4, 8), torch.randn(4, 4)))


def test_checkpoint_manager_positional_order_keeps_three(tmp_path):
    mgr = CheckpointManager(str(tmp_path), True)
    assert mgr.max_to_keep == 3 and mgr.compress and not mgr.use_orbax
    for step in range(1, 5):
        mgr.save(step, {"w": torch.full((3,), float(step))})
    assert mgr.steps() == [2, 3, 4]
    jmgr = JCkpt(str(tmp_path / "jax"), False)
    for step in range(1, 5):
        jmgr.save(step, {"w": np.full((3,), float(step), np.float32)})
    assert jmgr._numpy_steps() == mgr.steps()


@pytest.mark.parametrize("compress", [True, False])
def test_compress_round_trips(tmp_path, compress):
    mgr = CheckpointManager(str(tmp_path), compress=compress)
    state = {"params": {"w": torch.randn(64, 32),
                        "b": torch.zeros(32, dtype=torch.bfloat16)},
             "count": torch.tensor(3, dtype=torch.int64), "step": 7,
             "empty": torch.zeros(0), "flags": torch.tensor([True, False])}
    mgr.save(1, state)
    back = mgr.restore(state)
    for k in ("count", "empty", "flags"):
        assert torch.equal(back[k], state[k]) and back[k].dtype == \
            state[k].dtype
    assert torch.equal(back["params"]["w"], state["params"]["w"])
    assert torch.equal(back["params"]["b"], state["params"]["b"])
    assert back["step"] == 7
    raw = torch.load(mgr._path(1), weights_only=True)
    assert isinstance(raw["params"]["b"], dict) == compress
    # a file saved either way restores either way
    other = CheckpointManager(str(tmp_path), compress=not compress)
    assert torch.equal(other.restore(state)["params"]["w"],
                       state["params"]["w"])

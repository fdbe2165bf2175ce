"""Each plain reference against the port at tiny widths on the CPU: the
models' logits, loss and gradients, TernGrad's draws and decode, error
feedback around top-k, Adam and SGD."""

import pytest
import torch

from portbench.harness import program
from portbench.reference import bert as ref_bert
from portbench.reference import ef as ref_ef
from portbench.reference import resnet as ref_resnet
from portbench.reference import terngrad as ref_tern
from portbench.reference.adam import Reference as RefAdam
from portbench.reference.sgd import Reference as RefSGD
from portbench.tests import tiny


def _loaded(cell, seed):
    """The port's model with the benchmark's weights, and the weights."""
    model = cell.family.program_model(cell.cfg, "cpu")
    w = program.weights(cell, seed, "cpu")
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(w[k])
    return model, w


@pytest.mark.parametrize("workload", ["bert-base-mlm.identity.b32",
                                      "resnet50-gn-imagenet.identity.b128"])
def test_model_loss_and_grads(workload):
    cell = tiny.cell(workload)
    model, w = _loaded(cell, 7)
    batch = program.batches(cell, 7, "cpu")[0]
    params = {k: p.detach().requires_grad_() for k, p in
              model.named_parameters()}
    loss = cell.family.program_loss(model)(params, batch)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    want, want_g = cell.family.reference_loss_and_grads(cell.cfg, w, batch)
    torch.testing.assert_close(loss, want, rtol=1e-5, atol=1e-6)
    for k, g in grads.items():
        torch.testing.assert_close(g, want_g[k], rtol=1e-4, atol=1e-7)


def test_bert_logits():
    cell = tiny.cell("bert-base-mlm.identity.b32")
    model, w = _loaded(cell, 3)
    tokens = program.batches(cell, 3, "cpu")[1]["tokens"]
    with torch.no_grad():
        torch.testing.assert_close(model(tokens),
                                   ref_bert.logits(w, tokens, cell.cfg),
                                   rtol=1e-5, atol=1e-5)


def test_resnet_logits():
    cell = tiny.cell("resnet50-gn-imagenet.identity.b128")
    model, w = _loaded(cell, 3)
    images = program.batches(cell, 3, "cpu")[1]["images"]
    with torch.no_grad():
        torch.testing.assert_close(model(images),
                                   ref_resnet.logits(w, images, cell.cfg),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [1024, 1000, 4096 + 512, 4096 + 100])
def test_terngrad_draws_and_decode(n):
    from pytorch_ps_mpi_tpu_torch.codecs import get_codec

    args = {"use_pallas": True, "scan_block": 512, "scan_threshold": 2048}
    code = get_codec("terngrad", **args)
    g = torch.randn(n, generator=torch.Generator().manual_seed(n)) * 1e-3
    seed = 12345
    gen = torch.Generator().manual_seed(seed * 1_000_003)
    payload, _ = code.encode(g, (), gen)
    got = code.decode_sum({k: v[None] for k, v in payload.items()}, (n,),
                          torch.float32)
    want = ref_tern.Reference(args, 0, seed, "cpu").ternarize(g)
    assert torch.equal(got, want)


def test_terngrad_buckets_follow_the_plan():
    """A bucketed Adam step's first moment against the reference's
    buckets, draws and update."""
    from pytorch_ps_mpi_tpu_torch import Adam
    from pytorch_ps_mpi_tpu_torch.codecs import get_codec

    gen = torch.Generator().manual_seed(0)
    shapes = [(64, 8), (100,), (512,), (16, 32), (7,), (1024,)]
    params = {f"p{i}": torch.randn(s, generator=gen)
              for i, s in enumerate(shapes)}
    grads = {k: torch.randn(p.shape, generator=gen) for k, p in params.items()}
    opt = Adam({k: p.clone() for k, p in params.items()}, lr=1e-3,
               code=get_codec("terngrad", use_pallas=True), bucket_mb=0.002,
               seed=99, device="cpu")
    opt.step(grads={k: g[None] for k, g in grads.items()})
    agg = ref_tern.Reference({"use_pallas": True}, 0.002, 99,
                             "cpu").aggregate(grads)
    for k in params:
        torch.testing.assert_close(opt.opt_state.exp_avg[k], 0.1 * agg[k],
                                   rtol=1e-6, atol=0)


def test_error_feedback_topk():
    from pytorch_ps_mpi_tpu_torch.codecs import get_codec

    code = get_codec("ef", inner_name="topk", fraction=0.01, pallas=True)
    ref = ref_ef.Reference({"inner_name": "topk", "fraction": 0.01}, 0, 0,
                           "cpu")
    gen = torch.Generator().manual_seed(1)
    state = code.init_state((64, 300), torch.float32, "cpu")
    for _ in range(3):
        g = torch.randn(64, 300, generator=gen)
        payload, state = code.encode(g, state)
        got = code.decode_sum({k: v[None] for k, v in payload.items()},
                              (64, 300), torch.float32)
        want = ref.aggregate({"w": g})["w"]
        assert torch.equal(got, want)
        assert torch.equal(state["memory"], ref.memory["w"])


def _pair(seed=0):
    gen = torch.Generator().manual_seed(seed)
    params = {"a": torch.randn(40, 3, generator=gen),
              "b": torch.randn(11, generator=gen)}
    grads = [{k: torch.randn(p.shape, generator=gen) for k, p in
              params.items()} for _ in range(3)]
    return params, grads


def test_adam():
    from pytorch_ps_mpi_tpu_torch.optim import (AdamHyper, adam_update,
                                                init_adam_state)

    params, grads = _pair()
    mine = {k: p.clone() for k, p in params.items()}
    state, hyper = init_adam_state(mine), AdamHyper(lr=1e-2)
    ref_p = {k: p.clone() for k, p in params.items()}
    ref = RefAdam(ref_p, {"lr": 1e-2})
    for g in grads:
        mine, state = adam_update(mine, g, state, hyper)
        ref.step(ref_p, g)
    # the port takes the step size in float32, the reference in float64:
    # a few ulps of a parameter of magnitude up to 4
    for k in params:
        torch.testing.assert_close(mine[k], ref_p[k], rtol=1e-6, atol=1e-6)


def test_sgd_momentum():
    from pytorch_ps_mpi_tpu_torch.optim import (SGDHyper, init_sgd_state,
                                                sgd_update)

    params, grads = _pair(1)
    mine = {k: p.clone() for k, p in params.items()}
    state, hyper = init_sgd_state(mine), SGDHyper(lr=0.1, momentum=0.9)
    ref_p = {k: p.clone() for k, p in params.items()}
    ref = RefSGD(ref_p, {"lr": 0.1, "momentum": 0.9})
    for g in grads:
        mine, state = sgd_update(mine, g, state, hyper)
        ref.step(ref_p, g)
    for k in params:
        torch.testing.assert_close(mine[k], ref_p[k], rtol=1e-6, atol=1e-7)

"""The port's profiler layer (``utils/tracing.py``): the split and overlap
arithmetic against the JAX package's on the same ``(device, name,
start_ns, dur_ns)`` rows, the off-card answers, ``annotate``, and the
short-trace guard behind ``step(profile=True)``: a retaken step starts
every take from the state the step began with, and a trace that stays
short fails."""

from __future__ import annotations

import contextlib
from types import SimpleNamespace

import pytest
import torch

import jax.numpy as jnp

from pytorch_ps_mpi_tpu.utils import tracing as jtracing
from pytorch_ps_mpi_tpu_torch import SGD, Adam
from pytorch_ps_mpi_tpu_torch import comms
from pytorch_ps_mpi_tpu_torch.utils import tracing
from torch_parity import mlp_pair, stacked_grads, torch_grads

#: rows of two cards: each runs the same all-reduce, partly under compute
TWO_CARDS = [
    (0, "sign_encode_kernel", 0.0, 4e3),
    (0, "ncclDevKernel_AllReduce_Sum_f32_RING_LL", 2e3, 6e3),
    (0, "sign_unpack_sum_kernel", 7e3, 3e3),
    (0, "sm90_xmma_gemm_f32f32", 12e3, 5e3),
    (1, "sign_encode_kernel", 1e3, 4.5e3),
    (1, "ncclDevKernel_AllReduce_Sum_f32_RING_LL", 3e3, 5e3),
    (1, "sign_unpack_sum_kernel", 9e3, 2e3),
    (1, "Memcpy DtoH (Device -> Pinned)", 11e3, 1e3),
]
#: one card, no collective, more kernel names than the JAX list keeps
ONE_CARD = [(0, f"kernel_{i}", 100.0 * i, 10.0 * (i + 1)) for i in range(11)]

SPLIT_KEYS = ("devices", "device_busy_s", "comm_s", "compute_s")


def _jax_on_rows(monkeypatch, rows, fn):
    """The JAX package's ``fn`` with its trace reader answering ``rows``."""
    monkeypatch.setattr(jtracing, "_iter_hlo_events",
                        lambda _d: iter(list(rows)))
    return fn(lambda: jnp.ones(3) + 1)[1]


@pytest.mark.parametrize("rows", [TWO_CARDS, ONE_CARD, []],
                         ids=["two_cards", "one_card", "empty"])
def test_split_and_overlap_match_jax_on_the_same_rows(monkeypatch, rows):
    want = _jax_on_rows(monkeypatch, rows, jtracing.profiled_device_split)
    got = tracing.device_split(rows)
    assert {k: got[k] for k in SPLIT_KEYS} == pytest.approx(
        {k: want[k] for k in SPLIT_KEYS}, rel=1e-12, abs=0.0)
    # the JAX list stops at eight; the port keeps every kernel
    assert got["top_ops"][:8] == pytest.approx(want["top_ops"])
    assert len(got["top_ops"]) == len({name for _, name, _, _ in rows})
    want = _jax_on_rows(monkeypatch, rows, jtracing.profiled_overlap)
    got = tracing.overlap_split(rows)
    assert set(got) == set(want)
    assert got == pytest.approx(want, rel=1e-12, abs=0.0)


@pytest.mark.parametrize("intervals", [
    [], [(0.0, 1.0)], [(3.0, 5.0), (0.0, 1.0), (0.5, 2.0), (5.0, 6.0)],
    [(0.0, 10.0), (2.0, 3.0), (9.0, 12.0), (20.0, 21.0)],
], ids=["none", "one", "touching", "nested"])
def test_interval_helpers_match_jax(intervals):
    got = tracing._interval_union(intervals)
    assert got == jtracing._interval_union(intervals)
    other = tracing._interval_union([(0.75, 2.5), (5.5, 30.0)])
    assert tracing._interval_intersection_len(got, other) == \
        jtracing._interval_intersection_len(got, other)


def test_off_card_answers_carry_the_jax_keys():
    out, split = tracing.profiled_overlap(lambda: 7)
    _, jsplit = jtracing.profiled_overlap(lambda: jnp.ones(3) + 1)
    assert out == 7 and set(split) == set(jsplit)
    assert split["devices"] == 0 and split["overlap_frac"] == 0.0
    out, split = tracing.profiled_device_split(lambda: 8)
    assert out == 8 and split == {"devices": 0, "device_busy_s": 0.0,
                                  "comm_s": 0.0, "compute_s": 0.0,
                                  "top_ops": []}
    assert tracing.device_memory_stats() is None


def test_annotate_names_a_region_in_the_trace():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.annotate("ps.encode"):
            torch.ones(3).add_(1)
    assert "ps.encode" in {e.name for e in prof.events()}


def _fake_card(monkeypatch, wholes) -> list:
    """Make the guard take the card's path on the CPU, each take whole or
    short as ``wholes`` says; returns the takes seen."""
    takes, seen = iter(wholes), []

    def trace_rows(_prof):
        whole = next(takes)
        seen.append(whole)
        row = SimpleNamespace(device_index=0, name="sign_encode_kernel",
                              time_range=SimpleNamespace(start=0.0,
                                                         end=1.0))
        return ([row] if whole else []), 1

    monkeypatch.setattr(tracing, "on_card", lambda _device: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *_a: None)
    monkeypatch.setattr(tracing, "open_trace",
                        lambda *_a: contextlib.nullcontext())
    monkeypatch.setattr(tracing, "trace_rows", trace_rows)
    return seen


def _state_tensors(opt) -> list:
    out = []
    comms.tree_map(lambda t: out.append(t) if torch.is_tensor(t) else None,
                   (opt.params, tuple(opt.opt_state), opt.codec_state))
    return out


@pytest.mark.parametrize("make", [
    lambda m: SGD(m, device="cpu", lr=0.1, momentum=0.9),
    lambda m: Adam(m, device="cpu", lr=1e-2),
], ids=["sgd_momentum", "adam"])
def test_retaken_profiled_step_starts_each_take_from_the_step_state(
        monkeypatch, make):
    """Two short takes, then a whole one: the state after the profiled
    step equals that of one plain step bit for bit (the optimizer steps
    its moments in place, so a take must never start from a state that an
    earlier take advanced)."""
    variables, model_a = mlp_pair()
    _, model_b = mlp_pair()
    opt_a, opt_b = make(model_a), make(model_b)
    for step in range(2):  # the moments are no longer zero
        grads = stacked_grads(variables, 1, step)
        opt_a.step(grads=torch_grads(model_a, grads))
        opt_b.step(grads=torch_grads(model_b, grads))
    grads = stacked_grads(variables, 1, 2)
    opt_b.step(grads=torch_grads(model_b, grads))
    seen = _fake_card(monkeypatch, [False, False, True])
    _, data = opt_a.step(grads=torch_grads(model_a, grads), profile=True)
    assert seen == [False, False, True]
    assert data["profile_devices"] == 1.0
    assert opt_a.profile_split["takes"] == 3
    assert opt_a._step_count == opt_b._step_count == 3
    ta, tb = _state_tensors(opt_a), _state_tensors(opt_b)
    assert len(ta) == len(tb) and len(ta) > len(list(model_a.parameters()))
    for a, b in zip(ta, tb):
        assert torch.equal(a, b)


def test_trace_short_on_every_take_fails(monkeypatch):
    variables, model = mlp_pair()
    opt = SGD(model, device="cpu", lr=0.1, momentum=0.9)
    seen = _fake_card(monkeypatch, [False] * tracing.TAKES)
    with pytest.raises(tracing.ShortTraceError):
        opt.step(grads=torch_grads(model, stacked_grads(variables, 1, 0)),
                 profile=True)
    assert seen == [False] * tracing.TAKES

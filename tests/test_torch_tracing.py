"""The port's profiler layer (``utils/tracing.py``): the split and overlap
arithmetic against the JAX package's on the same ``(device, name,
start_ns, dur_ns)`` rows, the off-card answers, ``annotate``, the
short-trace guard behind ``step(profile=True)`` (a retaken step starts
every take from the state the step began with, and a trace that stays
short fails), the stage spans of ``MPI_PS.step`` in the profiler and the
flight recorder, and the merged timeline's device rows placed by them."""

from __future__ import annotations

import contextlib
import json
from types import SimpleNamespace

import pytest
import torch

import jax.numpy as jnp

from pytorch_ps_mpi_tpu.utils import tracing as jtracing
from pytorch_ps_mpi_tpu_torch import SGD, Adam
from pytorch_ps_mpi_tpu_torch import comms
from pytorch_ps_mpi_tpu_torch.codecs import get_codec
from pytorch_ps_mpi_tpu_torch.models import MLP
from pytorch_ps_mpi_tpu_torch.telemetry import recorder as trec
from pytorch_ps_mpi_tpu_torch.telemetry import trace_export as ttel
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


# -- the stage spans of MPI_PS.step -------------------------------------------

#: the stages of every step, in the order they run
STAGES = ("ps.grad", "ps.aggregate", "ps.update", "ps.wait")


def _mlp_loss(model):
    def loss_fn(params, batch):
        x, y = batch
        out = torch.func.functional_call(model, params, (x,))
        return torch.nn.functional.cross_entropy(out, y)
    return loss_fn


def _batch(seed: int, lead=()):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(*lead, 4, 8, generator=g),
            torch.randint(0, 3, (*lead, 4), generator=g))


#: ``name -> (optimizer kwargs, accumulate)``: per leaf and bucketed, a
#: psum and a gather codec, leader mode, step_accumulate, the staged path
SPAN_CASES = {
    "per_leaf_gather": (dict(code="int8"), False),
    "bucket_mb": (dict(code="sign", bucket_mb=0.001), False),
    "psum": (dict(code="identity"), False),
    "gather": (dict(code="terngrad"), False),
    "leader": (dict(code="int8", mode="leader"), False),
    "leader_psum": (dict(code="identity", mode="leader",
                         clip_norm=1.0), False),
    "accumulate": (dict(code="identity"), True),
    "instrument": (dict(code="int8", instrument=True), False),
    "numerics": (dict(code="sign", numerics=True), False),
}


def _spanned_step(case: str):
    """One step of a tiny MLP under the CPU profiler: the program's span
    ranges ``(name, start, end)``, in start order."""
    from torch.profiler import ProfilerActivity, profile

    kw, accumulate = SPAN_CASES[case]
    model = MLP(features=(16, 3), in_features=8, device="cpu")
    kw = dict(kw, code=get_codec(kw["code"]))
    opt = Adam(model, device="cpu", lr=1e-2, **kw)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if accumulate:
            opt.step_accumulate(_mlp_loss(model), _batch(1, (2,)))
        else:
            opt.step(loss_fn=_mlp_loss(model), batch=_batch(1))
    return sorted((e.name, e.time_range.start, e.time_range.end)
                  for e in prof.events() if e.name in tracing.STEP_SPANS)


@pytest.mark.parametrize("case", list(SPAN_CASES))
def test_step_spans_nest_in_order(case):
    """``ps.step`` holds each stage once, in the order the stages run,
    none overlapping the next; ``ps.numerics`` only with
    ``numerics=True``."""
    got = _spanned_step(case)
    names = [n for n, _, _ in got]
    assert names.count("ps.step") == 1
    (_, s0, e0), = [g for g in got if g[0] == "ps.step"]
    stages = [g for g in sorted(got, key=lambda g: g[1])
              if g[0] in STAGES]
    assert [n for n, _, _ in stages] == list(STAGES)
    for (_, _, end), (_, start, _) in zip(stages, stages[1:]):
        assert end <= start
    numerics = [g for g in got if g[0] == "ps.numerics"]
    assert bool(numerics) == (case == "numerics")
    for _, s, e in got:
        assert s0 <= s <= e <= e0


def test_spans_enter_no_record_function_when_off(monkeypatch):
    """With neither the profiler nor a recorder on, a step enters no
    ``record_function``; under the profiler it enters one a span."""
    from torch.profiler import ProfilerActivity, profile

    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    assert trec.get_recorder() is None
    model = MLP(features=(16, 3), in_features=8, device="cpu")
    opt = SGD(model, device="cpu", lr=0.1)
    opt.step(loss_fn=_mlp_loss(model), batch=_batch(2))
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        opt.step(loss_fn=_mlp_loss(model), batch=_batch(3))
    assert entered == ["ps.step", *STAGES[:-1], "ps.wait"]


def test_spans_off_cost_little():
    """One step's span calls, with neither the profiler nor a recorder
    on, take well under 20 µs on the host (the fastest of many tries)."""
    import time

    def one_step():
        for name in tracing.STEP_SPANS:
            with tracing.annotate(name, 1):
                pass

    best = min(_timed(one_step, time.perf_counter) for _ in range(200))
    assert best < 20e-6


def _timed(fn, timer) -> float:
    t0 = timer()
    fn()
    return timer() - t0


@pytest.mark.parametrize("accumulate", [False, True],
                         ids=["step", "step_accumulate"])
def test_stage_spans_land_in_the_recorder(accumulate):
    """With a recorder installed every stage is a span of it carrying the
    step's number, inside that step's row."""
    rec = trec.configure()
    try:
        model = MLP(features=(16, 3), in_features=8, device="cpu")
        opt = SGD(model, device="cpu", lr=0.1, code=get_codec("int8"),
                  numerics=True)
        for i in range(2):
            if accumulate:
                opt.step_accumulate(_mlp_loss(model), _batch(i, (2,)))
            else:
                opt.step(loss_fn=_mlp_loss(model), batch=_batch(i))
    finally:
        trec.disable()
    rows = rec.events()
    whole = "ps.step_accumulate" if accumulate else "ps.step"
    steps = {r["step"]: r for r in rows if r["name"] == whole}
    assert sorted(steps) == [1, 2]
    assert not [r for r in rows if r["name"] == "ps.step" and accumulate]
    for n in (1, 2):
        mine = [r for r in rows if r.get("step") == n
                and r["name"] != whole]
        assert sorted({r["name"] for r in mine}) == sorted(
            STAGES + ("ps.numerics",))
        row = steps[n]
        for r in mine:
            assert r["kind"] == "span"
            assert row["ts"] <= r["ts"]
            assert r["ts"] + r["dur"] <= row["ts"] + row["dur"]


def test_device_rows_land_in_the_stage_span_that_launched_them(tmp_path):
    """A profiler trace whose clock is 1234.5 s off the wall clock, of
    the last three of five steps: placed by its ``ps.step`` ranges, every
    kernel lies inside the recorder's span of the stage that launched it,
    though ``device_t0_wall`` is wrong by a second."""
    offset, t0_wall = 1234.5, 1_700_000_000.0
    trace, host = [], []
    start_us = 1e6  # the profiler's clock
    for step, dur_us in enumerate((15e3, 17e3, 14e3, 19e3, 16e3), 1):
        start_us += 2 * dur_us
        wall = start_us / 1e6 + offset - 3e-6 * step  # a few µs apart
        host.append({"name": "ps.step", "kind": "span", "wall": wall,
                     "dur": dur_us / 1e6, "step": step, "worker": 0})
        if step >= 3:
            trace.append({"ph": "X", "cat": "user_annotation",
                          "name": "ps.step", "ts": start_us, "dur": dur_us})
        third = dur_us / 3
        for i, stage in enumerate(STAGES[:-1]):
            s_us = start_us + i * third
            host.append({"name": stage, "kind": "span",
                         "wall": s_us / 1e6 + offset, "dur": third / 1e6,
                         "step": step, "worker": 0})
            if step >= 3:
                trace.append({"ph": "X", "cat": "kernel",
                              "name": f"{stage}_kernel_{step}",
                              "ts": s_us + 100.0, "dur": third - 200.0,
                              "args": {"device": 0}})
    host.append({"name": "first", "kind": "event", "wall": t0_wall})
    d = tmp_path / "device-trace"
    d.mkdir()
    (d / "trace-1.json").write_text(json.dumps({"traceEvents": trace}))
    steps = [(e["ts"], e["dur"]) for e in trace
             if e["name"] == "ps.step"]
    assert ttel.step_clock_offset(steps, host) == pytest.approx(
        offset - 4 * 3e-6, abs=1e-9)
    out = ttel.merged_trace_events(host, device_trace_dir=str(d),
                                   device_t0_wall=t0_wall + 1.0)
    spans = {(e["args"]["step"], e["name"]): e for e in out
             if e.get("cat") == "host" and e["ph"] == "X"}
    kernels = [e for e in out if e.get("cat") == "device"
               and e["ph"] == "X"]
    assert len(kernels) == 9
    for k in kernels:
        stage, step = k["name"].rsplit("_kernel_", 1)
        span = spans[(int(step), stage)]
        assert span["ts"] <= k["ts"]
        assert k["ts"] + k["dur"] <= span["ts"] + span["dur"]

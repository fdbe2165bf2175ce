"""The readers of the program's stage spans (``harness/spans.py``,
``metrics/idle_ms.*`` and ``metrics/launch_calls.*``) on synthetic
profiled stretches, and the names they freeze against the program's."""

import random
from types import SimpleNamespace

import pytest

from portbench.harness import spans, spec

IDLE = ("idle_ms.grad", "idle_ms.codec", "idle_ms.update", "idle_ms.entry")
CALLS = ("launch_calls.grad", "launch_calls.codec", "launch_calls.update")


def _stretch():
    """Two steps in a window of 0–2,000 µs, each: grad 0–500 (backward's
    calls on another thread's events, inside it), aggregate 500–700,
    update 700–900 with a numerics range inside, wait 900–950; the card
    busy 100–450, 520–560, 600–650 and 720–990 of each step."""
    host, busy = [], []
    for k in range(2):
        t = 1000.0 * k
        host += [("ps.step", t, t + 960), ("ps.grad", t, t + 500),
                 ("ps.aggregate", t + 500, t + 700),
                 ("ps.update", t + 700, t + 900),
                 ("ps.numerics", t + 850, t + 880),
                 ("ps.wait", t + 900, t + 950),
                 ("aten::mm", t + 10, t + 20)]
        host += [("cudaLaunchKernel", t + 10 + i, t + 11 + i)
                 for i in range(5)]
        host += [("cuLaunchKernel", t + 510, t + 511),
                 ("cudaMemsetAsync", t + 520, t + 521),
                 ("cudaMemcpyAsync", t + 690, t + 699),
                 ("cudaLaunchKernel", t + 710, t + 711),
                 ("cudaLaunchKernel", t + 720, t + 721),
                 ("cudaStreamSynchronize", t + 910, t + 940),
                 ("cudaLaunchKernel", t + 960, t + 961)]
        busy += [(t + 100, t + 450), (t + 520, t + 560), (t + 600, t + 650),
                 (t + 720, t + 990)]
    return {"spans": host, "busy": busy, "window": (0.0, 2000.0),
            "busy_s": sum(e - s for s, e in busy) / 1e6,
            "window_s": 2000.0 / 1e6, "steps": 2}


def _read(name, tr):
    ctx = SimpleNamespace(trace=tr)
    return spec.reader(name).read(ctx)


def test_known_stretch_gives_known_numbers():
    tr = _stretch()
    # idle a step in µs: grad 0-100, 450-500; aggregate 500-520, 560-600,
    # 650-700; update 700-720; entry 990-1000
    want = {"idle_ms.grad": 0.15, "idle_ms.codec": 0.11,
            "idle_ms.update": 0.02, "idle_ms.entry": 0.01,
            "launch_calls.grad": 5.0, "launch_calls.codec": 3.0,
            "launch_calls.update": 2.0}
    got = {name: _read(name, tr) for name in want}
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("seed", range(8))
def test_the_idle_metrics_sum_to_the_stretch_idle(seed):
    """Overlapping, nested and cut-off ranges, rows anywhere: the four
    idle metrics, times the steps, are the window less the busy time."""
    rng = random.Random(seed)
    w0, w1 = 50.0, 5050.0

    def iv(n):
        out = []
        for _ in range(n):
            s = rng.uniform(0.0, 5100.0)
            out.append((s, s + rng.uniform(1.0, 600.0)))
        return out

    host = [(rng.choice(("ps.grad", "ps.aggregate", "ps.update",
                         "ps.wait", "aten::add")), s, e)
            for s, e in iv(40)]
    host += [("cudaLaunchKernel", s, e) for s, e in iv(30)]
    from portbench.harness.trace import _union

    busy = _union([(max(s, w0), min(e, w1)) for s, e in iv(25)
                   if e > w0 and s < w1])
    steps = rng.randint(1, 5)
    tr = {"spans": [h for h in host if w0 <= h[1] <= w1], "busy": busy,
          "window": (w0, w1), "steps": steps,
          "busy_s": sum(e - s for s, e in busy) / 1e6,
          "window_s": (w1 - w0) / 1e6}
    idle = sum(_read(name, tr) for name in IDLE) * steps / 1e3
    assert idle == pytest.approx(tr["window_s"] - tr["busy_s"],
                                 rel=1e-9, abs=1e-12)
    launched = sum(1 for n, s, _ in tr["spans"] if n == "cudaLaunchKernel")
    parts = sum(_read(name, tr) for name in CALLS) * steps
    parts += spans.launch_calls(tr, spans.ENTRY) * steps
    assert parts == pytest.approx(launched)


@pytest.mark.parametrize("name", IDLE + CALLS)
def test_nothing_to_read_gives_nothing(name):
    assert _read(name, None) is None
    tr = _stretch()
    tr["spans"] = [h for h in tr["spans"] if not h[0].startswith("ps.")]
    assert _read(name, tr) is None


def test_the_frozen_names_are_the_programs():
    from pytorch_ps_mpi_tpu_torch.utils import tracing

    assert spans.STEP_SPANS == tracing.STEP_SPANS
    assert spans.LAUNCH_CALLS == tracing.LAUNCH_CALLS
    assert set(spans.STAGES.values()) < set(spans.STEP_SPANS)


def test_every_reader_is_registered():
    per_layer = {m["name"]: m for m in spec.benchmark()["per_layer"]}
    codec = ["bert-base-mlm.terngrad.b32",
             "resnet50-gn-imagenet.eftopk.b128"]
    for name in IDLE + CALLS:
        m = per_layer[name]
        assert m["source"] == "program_span"
        assert m["moves"] == "train_samples_per_s"
        assert m.get("workloads", codec) == codec or "codec" not in name
        assert ("workloads" in m) == ("codec" in name)

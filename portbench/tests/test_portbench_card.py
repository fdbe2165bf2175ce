"""On the card: a traced run of cut-down BERT and ResNet cells gives
every per-layer metric its cells list (the codecs' rooflines where the
tiny plans give their kernels a unit), each share of a roofline or of
the peak in (0, 105], and a device busy time inside the traced window.

    python -m pytest -p no:cacheprovider -m cuda portbench/tests
"""

import time

import pytest
import torch

from portbench.harness import measure
from portbench.tests import tiny

pytestmark = pytest.mark.cuda

LOOSE = {"loss_gap": 1.0}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.parametrize("workload", tiny.CELLS)
def test_traced_run_reads_every_metric(workload):
    _card()
    cell = tiny.cell(workload, "bfloat16", LOOSE)
    cell.cfg["attention"] = "flash"
    out = measure.run(cell, 2**31 + 99, 0.5, True, "cuda",
                      time.perf_counter())
    out.pop("notes")
    # the codecs' rooflines need units the kernels take, which the tiny
    # plans may not have
    want = {m["name"] for m in cell.per_layer
            if m["name"] not in ("tern_roofline", "topk_roofline")}
    assert want <= set(out["metrics"]), out["metrics"]
    for name, m in out["metrics"].items():
        if m["unit"] == "%":
            assert 0 < m["value"] <= 105, (name, m)
    dev = out["device"]
    assert 0 < dev["busy_s"] <= dev["window_s"]
    assert out["device"]["platform"] == "gpu"
    assert len(out["breakdown"]["device_ops"]) <= 10

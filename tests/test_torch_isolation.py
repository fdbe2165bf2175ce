"""The port imports neither JAX nor the JAX package, and neither do
``chip_smoke.py`` and the other chip scripts; checked in a fresh
interpreter."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, json, pkgutil, sys
import pytorch_ps_mpi_tpu_torch as pkg
import chip_smoke, chip_dequant_widths, chip_main_path_ab
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
print(json.dumps({"modules": names, "loaded": sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "flax", "pytorch_ps_mpi_tpu"))}))
"""


@pytest.fixture(scope="module")
def probe():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_port_and_chip_smoke_import_no_jax(probe):
    assert probe["loaded"] == []


def test_probe_imported_every_module_of_the_port(probe):
    for name in ("ps", "optim", "comms", "mesh", "data", "ops.sign",
                 "ops._build", "codecs.sign", "models.resnet",
                 "utils.interop", "utils.metrics", "ops.quant", "ops.topk",
                 "codecs.quant", "codecs.topk", "codecs.error_feedback",
                 "ops.tern", "ops.attention", "codecs.terngrad",
                 "models.bert"):
        assert f"pytorch_ps_mpi_tpu_torch.{name}" in probe["modules"], name


def test_chip_smoke_fails_without_the_repo(tmp_path):
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout

"""The port imports neither JAX nor the JAX package, and neither do
``chip_smoke.py`` and the other chip scripts; checked in a fresh
interpreter. Every text of the port that names a ROADMAP queue 1 item
names the item whose heading covers it."""

from __future__ import annotations

import json
import re
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
                 "models.bert", "bucketing", "codecs.randomk",
                 "codecs.blocktopk", "codecs.threshold", "codecs.powersgd",
                 "trainer", "launch", "train", "parallel", "parallel.dp",
                 "utils.checkpoint", "utils.native", "utils.serialization",
                 "resilience.frames", "parallel.dcn", "parallel.tcp",
                 "parallel.async_ps", "parallel.async_train",
                 "train_async", "resilience.faults", "resilience.worker",
                 "resilience.supervisor", "parallel.sharded",
                 "parallel.tree", "train_sharded", "serving",
                 "serving.snapshots", "serving.delta", "serving.net",
                 "serving.native_read", "serving.core", "serving.follower",
                 "serve_readonly", "telemetry", "telemetry.registry",
                 "telemetry.freshness", "telemetry.diagnosis",
                 "telemetry.lineage", "telemetry.recorder",
                 "telemetry.http_server", "telemetry.numerics",
                 "telemetry.trace_export", "telemetry.anatomy",
                 "telemetry.hop_anatomy", "utils.tracing"):
        assert f"pytorch_ps_mpi_tpu_torch.{name}" in probe["modules"], name


def test_chip_smoke_fails_without_the_repo(tmp_path):
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


#: (file under the port, a word of the unported option, its queue 1 item)
UNPORTED_TEXTS = [
    ("ps.py", "param_specs", 4), ("ps.py", "batch_spec", 4),
    ("models/bert.py", "ring", 4),
    ("train.py", "gpt.py", 4), ("train.py", "moe.py", 4),
    ("parallel/async_train.py", "timeseries", 3),
    ("parallel/async_train.py", "slo", 3),
    ("parallel/async_train.py", "profiler", 3),
    ("parallel/async_train.py", "fleet", 3),
    ("parallel/async_train.py", "topo_actions", 3),
    ("parallel/async_train.py", "gpt.py", 4),
    ("parallel/sharded.py", "control.topo", 3),
    ("serving/core.py", "fleet", 3),
    ("serve_readonly.py", "--fleet-dir", 3),
    ("serve_readonly.py", "--control-dir", 3),
    ("telemetry/__init__.py", "timeseries", 3),
]


def _queue1_items() -> dict:
    text = (ROOT / "ROADMAP.md").read_text()
    queue = text[text.index("### Queue 1"):text.index("### Queue 2")]
    parts = re.split(r"^(\d+)\. \*\*", queue, flags=re.M)
    return {int(n): body for n, body in zip(parts[1::2], parts[2::2])}


def test_unported_texts_name_their_roadmap_item():
    items = _queue1_items()
    assert sorted(items) == list(range(1, len(items) + 1))
    named = {}
    for path in (ROOT / "pytorch_ps_mpi_tpu_torch").rglob("*.py"):
        for n in re.findall(r"queue 1\s+item\s+(\d+)", path.read_text()):
            named.setdefault(str(path.relative_to(
                ROOT / "pytorch_ps_mpi_tpu_torch")), set()).add(int(n))
    want = {}
    for file, word, item in UNPORTED_TEXTS:
        want.setdefault(file, set()).add(item)
        assert word in items[item], (file, word, item)
    assert named == want

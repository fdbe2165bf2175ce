"""BENCHMARK.json against the contract's shape, and every file the
harness finds by a name in it."""

import json
import math
import re

import pytest

from portbench.harness import judge, spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_files_are_found(workload):
    cell = spec.load(workload)
    assert cell.chips == 1
    for m in cell.per_layer:
        assert callable(cell.readers[m["name"]].read)
    assert cell.limits and set(cell.limits) <= set(judge.NUMBERS)
    assert all(0 < v < 1 and math.isfinite(v) for v in cell.limits.values())
    for k in ("family", "source", "reduced", "peak_flops",
              "control_precision"):
        assert k in cell.cfg
    for k in ("codec", "codec_args", "bucket_mb", "optimizer", "hyper",
              "batch", "pool"):
        assert k in cell.mix
    assert judge.FIRST_STEPS <= cell.mix["pool"]


def test_names_units_and_references():
    names = [c["name"] for c in BENCH["configs"]] + WORKLOADS + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]] + \
        [w["traffic"] for w in BENCH["workloads"]]
    for n in names:
        assert NAME.match(n), n
    configs = {c["name"]: c for c in BENCH["configs"]}
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == set(configs)
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(WORKLOADS) == len(set(WORKLOADS))
    for c in configs.values():
        assert c["file"].startswith("portbench/")
        with open(spec.ROOT / c["file"]) as f:
            assert json.load(f)["reduced"] == c["reduced"]
        assert len(c["why"]) <= 200 and len(c["source"]) <= 200
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        for w in m.get("workloads", []):
            assert w in WORKLOADS
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for w in m.get("workloads", WORKLOADS):
            assert spec.applies(e2e[m["moves"]], w)
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")


def test_every_cell_reports_enough():
    for w in WORKLOADS:
        cell = spec.load(w)
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer

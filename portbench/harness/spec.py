"""A cell's files, found by the names in ``BENCHMARK.json``.

- the configuration: ``configs/<config>.json``, its family
  ``families/<family>.py``;
- the traffic mix: ``traffic/<traffic>.json``, its optimizer
  ``optimizers/<optimizer>.py``, its codec ``codecs/<codec>.py``, its
  codec's reference
  ``reference/<codec>.py`` and its optimizer's ``reference/<optimizer>.py``;
- each per-layer metric: ``metrics/<name>.py``, with ``read(ctx)``;
- the cell's limits on the numbers compared: ``limits/<workload>.json``.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

#: the benchmark's folder, and the checkout's root above it
HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    cfg: dict
    mix: dict
    family: ModuleType
    optimizer: ModuleType
    codec: ModuleType
    ref_codec: ModuleType
    ref_optimizer: ModuleType
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, ModuleType]
    limits: Dict[str, float]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(kind: str, name: str) -> ModuleType:
    return importlib.import_module(f"portbench.{kind}.{name}")


def reader(name: str) -> ModuleType:
    """``metrics/<name>.py`` (a name may hold dots, so by its path)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def benchmark(path: Path = ROOT / "BENCHMARK.json") -> dict:
    return _json(path)


def load(workload: str, bench: dict = None) -> Cell:
    bench = bench if bench is not None else benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = _json(ROOT / configs[w["config"]]["file"])
    mix = _json(HERE / "traffic" / f"{w['traffic']}.json")
    return make(workload, int(w["chips"]), cfg, mix,
                [m for m in bench["end_to_end"] if applies(m, workload)],
                [m for m in bench["per_layer"] if applies(m, workload)],
                _json(HERE / "limits" / f"{workload}.json"))


def make(name: str, chips: int, cfg: dict, mix: dict, end_to_end: list,
         per_layer: list, limits: dict) -> Cell:
    """A cell from its configuration, mix, metrics and limits."""
    return Cell(
        name=name, chips=chips, cfg=cfg, mix=mix,
        family=_module("families", cfg["family"]),
        optimizer=_module("optimizers", mix["optimizer"]),
        codec=_module("codecs", mix["codec"]),
        ref_codec=_module("reference", mix["codec"]),
        ref_optimizer=_module("reference", mix["optimizer"]),
        end_to_end=end_to_end, per_layer=per_layer,
        readers={m["name"]: reader(m["name"]) for m in per_layer},
        limits=limits)

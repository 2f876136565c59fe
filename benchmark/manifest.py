"""``BENCHMARK.json`` and the files it names, found by name.

- a configuration ``<config>``: ``configs/<config>.json`` (its ``file``),
  whose ``reference`` key names its plain reference,
  ``references/<reference>.py``;
- a traffic mix ``<traffic>``: ``traffic/<traffic>.json``;
- a cell's limits of the correctness check: ``limits/<cell>.json``;
- a per-layer metric ``<metric>``: ``metrics/<metric>.py``, whose
  ``read(reading)`` returns the metric's value or None.

Adding a configuration, a traffic mix, a cell or a metric adds files and
entries; no file of the harness changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"


def load(path: Path = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, manifest: dict | None = None, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its configuration, traffic mix, limits and the
    metrics it reports."""
    m = manifest if manifest is not None else load(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in m["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in m["configs"]}
    cfg = _read(root / configs[w["config"]]["file"])
    traffic = _read(root / HERE.name / "traffic" / f"{w['traffic']}.json")
    limits = _read(root / HERE.name / "limits" / f"{name}.json")
    return Cell(name=name, chips=w["chips"], config=cfg, traffic=traffic,
                limits=limits,
                end_to_end=[e for e in m["end_to_end"] if _reports(e, name)],
                per_layer=[p for p in m["per_layer"] if _reports(p, name)])


def reference(cfg: dict):
    """The plain reference module that configuration ``cfg`` names."""
    return importlib.import_module(f"{__package__}.references.{cfg['reference']}")


def metric_reader(name: str, root: Path = ROOT):
    """``read`` of ``metrics/<name>.py``."""
    path = root / HERE.name / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read

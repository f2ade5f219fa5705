"""What ``BENCHMARK.json`` says about one cell, and the files it names.

Every cell is found by name: its configuration in ``configs/<config>.json``,
its traffic mix in ``traffic/<traffic>.json``, the limits of its output
check in ``limits/<workload>.json``, and each per-layer metric's reader in
``metrics/<metric>.py``. Adding a cell, a configuration or a metric adds
files and entries; no file here changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Any, Callable, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: Dict[str, Any]       # the configuration file, as run
    traffic_name: str
    traffic: Dict[str, Any]
    limits: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]   # this cell's end-to-end metrics
    per_layer: List[Dict[str, Any]]    # this cell's per-layer metrics


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def _applies(metric: Dict[str, Any], cell: str, e2e_here: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_here


def load_cell(name: str, bench: Dict[str, Any] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files; ``KeyError``
    for a name the benchmark does not hold."""
    bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{sorted(cells)}")
    w = cells[name]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m
           or name in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, name, e2e_names)]
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"],
                config=load_json(ROOT / conf["file"]),
                traffic_name=w["traffic"],
                traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(HERE / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer)


def metric_reader(name: str) -> Callable:
    """``read(ctx) -> float | None`` from ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    mod_name = "bench_h100.metrics." + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def model_config(config: Dict[str, Any]):
    """The port's ``ModelConfig`` of a configuration file's ``run``."""
    from repro_torch.configs.base import ModelConfig, MoEConfig
    run = dict(config["run"])
    if "moe" in run:
        run["moe"] = MoEConfig(**run["moe"])
    return ModelConfig(**run)

"""What ``BENCHMARK.json`` says about one cell, and the files it names.

Every cell is found by name: its configuration in ``configs/<config>.json``,
its traffic mix in ``traffic/<traffic>.json``, the limits of its output
check in ``limits/<workload>.json``, each per-layer metric's reader in
``metrics/<metric>.py``, and, where a configuration brings them, its own
plain reference in ``reference/<config>.py`` and its own counts in
``counts/<config>.py``. Adding a cell, a configuration or a metric adds
files and entries; no file here changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import types
import typing
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

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


def _load(sub: str, name: str) -> Optional[types.ModuleType]:
    """The module ``<sub>/<name>.py`` loaded by path, as
    ``bench_h100.<sub>.<name>`` (``.`` and ``-`` made ``_``, so that its
    relative imports resolve); None where there is no such file."""
    path = HERE / sub / f"{name}.py"
    if not path.is_file():
        return None
    mod_name = f"bench_h100.{sub}." + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str) -> Callable:
    """``read(ctx) -> float | None`` from ``metrics/<name>.py``."""
    mod = _load("metrics", name)
    if mod is None:
        raise FileNotFoundError(HERE / "metrics" / f"{name}.py")
    return mod.read


def reference(config_name: str) -> types.ModuleType:
    """The plain reference of a configuration: ``reference/<config>.py``
    where the configuration brings one, else ``reference/model.py`` (dense
    and top-k MoE decoders). Either offers ``exact()``, ``logits_at(params,
    config, tokens, rows, cols, mode)`` and, for a configuration with a
    train cell, ``train_steps``."""
    return (_load("reference", config_name) or
            importlib.import_module("bench_h100.reference.model"))


def counts(config_name: str) -> types.SimpleNamespace:
    """A configuration's frozen counts, each ``(run, batch, seq)``:
    ``prefill_flops``, ``train_flops`` and ``flash_bound_s`` (B6's bound
    for all the launches of one forward). Each comes from
    ``counts/<config>.py`` where that file defines it; otherwise
    ``prefill_flops`` is ``flops.prefill_flops``, ``train_flops`` three
    times the configuration's ``prefill_flops`` (``flops.train_flops``'
    rule) and ``flash_bound_s`` ``n_layers`` launches of
    ``flops.flash_bound_s``, every layer counted as attention."""
    from . import flops
    own = _load("counts", config_name)
    prefill = getattr(own, "prefill_flops", flops.prefill_flops)

    def train(run, batch, seq):
        return 3.0 * prefill(run, batch, seq)

    def flash(run, batch, seq):
        return run["n_layers"] * flops.flash_bound_s(run, batch, seq)

    return types.SimpleNamespace(
        prefill_flops=prefill,
        train_flops=getattr(own, "train_flops", train),
        flash_bound_s=getattr(own, "flash_bound_s", flash))


def _build(cls, values: Dict[str, Any]):
    """``cls`` (a dataclass) from a JSON dict: each field whose type is a
    dataclass built from its dict, each tuple field from its list; a key
    that ``cls`` has no field for raises ``KeyError`` naming it."""
    hints = typing.get_type_hints(cls)
    names = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in values.items():
        if key not in names:
            raise KeyError(f"{cls.__name__} has no field {key!r}")
        hint = hints[key]
        if dataclasses.is_dataclass(hint) and isinstance(value, dict):
            value = _build(hint, value)
        elif typing.get_origin(hint) is tuple and isinstance(value, list):
            value = tuple(value)
        kwargs[key] = value
    return cls(**kwargs)


def model_config(config: Dict[str, Any]):
    """The port's ``ModelConfig`` of a configuration file's ``run``: every
    sub-config (``moe``, ``ssm``, ``hybrid``, ``encdec``, any the port
    adds) built from its dict, every tuple from its list."""
    from repro_torch.configs.base import ModelConfig
    return _build(ModelConfig, config["run"])

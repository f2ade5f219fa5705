"""One run of one cell: set-up, the window, the traced sub-window, the
output check against the plain reference, and the result line.

``run_cell`` returns the result as a dict; ``run.py`` prints it. A CPU
test drives ``run_cell`` with ``device="cpu"`` and small sizes
(``overrides``); the command itself refuses to run without the card.
"""
from __future__ import annotations

import gc
import sys
from typing import Any, Callable, Dict, Optional

import torch

from . import compare, spec
from . import weights as weights_mod
from .runners.common import now, sync
from .trace import breakdown

#: top-level module names that may not be loaded once the window closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class NoChip(RuntimeError):
    """The machine lacks the cards the cell asks for."""


def forbidden_modules(modules=None) -> list:
    """The FORBIDDEN top-level names among ``modules`` (``sys.modules``),
    compared whole: ``repro_torch`` is not ``repro``."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules
                   if m.split(".")[0] in FORBIDDEN})


def check_chips(chips: int) -> None:
    if not torch.cuda.is_available():
        raise NoChip("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise NoChip(f"{torch.cuda.device_count()} CUDA devices; the cell "
                     f"asks for {chips}")


def _runner(kind: str):
    if kind == "prefill":
        from .runners.prefill import Prefill
        return Prefill
    if kind == "train":
        from .runners.train import Train
        return Train
    raise ValueError(f"unknown traffic kind {kind!r}")


def reference_numbers(cell, drv, params, device, mode: str = "f32"):
    """(compared numbers, diagnostics) of what ``drv`` produced, or, with
    ``mode="fp8"``, of the reference in that precision in the program's
    place; the reference is the configuration's (``spec.reference``)."""
    ref = spec.reference(cell.config_name)
    ref.exact()
    if cell.traffic["kind"] == "train":
        out = ref.train_steps(params, cell.config, drv.batches,
                              drv.ocfg_dict(), mode="f32")
        prog = drv.outputs()
        if mode != "f32":
            ctrl = ref.train_steps(params, cell.config, drv.batches,
                                   drv.ocfg_dict(), mode=mode)
            prog = {k: ctrl[k] for k in ("loss", "grad_norm", "delta_norm")}
        return compare.train_numbers(prog, out)
    progs, refs = [], []
    for idx, got in drv.outputs().items():
        row, cols = drv.plan[idx]
        tok = drv.tokens_of(idx)[row:row + 1]
        rows = torch.zeros(len(cols), dtype=torch.long, device=device)
        colt = torch.tensor(cols, dtype=torch.long, device=device)
        refs.append(ref.logits_at(params, cell.config, tok, rows, colt))
        if mode != "f32":
            got = ref.logits_at(params, cell.config, tok, rows, colt,
                                mode=mode)
        progs.append(got.float())
    if not progs:
        raise RuntimeError("no request of the sample was completed")
    numbers, diag = compare.prefill_numbers(torch.cat(progs),
                                            torch.cat(refs), cell.limits,
                                            [len(p) for p in progs])
    diag["rows"] = len(progs)
    return numbers, diag


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, device: Optional[str] = None,
             overrides: Optional[Callable] = None,
             control: str = "f32", log: Callable = print) -> Dict[str, Any]:
    """The result of one run. ``overrides(cell, cfg) -> (cell, cfg)``
    replaces sizes or traffic (a test on the CPU); ``control=
    "fp8"`` judges the reference in that precision in the program's
    place (``calibrate.py``)."""
    cell = spec.load_cell(workload)
    cfg = spec.model_config(cell.config)
    if overrides is not None:
        cell, cfg = overrides(cell, cfg)
    if device is None:
        check_chips(cell.chips)
        device = "cuda:0"
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    from repro_torch.models import Model
    shapes = Model(cfg, device="meta").param_shapes()
    from repro_torch.models.layers import plain_tree
    params = weights_mod.draw(plain_tree(shapes), seed, dev,
                              cell.config.get("draw"))
    drv = _runner(cell.traffic["kind"])(cell, cfg, params, seed, dev,
                                        seconds)
    sync(dev)
    setup_s = now() - t_start
    e2e = drv.window()
    values: Dict[str, float] = {"setup_s": setup_s, **e2e}
    tr = drv.traced() if trace else None
    sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    attempted = len(getattr(drv, "counted", ())) or e2e.get("steps", 0)
    failed = int(getattr(drv, "failed", 0))
    drv.free()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers, diag = reference_numbers(cell, drv, params, dev, control)
    ok, checks = compare.judge(numbers, cell.limits)
    ok = ok and failed == 0
    metrics: Dict[str, Dict[str, Any]] = {}
    if not trace:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        ctx = {"cell": cell, "run": cell.config["run"], "values": values,
               "trace": tr, "runner": drv}
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info: Dict[str, Any] = {
        "platform": "gpu" if on_card else dev.type,
        "kind": torch.cuda.get_device_name(dev) if on_card else dev.type,
        "count": cell.chips if on_card else 1,
        "memory_peak_bytes": int(peak)}
    result: Dict[str, Any] = {"correct": bool(ok), "attempted": int(attempted),
                              "failed": failed, "metrics": metrics,
                              "device": device_info}
    if trace:
        device_info["busy_s"] = tr["summary"]["busy_s"]
        device_info["window_s"] = tr["window_s"]
        result["breakdown"] = breakdown(tr["summary"])
    result["diagnostics"] = {**diag, "window": dict(e2e)}
    result["checks"] = checks
    for name, c in checks.items():
        log(f"check {name}: {c['value']!r} limit {c['limit']!r}")
    log(f"correct: {ok}")
    return result

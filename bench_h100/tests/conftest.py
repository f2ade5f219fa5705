"""Small sizes for the benchmark's CPU tests: every cell's own traffic
kind and limits, at smoke widths and short requests, on the CPU. A
configuration file's optional ``smoke`` dict is applied over ``SMALL``,
a sub-config's dict key by key."""
import dataclasses
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for p in (os.path.join(ROOT, "src"), ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

#: the small models, in f32: at these widths bf16's rounding alone reads
#: above the cells' limits, which were set at the published widths
SMALL = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
             vocab_size=4096, head_dim=32, param_dtype="float32",
             compute_dtype="float32")


def small_cell(cell, cfg):
    from bench_h100 import spec
    run = dict(cell.config["run"], **SMALL)
    if "moe" in run:
        run["moe"] = dict(run["moe"], n_experts=4, group_size=64)
    for key, value in cell.config.get("smoke", {}).items():
        if isinstance(value, dict):
            value = dict(run.get(key, {}), **value)
        run[key] = value
    conf = dict(cell.config, run=run)
    cell = dataclasses.replace(cell, config=conf)
    mix = dict(cell.traffic)
    if mix["kind"] == "prefill":
        mix.update(shapes=[[4, 32], [2, 64], [1, 128]]
                   if len(mix["shapes"]) > 1 else [[1, 128]],
                   traced_requests=3)
        limits = dict(cell.limits, sample_tokens=2048)
    else:
        mix.update(batch=2, seq=32, traced_steps=1)
        limits = cell.limits
    cell = dataclasses.replace(cell, traffic=mix, limits=limits)
    return cell, spec.model_config(conf)


@pytest.fixture
def small():
    return small_cell

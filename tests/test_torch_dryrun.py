"""The port's dry run (``repro_torch.launch.dryrun{,_lib}``) against the
JAX package's (``repro.launch.dryrun_lib``), and Queue C's C5–C8.

``plan_for`` makes JAX's decisions on both production meshes (a stand-in
mesh with JAX's ``axis_names``/``devices.shape`` lets the JAX function run
without 512 devices); local shard shapes equal ``NamedSharding``'s; every
arch × {train, prefill, decode} is counted on a fake 2 × 4 mesh (JAX's
``test_dryrun_all_archs_small_mesh``); the CLI writes its artifacts
(``tests/test_torch_dryrun_flops.py`` holds the FLOPs against JAX's).
Anything that starts PyTorch's ``fake`` process group runs in a
subprocess: the group is process-wide.
"""
import json
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.launch import dryrun_lib as jax_dryrun
from repro_torch import configs
from repro_torch.dist import sharding as sh
from repro_torch.launch import dryrun_lib
from repro_torch.models import Model, train_input_specs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"1pod-256": ((16, 16), ("data", "model")),
          "2pod-512": ((2, 16, 16), ("pod", "data", "model"))}
SMOKE_SHAPES = {"t_train": (256, 8, "train"), "t_prefill": (512, 4, "prefill"),
                "t_decode": (512, 8, "decode")}


def _run(code: str, *args, timeout: int = 600) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code),
                           *args], capture_output=True, text=True, env=env,
                          timeout=timeout, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


# ----------------------------------------------------------------------------
# plans and shard shapes: no process group
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("mesh_name", MESHES)
def test_plan_for_matches_jax(mesh_name):
    shape, axes = MESHES[mesh_name]
    jax_mesh = types.SimpleNamespace(axis_names=axes,
                                     devices=np.empty(shape, dtype=object))
    names = {"xla": "ref", "xla_chunked:512": "ref_chunked:512"}
    for arch in configs.list_archs():
        for shp in configs.SHAPES:
            want = jax_dryrun.plan_for(jax_configs.get_config(arch), shp,
                                       jax_mesh).to_dict()
            want["attn_impl"] = names[want["attn_impl"]]
            got = dryrun_lib.plan_for(configs.get_config(arch), shp,
                                      sh.MeshAxes(axes, shape)).to_dict()
            assert got == want, (arch, shp, mesh_name)


def _leaf_specs(arch: str, mesh):
    """(global shape, spec) of every parameter, batch and cache leaf of
    ``arch``'s smoke config, with and without FSDP."""
    cfg = configs.get_smoke_config(arch)
    model = Model(cfg, vocab=cfg.padded_vocab(4), device="meta")
    shapes = model.param_shapes()
    def pairs(tree, specs):
        leaves = lambda t: torch.utils._pytree.tree_leaves(
            t, is_leaf=lambda x: isinstance(x, tuple))
        return list(zip(leaves(sh._map_leaves(lambda n, t: tuple(t.shape),
                                              tree)), leaves(specs)))

    out = []
    for plan in (sh.Plan(), sh.Plan(fsdp=True, kv_cache="seq")):
        out += pairs(shapes, sh.param_shardings(shapes, cfg, mesh, plan))
        if cfg.family != "encdec":
            cache = model.init_cache(8, 64, device="meta")
            out += pairs(cache, sh.cache_shardings(cache, cfg, mesh, plan))
    batch = train_input_specs(cfg, 8, 64)
    bs = sh.batch_shardings(batch, mesh)
    out += [(tuple(batch[k].shape), bs[k]) for k in batch]
    return out


@pytest.mark.parametrize("arch", configs.list_archs())
def test_local_shard_shapes_match_named_sharding(arch):
    from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec
    mesh = sh.MeshAxes(("data", "model"), (2, 4))
    jax_mesh = AbstractMesh((2, 4), ("data", "model"))
    leaves = _leaf_specs(arch, mesh)
    assert len(leaves) > 10
    for shape, spec in leaves:
        want = NamedSharding(jax_mesh, PartitionSpec(*spec)).shard_shape(shape)
        assert dryrun_lib.local_shape(shape, spec, mesh) == tuple(want), \
            (arch, shape, spec)


# ----------------------------------------------------------------------------
# C5: M-RoPE on meta tensors
# ----------------------------------------------------------------------------
def test_m_rope_tables_run_on_meta():
    """C5: ``torch.repeat_interleave`` on ``meta`` needs ``output_size``;
    qwen2-vl-2b's prefill could not be counted without it."""
    from repro_torch.models.layers import m_rope_tables
    pos = torch.empty(3, 2, 8, dtype=torch.int32, device="meta")
    cos, sin = m_rope_tables(pos, 16, 1e4, (2, 3, 3))
    assert cos.shape == sin.shape == (2, 8, 1, 8)
    want = m_rope_tables(torch.arange(48).reshape(3, 2, 8), 16, 1e4,
                         (2, 3, 3))
    assert want[0].shape == cos.shape


# ----------------------------------------------------------------------------
# the smoke dry run on a fake 2 x 4 mesh
# ----------------------------------------------------------------------------
_SMOKE = r"""
import json, sys
from repro_torch.launch.dryrun import start_fake_group
start_fake_group(8)
import repro_torch.configs as C
from repro_torch.launch import dryrun_lib
from repro_torch.launch.mesh import make_mesh

mesh = make_mesh((2, 4), ("data", "model"))
C.SHAPES.update(%r)
C.get_config = C.get_smoke_config
out = {}
for arch in sys.argv[1].split(","):
    for shape in sys.argv[2].split(","):
        rep = dryrun_lib.lower_cell(arch, shape, mesh, "test-8")
        rl = rep["roofline"]
        out[arch + ":" + shape] = {
            "status": rep["status"], "flops": rl["flops_per_device"],
            "bytes": rl["bytes_per_device"],
            "collectives": rl["collective_count"],
            "comm_debug": rep["comm_debug_count"],
            "args": rl["memory_per_device"]["argument_size_in_bytes"],
            "temp": rl["memory_per_device"]["temp_size_in_bytes"]}
print(json.dumps(out))
""" % (SMOKE_SHAPES,)


@pytest.mark.parametrize("arch", configs.list_archs())
def test_smoke_dry_run_counts_every_kind_on_a_2x4_mesh(arch):
    """``tests/test_sharding.py::test_dryrun_all_archs_small_mesh``'s
    counterpart: train, prefill and decode are counted, with FLOPs and
    bytes, and the counter's collectives are ``CommDebugMode``'s. Covers
    C5 (qwen2-vl-2b), C6 (decode with 2 KV heads on a 4-way model axis)
    and C8 (the vocab-sharded cross entropy of every train step)."""
    got = _run(_SMOKE, arch, ",".join(SMOKE_SHAPES))
    assert len(got) == 3
    for key, cell in got.items():
        assert cell["status"] == "counted", key
        assert cell["flops"] > 0 and cell["bytes"] > 0, key
        assert cell["args"] > 0 and cell["temp"] > 0, key
        assert cell["collectives"] == cell["comm_debug"], key


def test_moe_cells_in_one_process():
    """C7: dbrx-132b (top-4) after phi-3.5-moe (top-2) in one process.
    DTensor's sharding cache left ``topk``'s ``k`` out of its key, so the
    second MoE got the first one's routing shape."""
    got = _run(_SMOKE, "phi3.5-moe-42b-a6.6b,dbrx-132b,phi3.5-moe-42b-a6.6b",
               "t_prefill")
    assert [c["status"] for c in got.values()] == ["counted", "counted"]


_INDEX_COPY = r"""
import json
import torch
from repro_torch.launch.dryrun import start_fake_group
start_fake_group(4)
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Shard
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.dist import api
mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("model",))
full = torch.arange(2 * 16 * 3, dtype=torch.float32).reshape(2, 16, 3)
row = -torch.ones(2, 1, 3)
out = {}
for slot in (1, 9):
    idx = torch.tensor([slot])
    want = full.clone().index_copy_(1, idx, row)
    dst = DTensor.from_local(full[:, :4].clone(), mesh, [Shard(1)],
                             run_check=False, shape=full.shape,
                             stride=full.stride())
    with implicit_replication():
        got = api.index_copy_(dst, 1, idx, row)
    out[slot] = {"same": got is dst,
                 "shard_dims": [p.dim for p in dst.placements
                                if isinstance(p, Shard)],
                 "local": list(dst.to_local().shape),
                 "equal": bool(torch.equal(dst.to_local(), want[:, :4]))}
print(json.dumps(out))
"""


def test_decode_cache_write_keeps_its_layout():
    """C6: DTensor's in-place ``index_copy_`` into a cache sharded on its
    sequence dim rewrote the placements and kept the old local shard.
    ``dist.api.index_copy_`` keeps the layout; rank 0's slots 0–3 take the
    row at slot 1 and keep their values at slot 9, which another rank
    holds."""
    got = _run(_INDEX_COPY)
    for slot in ("1", "9"):
        assert got[slot] == {"same": True, "shard_dims": [1],
                             "local": [2, 4, 3], "equal": True}, slot


# ----------------------------------------------------------------------------
# the CLI
# ----------------------------------------------------------------------------
def test_dryrun_cli_writes_one_json_a_cell(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3-1.7b", "--shape", "decode_32k", "--shape", "long_500k",
         "--single-pod-only", "--out", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=600, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "1 counted, 1 skipped" in proc.stdout, proc.stdout
    decode = json.loads((tmp_path / "qwen3-1.7b__decode_32k__1pod-256.json")
                        .read_text())
    assert decode["status"] == "counted" and decode["chips"] == 256
    rl = decode["roofline"]
    assert rl["flops_per_device"] > 0 and rl["collective_count"] > 0
    assert rl["bottleneck"] in ("compute", "memory", "collective")
    assert 0 < rl["memory_per_device"]["argument_size_in_bytes"] < 80e9
    skipped = json.loads((tmp_path / "qwen3-1.7b__long_500k__1pod-256.json")
                         .read_text())
    assert skipped["status"] == "skipped"

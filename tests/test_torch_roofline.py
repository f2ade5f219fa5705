"""The port's H100 roofline (``repro_torch.roofline``) against the JAX
package's (``repro.roofline``): ``tests/test_roofline.py``'s cases where
they translate, and what eager counting adds.

The JAX analyzer reads compiled HLO; the port's counter sees each aten op
as it runs. The FLOPs of a plain matmul agree with ``hlo_stats`` of the
same jitted product. ``hlo_stats`` multiplies scanned bodies by their
trip counts; an eager forward runs every layer, so its counts scale
exactly with the layer count instead. Collectives and the local-versus-
global count need a process group, so they run in a subprocess under
PyTorch's ``fake`` backend.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as jax_configs
from repro.roofline import analysis as jax_roof
from repro.roofline import hlo_stats
from repro_torch import configs
from repro_torch.models import Model
from repro_torch.roofline import analysis as roof
from repro_torch.roofline.counter import OpCounter, count

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          capture_output=True, text=True, env=env,
                          timeout=300, cwd=REPO)


def _jax_stats(fn, *specs):
    return hlo_stats.analyze_module(jax.jit(fn).lower(*specs).compile()
                                    .as_text())


# ----------------------------------------------------------------------------
# tests/test_roofline.py's cases
# ----------------------------------------------------------------------------
def test_flops_plain_matmul_equal_hlo_stats():
    n = 256
    a = torch.empty(n, n, device="meta")
    _, stats = count(lambda: a @ a, "meta")
    spec = jax.ShapeDtypeStruct((n, n), jnp.float32)
    assert stats.flops == 2 * n ** 3
    assert stats.flops == _jax_stats(lambda x, y: x @ y, spec, spec).flops
    assert stats.flops_by_op == {"aten.mm": 2 * n ** 3}


def test_bytes_of_a_matmul_read_two_and_write_one_matrix():
    n = 512
    a = torch.empty(n, n, device="meta")
    _, stats = count(lambda: a @ a, "meta")
    assert stats.bytes_accessed == 3 * n * n * 4
    spec = jax.ShapeDtypeStruct((n, n), jnp.float32)
    assert _jax_stats(lambda x, y: x @ y, spec, spec).bytes_accessed == \
        stats.bytes_accessed


def _forward_counts(n_layers: int):
    cfg = configs.get_smoke_config("qwen3-1.7b")
    cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = Model(cfg, device="meta")
    params = model.param_shapes()
    tokens = torch.empty(2, 64, dtype=torch.int32, device="meta")
    _, stats = count(lambda: model.forward(params, {"tokens": tokens}),
                     "meta")
    return stats


def test_counts_scale_exactly_with_the_layer_count():
    """The trip-count cases' counterpart: an eager forward runs every
    layer, so one layer more adds the same FLOPs and bytes each time."""
    s1, s2, s3, s5 = (_forward_counts(n) for n in (1, 2, 3, 5))
    for attr in ("flops", "bytes_accessed"):
        step = getattr(s2, attr) - getattr(s1, attr)
        assert step > 0
        assert getattr(s3, attr) - getattr(s2, attr) == step
        assert getattr(s5, attr) - getattr(s3, attr) == 2 * step


def test_collective_all_reduce_priced_by_the_ring():
    proc = _run("""
        import json
        import torch
        from repro_torch.launch.dryrun import start_fake_group
        start_fake_group(4)
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor, Partial, Replicate
        from repro_torch.roofline.counter import count
        mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("d",))
        x = DTensor.from_local(torch.empty(4, 1024, device="meta"), mesh,
                               [Partial()], run_check=False)
        _, st = count(lambda: x.redistribute(mesh, [Replicate()]), "meta")
        print(json.dumps({"bytes": st.collective_bytes,
                          "secs": st.collective_seconds,
                          "n": st.collective_count}))
    """)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = __import__("json").loads(proc.stdout.strip().splitlines()[-1])
    assert got["n"] == 1
    assert got["bytes"]["all-reduce"] >= 1024 * 4
    assert got["bytes"] == {"all-reduce": 4 * 1024 * 4}
    # 2 × bytes × (n-1)/n over NVLink: four ranks lie in one node
    assert got["secs"]["all-reduce"] == pytest.approx(
        2 * 4 * 1024 * 4 * 3 / 4 / roof.NVLINK_BW, rel=1e-12)


def test_collective_bytes_follow_the_jax_convention():
    """One all-gather, all-reduce and reduce-scatter of one tensor on a
    2 × 4 mesh count the same bytes in the JAX package's
    ``parse_collectives`` (a ``shard_map`` compiled for eight host
    devices) and in the port's counter (DTensor redistributions on eight
    fake ranks): each collective by its result, so a reduce-scatter by
    the shard it leaves, a quarter of its operand here."""
    proc = _run("""
        import json, os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        import jax, jax.numpy as jnp
        from jax.sharding import PartitionSpec as P
        from repro.roofline.analysis import parse_collectives
        import torch
        from repro_torch.launch.dryrun import start_fake_group
        start_fake_group(8)
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                              Shard)
        from repro_torch.roofline.counter import count

        jmesh = jax.make_mesh((2, 4), ("data", "model"))
        x = jnp.zeros((16, 64), jnp.float32)

        def jax_bytes(fn, in_spec, out_spec):
            f = jax.jit(jax.shard_map(fn, mesh=jmesh, in_specs=in_spec,
                                      out_specs=out_spec, check_vma=False))
            return parse_collectives(
                f.lower(x).compile().as_text()).bytes_by_kind

        mesh = init_device_mesh("cpu", (2, 4),
                                mesh_dim_names=("data", "model"))

        def port_bytes(local, start, end, shape):
            t = DTensor.from_local(torch.empty(local, device="meta"), mesh,
                                   start, run_check=False,
                                   shape=torch.Size(shape),
                                   stride=(shape[1], 1))
            _, st = count(lambda: t.redistribute(mesh, end), "meta")
            return st.collective_bytes

        whole = [Replicate(), Replicate()]
        cols = [Replicate(), Shard(1)]
        partial = [Replicate(), Partial()]
        print(json.dumps({
            "all-gather": [
                jax_bytes(lambda a: jax.lax.all_gather(a, "model", axis=1,
                                                       tiled=True),
                          P(None, "model"), P(None, None)),
                port_bytes((16, 16), cols, whole, (16, 64))],
            "all-reduce": [
                jax_bytes(lambda a: jax.lax.psum(a, "model"),
                          P(None, "model"), P(None, None)),
                port_bytes((16, 16), partial, whole, (16, 16))],
            "reduce-scatter": [
                jax_bytes(lambda a: jax.lax.psum_scatter(
                    a, "model", scatter_dimension=1, tiled=True),
                    P(None, None), P(None, "model")),
                port_bytes((16, 64), partial, cols, (16, 64))]}))
    """)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = __import__("json").loads(proc.stdout.strip().splitlines()[-1])
    want = {"all-gather": 16 * 64 * 4, "all-reduce": 16 * 16 * 4,
            "reduce-scatter": 16 * 16 * 4}
    for kind, (jax_counts, port_counts) in got.items():
        assert jax_counts == port_counts == {kind: want[kind]}, (kind, got)


def test_local_flops_count_replicated_work_where_flop_counter_mode_does_not():
    proc = _run("""
        import json
        import torch
        from torch.utils.flop_counter import FlopCounterMode
        from repro_torch.launch.dryrun import start_fake_group
        start_fake_group(8)
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from repro_torch.roofline.counter import count
        mesh = init_device_mesh("cpu", (8,), mesh_dim_names=("d",))
        n = 64
        a = torch.empty(n, n, device="meta")
        rep = DTensor.from_local(a, mesh, [Replicate()], run_check=False)
        row = DTensor.from_local(torch.empty(n // 8, n, device="meta"),
                                 mesh, [Shard(0)], run_check=False,
                                 shape=(n, n), stride=(n, 1))
        out = {}
        for name, x in (("replicated", rep), ("sharded", row)):
            _, st = count(lambda: x @ rep, "meta")
            with FlopCounterMode(display=False) as fc:
                x @ rep
            out[name] = [st.flops, fc.get_total_flops()]
        print(json.dumps(out))
    """)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = __import__("json").loads(proc.stdout.strip().splitlines()[-1])
    n = 64
    assert got["replicated"] == [2 * n ** 3, 2 * n ** 3]
    assert got["sharded"] == [2 * n ** 3 / 8, 2 * n ** 3]


# ----------------------------------------------------------------------------
# what the counter adds
# ----------------------------------------------------------------------------
def test_views_are_free_and_host_ops_are_not_counted():
    x = torch.empty(64, 32, device="meta")
    host = torch.ones(8)
    _, stats = count(lambda: (x.t(), x.reshape(32, 64), host + 1), "meta")
    assert stats.bytes_accessed == 0 and stats.flops == 0


def test_peak_live_bytes_follow_the_storages():
    x = torch.ones(1024)

    def body():
        a = x + 1
        b = a * 2
        del a
        c = b + 1
        return c

    with OpCounter("cpu") as counter:
        body()
    assert counter.stats.peak_live_bytes == 2 * 1024 * 4
    assert counter.stats.bytes_accessed == 3 * 2 * 1024 * 4


def test_roofline_terms_use_the_h100_peaks():
    _, stats = count(lambda: torch.empty(256, 256, device="meta") @
                     torch.empty(256, 256, device="meta"), "meta")
    rl = roof.analyze(stats, arch="a", shape="s", mesh_name="m", chips=1,
                      model_flops=2 * 256 ** 3, step_kind="prefill",
                      memory={"argument_size_in_bytes": 1.0})
    d = rl.to_dict()
    assert set(d) == set(jax_roof.Roofline(
        "a", "s", "m", 1, 1.0, 1.0, jax_roof.CollectiveStats({}, {}, 0),
        1.0, {}, "prefill").to_dict())
    assert d["compute_s"] == 2 * 256 ** 3 / 989e12
    assert d["memory_s"] == 3 * 256 * 256 * 4 / 3.35e12
    assert d["bottleneck"] == "memory"
    assert d["useful_flops_ratio"] == 1.0
    assert d["memory_per_device"]["argument_size_in_bytes"] == 1.0
    # a group inside one node rides NVLink, one across two nodes IB
    assert roof.link_bw(range(8)) == 450e9
    assert roof.link_bw(range(16)) == 50e9
    assert roof.ring_seconds("all-gather", 16e9, range(16)) == \
        pytest.approx(16e9 * 15 / 16 / 50e9)


@pytest.mark.parametrize("arch", configs.list_archs())
def test_model_flops_for_matches_jax(arch):
    for shape, (seq, batch, kind) in configs.SHAPES.items():
        assert roof.model_flops_for(configs.get_config(arch), shape, seq,
                                    batch, kind) == \
            jax_roof.model_flops_for(jax_configs.get_config(arch), shape,
                                     seq, batch, kind), (arch, shape)

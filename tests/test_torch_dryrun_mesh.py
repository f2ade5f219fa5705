"""The port's sharded step against the JAX partition on a 2 × 4 mesh.

Every arch × {train, prefill, decode} smoke cell that
``repro_torch.launch.dryrun_lib.lower_cell`` counts on eight ranks of
PyTorch's ``fake`` group is held against the JAX package's
``lower_cell`` of the same cell compiled for eight forced host devices:
the port's collective bytes a device at most twice JAX's, its FLOPs a
device at most 1.02 times JAX's (1.06 for recurrentgemma-9b, whose
RG-LRU multiplies its gates by ``bmm`` where JAX runs
``associative_scan``; fewer FLOPs than JAX's are allowed: the MoEs' count
0.69–0.74 of JAX's). Both packages count a collective's bytes by its
result (``tests/test_torch_roofline.py``). The (2, 2, 2) cells, the FSDP
case and C11 are in ``tests/test_torch_dryrun_mesh3d.py``. Each arch
runs both packages in one subprocess: the fake group and the forced
device count are process-wide.
"""
import json

import pytest

from repro_torch import configs
from test_torch_dryrun import SMOKE_SHAPES, _run

#: the FLOPs a device may exceed JAX's by
FLOPS_RATIO = {"recurrentgemma-9b": 1.06}
FLOPS_DEFAULT = 1.02
#: the collective bytes a device may exceed JAX's by
COLLECTIVE_RATIO = 2.0
#: the smoke shapes, a train step of one sequence a device on a
#: (2, 1, 4) mesh (C11's cell holds one), and a decode step of one
#: sequence (C12's ``long_500k`` cell holds one)
SHAPES = {**SMOKE_SHAPES, "t_train_b2": (256, 2, "train"),
          "t_decode_b1": (512, 1, "decode")}

AGAINST_JAX = r"""
import dataclasses, json, math, os, sys
arch, mesh_shape, axes, plans, changes = (
    sys.argv[1], tuple(json.loads(sys.argv[2])), tuple(json.loads(sys.argv[3])),
    json.loads(sys.argv[4]), json.loads(sys.argv[5]))
devices = math.prod(mesh_shape)
os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
from repro_torch.launch.dryrun import start_fake_group
start_fake_group(devices)
import repro_torch.configs as C
import repro.configs as JC
from repro_torch.launch import dryrun_lib
from repro_torch.launch.mesh import make_mesh
from repro.launch import dryrun_lib as jax_dryrun
from repro.launch.mesh import make_mesh as jax_make_mesh

for registry in (C, JC):
    registry.SHAPES.update(%r)
    registry.get_config = (lambda a, smoke=registry.get_smoke_config:
                           dataclasses.replace(smoke(a), **changes))
mesh = make_mesh(mesh_shape, axes)
jax_mesh = jax_make_mesh(mesh_shape, axes)
out = {}
for plan in plans:
    for shape in sys.argv[6].split(","):
        cells = {}
        for name, lib, m in (("port", dryrun_lib, mesh),
                             ("jax", jax_dryrun, jax_mesh)):
            rep = lib.lower_cell(arch, shape, m, "test", plan_overrides=plan)
            rl = rep["roofline"]
            cells[name] = {
                "status": rep["status"], "flops": rl["flops_per_device"],
                "collective": sum(rl["collective_bytes"].values()),
                "args": rl["memory_per_device"]["argument_size_in_bytes"]}
        out[json.dumps(plan) + " " + shape] = cells
print(json.dumps(out))
""" % (SHAPES,)


def against_jax(arch: str, mesh_shape, axes, *, plans=({},), changes=None,
                shapes=tuple(SMOKE_SHAPES)) -> dict:
    """``{"<plan> <shape>": {"port": counts, "jax": counts}}`` of ``arch``'s
    smoke config (with ``changes`` made to it) on ``mesh_shape``."""
    return _run(AGAINST_JAX, arch, json.dumps(list(mesh_shape)),
                json.dumps(list(axes)), json.dumps(list(plans)),
                json.dumps(changes or {}), ",".join(shapes))


def assert_within_jax(arch: str, got: dict, *,
                      collective_ratio: float = COLLECTIVE_RATIO) -> None:
    """Every cell counted by both packages, the port's collective bytes
    and FLOPs a device within the limits of JAX's."""
    limit = FLOPS_RATIO.get(arch, FLOPS_DEFAULT)
    for key, cell in got.items():
        port, jax = cell["port"], cell["jax"]
        assert port["status"] == "counted", (arch, key)
        assert port["collective"] <= collective_ratio * jax["collective"], \
            (arch, key, cell)
        assert port["flops"] <= limit * jax["flops"], (arch, key, cell)


@pytest.mark.parametrize("arch", configs.list_archs())
def test_smoke_cells_within_the_jax_partition_on_a_2x4_mesh(arch):
    got = against_jax(arch, (2, 4), ("data", "model"))
    assert len(got) == 3
    assert_within_jax(arch, got)


def test_c12_one_sequence_decode_splits_the_gates_over_the_idle_data_axis():
    """C12: recurrentgemma-9b's decode of one sequence on a (4, 2) mesh,
    whose 4-way data axis the batch leaves idle. GSPMD splits the rows of
    the RG-LRU's gate products (``w_a`` and ``w_i``, weights the rules
    replicate) over the idle axis and ``model`` and all-reduces the
    partial sums; the port did each on every device of the data axis
    (1.111× JAX's FLOPs here, 1.105× in the full-width ``long_500k``
    cell) until ``dist.api.idle_split_product``. The FLOPs are held to
    1.02× JAX's: the rest is the decode P·V, which GSPMD computes for one
    head a device of the data axis. The collective bytes are held to 4×,
    the bound of the non-dense archs' full-width cells."""
    got = against_jax("recurrentgemma-9b", (4, 2), ("data", "model"),
                      shapes=("t_decode_b1",))
    assert len(got) == 1
    assert_within_jax("recurrentgemma-9b", got, collective_ratio=4.0)
    cell = got["{} t_decode_b1"]
    assert cell["port"]["flops"] <= FLOPS_DEFAULT * cell["jax"]["flops"], cell

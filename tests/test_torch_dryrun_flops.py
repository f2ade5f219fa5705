"""The port's dry-run counts against JAX's compiled cells and against
real tensors.

On a 1 × 1 mesh, the smoke prefill and train FLOPs that
``repro_torch.launch.dryrun_lib.lower_cell`` counts are those of the JAX
package's ``lower_cell`` (``hlo_stats`` of the compiled cell), within 2 %
for every arch but recurrentgemma-9b, whose RG-LRU differs by design; and
the counts on ``meta`` DTensors are exactly those of the same step on
plain CPU tensors, the gate ``chip_smoke.py``'s roofline phase holds on
the card. Each case starts PyTorch's ``fake`` process group, so each runs
in a subprocess.
"""
import pytest

from test_torch_dryrun import SMOKE_SHAPES, _run


# ----------------------------------------------------------------------------
# smoke FLOPs on a 1 x 1 mesh against JAX's compiled cell
# ----------------------------------------------------------------------------
_AGAINST_JAX = r"""
import json, sys
from repro_torch.launch.dryrun import start_fake_group
start_fake_group(1)
import repro_torch.configs as C
import repro.configs as JC
from repro_torch.launch import dryrun_lib
from repro_torch.launch.mesh import make_mesh
from repro.launch import dryrun_lib as jax_dryrun
from repro.launch.mesh import make_mesh as jax_make_mesh

shapes = %r
for registry in (C, JC):
    registry.SHAPES.update(shapes)
    registry.get_config = registry.get_smoke_config
jax_dryrun.configs.get_config = JC.get_smoke_config
mesh = make_mesh((1, 1), ("data", "model"))
jax_mesh = jax_make_mesh((1, 1), ("data", "model"))
arch = sys.argv[1]
out = {}
for shape in ("t_train", "t_prefill"):
    port = dryrun_lib.lower_cell(arch, shape, mesh, "1x1")
    ref = jax_dryrun.lower_cell(arch, shape, jax_mesh, "1x1")
    out[shape] = {"port": port["roofline"]["flops_per_device"],
                  "jax": ref["roofline"]["flops_per_device"]}
print(json.dumps(out))
""" % (SMOKE_SHAPES,)

_CLOSE = ("qwen3-1.7b", "llama3-8b", "qwen1.5-32b", "nemotron-4-340b",
          "phi3.5-moe-42b-a6.6b", "dbrx-132b", "whisper-tiny", "qwen2-vl-2b",
          "mamba2-130m")


@pytest.mark.parametrize("arch", _CLOSE)
def test_smoke_flops_within_two_percent_of_jax(arch):
    """Equal for the dense, moe, encdec and vlm archs (C9 and C10 made
    whisper-tiny's and the MoEs' equal); mamba2-130m's train step counts
    0.996 of JAX's, its prefill the same."""
    got = _run(_AGAINST_JAX, arch)
    for shape, cell in got.items():
        assert cell["port"] == pytest.approx(cell["jax"], rel=0.02), \
            (arch, shape, cell)


def test_recurrentgemma_flops_against_jax_by_design():
    """The RG-LRU's chunk loop differs by design (ROADMAP "Differences by
    design"): the port's chunked scan multiplies its gates by ``bmm``
    (the [256, 64, 64] × [256, 64, 1] and [4, 512, 64] × [4, 64, 64]
    products), where JAX runs ``associative_scan``, which has no dot. The
    port counts 1.0488 of JAX's prefill FLOPs and 1.0388 of its train
    step's; every other contraction is the same."""
    got = _run(_AGAINST_JAX, "recurrentgemma-9b")
    assert got["t_prefill"]["port"] / got["t_prefill"]["jax"] == \
        pytest.approx(1.0488, abs=1e-4)
    assert got["t_train"]["port"] / got["t_train"]["jax"] == \
        pytest.approx(1.0388, abs=1e-4)


# ----------------------------------------------------------------------------
# meta against real tensors
# ----------------------------------------------------------------------------
_META_VS_CPU = r"""
import json, sys
from repro_torch.launch.dryrun import start_fake_group
start_fake_group(1)
import repro_torch.configs as C
from repro_torch.launch import dryrun_lib
from repro_torch.launch.mesh import make_mesh
from repro_torch.roofline.counter import count
C.SHAPES.update({"t_train": (64, 4, "train"), "t_prefill": (128, 2, "prefill")})
C.get_config = C.get_smoke_config
mesh = make_mesh((1, 1), ("data", "model"))
plan = {"attn_impl": "ref"}
out = {}
for shape in ("t_prefill", "t_train"):
    rl = dryrun_lib.lower_cell(sys.argv[1], shape, mesh, "1x1",
                               plan_overrides=plan)["roofline"]
    run, args, _ = dryrun_lib.device_cell(C.get_smoke_config(sys.argv[1]),
                                          shape, "cpu", plan_overrides=plan)
    _, st = count(run, "cpu")
    mem = rl["memory_per_device"]
    out[shape] = [[rl["flops_per_device"], st.flops],
                  [rl["bytes_per_device"], st.bytes_accessed],
                  [mem["argument_size_in_bytes"], dryrun_lib.argument_bytes(args)],
                  [mem["temp_size_in_bytes"], st.peak_live_bytes]]
print(json.dumps(out))
"""


@pytest.mark.parametrize("arch", ("qwen3-1.7b", "whisper-tiny",
                                  "qwen2-vl-2b"))
def test_meta_counts_equal_a_run_on_real_tensors(arch):
    """The gate ``chip_smoke.py``'s roofline phase holds on the card, here
    on the CPU: the dry run's FLOPs, bytes, argument bytes and peak live
    bytes on a 1 × 1 mesh of ``meta`` DTensors are those of the same step
    on plain CPU tensors, exactly."""
    got = _run(_META_VS_CPU, arch)
    for shape, pairs in got.items():
        for meta, real in pairs:
            assert meta == real and meta > 0, (arch, shape, pairs)

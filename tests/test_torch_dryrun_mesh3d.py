"""The port's sharded step against the JAX partition on a 3-d mesh, under
FSDP, and C11.

On (2, 2, 2) ``("pod", "data", "model")`` the smoke cells of qwen3-1.7b,
whisper-tiny and phi-3.5-moe are held to the limits of
``tests/test_torch_dryrun_mesh.py``. Under ``plan_overrides={"fsdp":
True}`` qwen3-1.7b's smoke config, widened to ``d_model=512`` and
``d_ff=1024`` (the rules split no dim under 512 over the data axes),
keeps those limits and its arguments shrink: the override shards. C11:
whisper-tiny with six heads on a 4-way model axis of a 3-d mesh is
counted through the backward (the full-width cell failed there with a
DTensor view of a shard that did not fit).
"""
import pytest

from test_torch_dryrun_mesh import against_jax, assert_within_jax

AXES_3D = ("pod", "data", "model")


@pytest.mark.parametrize("arch", ("qwen3-1.7b", "whisper-tiny",
                                  "phi3.5-moe-42b-a6.6b"))
def test_smoke_cells_within_the_jax_partition_on_a_2x2x2_mesh(arch):
    got = against_jax(arch, (2, 2, 2), AXES_3D)
    assert len(got) == 3
    assert_within_jax(arch, got)


def test_fsdp_override_shards_the_arguments():
    got = against_jax("qwen3-1.7b", (2, 4), ("data", "model"),
                      plans=({"fsdp": True}, {}),
                      changes={"d_model": 512, "d_ff": 1024},
                      shapes=("t_train", "t_prefill"))
    assert len(got) == 4
    assert_within_jax("qwen3-1.7b", got)
    for shape in ("t_train", "t_prefill"):
        fsdp = got['{"fsdp": true} ' + shape]
        plain = got["{} " + shape]
        assert fsdp["port"]["args"] < 0.75 * plain["port"]["args"], shape
        assert fsdp["port"]["args"] == pytest.approx(fsdp["jax"]["args"],
                                                     rel=0.01), shape


def test_c11_heads_the_model_axis_does_not_divide_on_a_3d_mesh():
    """C11: six heads on a 4-way model axis of a (2, 1, 4) mesh, through
    the train step's backward, at one sequence a device (where a DTensor
    view of the scores failed) and at four; the attention runs on each
    device's own query rows (``dist.api.local_attention``). The
    collective bytes are held to 4× JAX's, the bound of the non-dense
    archs' full-width cells, C11's among them: GSPMD lays the uneven head
    split out over two dims, eager DTensor gathers (2.08× JAX's here,
    2.59× at full width)."""
    got = against_jax("whisper-tiny", (2, 1, 4), AXES_3D,
                      changes={"n_heads": 6, "n_kv_heads": 6},
                      shapes=("t_train_b2", "t_train", "t_decode"))
    assert len(got) == 3
    assert_within_jax("whisper-tiny", got, collective_ratio=4.0)

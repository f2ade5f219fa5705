"""Which operands B1's kernels read where they lie, and which tile a grid
gets.

The f32 kernel copies an operand 16 bytes a thread when its base and row
pitch allow it and 4 bytes a thread otherwise; the bf16 kernel reads its
tiles by TMA, which needs the base and the row pitch on 16 bytes, so the
wrapper copies any other operand to a buffer with a 16-byte pitch. These
tests run those decisions on ``meta`` and CPU tensors; the kernels
themselves are held in ``tests/test_torch_cuda.py`` on the card.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import KERNELS, ops, ref
from repro_torch.kernels.matmul import (BF16_TILES, F32_TILES,
                                        INSTANTIATIONS, bf16_tile,
                                        f32_operand, f32_tile,
                                        f32_vector_loads, matmul, tma_operand,
                                        tma_ready)

H100_SMS = 132


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _offset(rows, cols, dtype=torch.float32):
    """A ``rows x cols`` matrix whose base lies one element past an
    allocation's start."""
    return _meta(rows * cols + 1, dtype=dtype)[1:].view(rows, cols)


@pytest.mark.parametrize("make,ld", [
    (lambda: _meta(4096, 4096), 4096),            # the main path
    (lambda: _meta(300, 200), 200),               # K % 4 == 0
    (lambda: _meta(300, 172)[:, :170], 172),      # padded rows, pitch 172
    (lambda: _meta(1, 1000), 0),                  # a single row
    (lambda: _meta(64, 4096)[8:], 4096),          # offset by whole rows
    (lambda: _meta(1, 256).expand(128, 256), 0),  # rows broadcast
], ids=["square", "k_multiple_of_4", "padded_rows", "single_row",
        "row_offset", "expanded_rows"])
def test_f32_operands_taking_16_byte_copies(make, ld):
    t = make()
    got, got_ld = f32_operand(t)
    assert got is t and got_ld == ld
    assert f32_vector_loads(got, got_ld)


@pytest.mark.parametrize("make,ld", [
    (lambda: _meta(200, 170), 170),               # N % 4 != 0
    (lambda: _meta(1000, 3), 3),                  # the (1, 1000, 3) B
    (lambda: _offset(300, 200), 200),             # base 4 bytes in
    (lambda: _meta(300, 202)[:, 1:201], 202),     # column slice, odd base
    (lambda: _meta(300, 201)[:, :200], 201),      # odd row pitch
], ids=["n_not_multiple_of_4", "three_columns", "odd_base", "column_slice",
        "odd_pitch"])
def test_f32_operands_taking_4_byte_copies(make, ld):
    t = make()
    got, got_ld = f32_operand(t)
    assert got is t and got_ld == ld
    assert not f32_vector_loads(got, got_ld)


def test_f32_operand_with_a_strided_last_axis_is_copied():
    t = _meta(256, 300).t()
    got, ld = f32_operand(t)
    assert got is not t and got.is_contiguous() and got.shape == t.shape
    assert ld == 256 and f32_vector_loads(got, ld)
    column = _meta(300, 256).t()[:, :1]            # one column: any stride
    assert f32_operand(column)[0] is column


@pytest.mark.parametrize("m,n,tile", [
    (4096, 4096, 128),     # m_mult 4096^2: 1024 blocks
    (2048, 4096, 128),     # one map_over chunk: 512 blocks
    (512, 512, 64),        # the quickstart: 16 blocks of 128^2
    (1, 3, 64),
    (128 * 11, 128 * 12, 128),   # exactly 132 blocks: one full wave
    (128 * 11, 128 * 12 - 1, 128),
    (128 * 11, 128 * 11, 64),    # 121 blocks
], ids=["m_mult", "map_over_chunk", "quickstart", "tiny", "one_wave",
        "one_wave_ragged", "below_one_wave"])
def test_f32_tile_for_the_grid(m, n, tile):
    assert f32_tile(m, n, H100_SMS) == tile
    assert tile in F32_TILES


@pytest.mark.parametrize("make", [
    lambda: _meta(4096, 4096, dtype=torch.bfloat16),
    lambda: _meta(300, 256, dtype=torch.bfloat16),
    lambda: _meta(1, 1000, dtype=torch.bfloat16),            # single row
    lambda: _meta(300, 136, dtype=torch.bfloat16)[:, :130],  # pitch 272 B
    lambda: _meta(300, 256, dtype=torch.bfloat16)[:, 8:72],  # base 16 B in
    lambda: _meta(64, 256, dtype=torch.bfloat16)[8:],        # row offset
], ids=["square", "width_256", "single_row", "padded_rows", "column_slice",
        "row_offset"])
def test_bf16_operands_tma_reads_in_place(make):
    t = make()
    assert tma_ready(t)
    got, ld = tma_operand(t)
    assert got is t and ld == t.stride(0)


@pytest.mark.parametrize("make,pitch", [
    (lambda: _meta(200, 170, dtype=torch.bfloat16), 176),    # N = 170
    (lambda: _meta(1000, 3, dtype=torch.bfloat16), 8),       # N = 3
    (lambda: _offset(300, 256, dtype=torch.bfloat16), 256),  # base 2 B in
    (lambda: _meta(300, 257, dtype=torch.bfloat16)[:, :256], 256),
    (lambda: _meta(256, 300, dtype=torch.bfloat16).t(), 256),
    (lambda: _meta(1, 256, dtype=torch.bfloat16).expand(64, 256), 256),
], ids=["width_170", "width_3", "odd_base", "odd_pitch", "last_axis_strided",
        "expanded_rows"])
def test_bf16_operands_copied_to_a_16_byte_pitch(make, pitch):
    t = make()
    assert not tma_ready(t)
    got, ld = tma_operand(t)
    assert got is not t and got.shape == t.shape and got.stride() == (pitch, 1)
    assert ld == pitch and ld * 2 % 16 == 0
    assert got.data_ptr() % 16 == 0 and tma_ready(got)


def test_pitched_copy_keeps_the_values():
    x = torch.arange(7 * 171, dtype=torch.float32).view(7, 171)
    t = x.bfloat16()[:, 1:]
    got, ld = tma_operand(t)
    assert ld == 176 and torch.equal(got, t)


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((37, 19), np.float32))
    b = torch.from_numpy(rng.standard_normal((19, 23), np.float32))
    before = [kern.launches for kern in KERNELS]
    for x, y in ((a, b), (a[:, 1:], b[1:]), (a.bfloat16(), b.bfloat16())):
        assert torch.equal(matmul(x, y), ref.matmul(x, y))
    assert [kern.launches for kern in KERNELS] == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_path_evaluates_on_meta_tensors(dtype):
    a = _offset(300, 200, dtype=dtype)
    b = _meta(200, 170, dtype=dtype)
    out = ops.matmul(a, b)
    assert out.is_meta and out.shape == (300, 170) and out.dtype == dtype


@pytest.mark.parametrize("m,n,tile", [
    (4096, 4096, 256),     # the bf16 m_mult: 512 blocks of 128x256
    (512, 512, 128),       # 8 blocks of 128x256
    (128 * 11, 256 * 12, 256),   # exactly 132 blocks
    (128 * 11, 256 * 11, 128),   # 121 blocks
    (1, 3, 128),
], ids=["m_mult", "quickstart", "one_wave", "below_one_wave", "tiny"])
def test_bf16_tile_for_the_grid(m, n, tile):
    assert bf16_tile(m, n, H100_SMS) == tile
    assert tile in BF16_TILES


def test_every_instantiation_is_listed():
    assert len(INSTANTIATIONS) == 10
    assert sum(name.startswith("f32") for name in INSTANTIATIONS) == 8
    assert all(name.startswith("bf16") for name in INSTANTIATIONS[8:])

"""Which q/k/v tensors B6's kernels read where they lie, and how.

The bf16 kernel loads its tiles by TMA, which needs the base address and
the outer strides on 16 bytes and the last axis contiguous. The wrapper's
:func:`kernel_operand` passes such tensors through and copies the others
to a contiguous tensor, so every shape still reaches the kernel. The f32
kernel reads any tensor whose last axis is contiguous: 16 bytes a thread
where the base and strides allow it, else 4 bytes a thread
(:func:`f32_vector_loads`); its query tile is chosen by
:func:`f32_query_tile`. These tests run those decisions on ``meta`` and
CPU tensors; the kernels themselves are held in
``tests/test_torch_cuda.py`` on the card.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import KERNELS, ref
from repro_torch.kernels.flash_attention import (F32_QUERY_TILES, HEAD_DIMS,
                                                 MAX_KERNEL_WIDTH,
                                                 SLAB_WIDTHS,
                                                 f32_query_tile,
                                                 f32_query_tiles,
                                                 f32_vector_loads,
                                                 flash_attention,
                                                 kernel_operand, kernel_slabs,
                                                 kernel_width, tma_ready)

#: the H100's streaming multiprocessors
H100_SMS = 132


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _bshd(b, s, h, d, dtype=torch.bfloat16):
    """The model's layout: a [B,S,H,D] projection seen as [B,H,S,D]."""
    return _meta(b, s, h, d, dtype=dtype).transpose(1, 2)


@pytest.mark.parametrize("make", [
    lambda: _meta(2, 16, 300, 128),                # contiguous
    lambda: _bshd(2, 300, 16, 128),                # the model's q view
    lambda: _bshd(2, 300, 8, 16),                  # D = 16: 32-byte rows
    lambda: _meta(1, 1, 1, 64),                    # every outer axis 1
    lambda: torch.empty_strided((2, 8, 1, 64), (512, 64, 7, 1),
                                dtype=torch.bfloat16, device="meta"),
    lambda: _meta(2, 16, 300, 136)[..., :128],     # padded rows, 272 B
    lambda: _meta(2, 16, 300, 128)[:, :, 64:],     # offset by whole rows
    lambda: _meta(2, 16, 300, 128)[..., 8:72],     # base 16 B in
    lambda: _bshd(1, 4096, 16, 256),               # recurrentgemma-9b's q
    lambda: _bshd(1, 4096, 1, 256),                # its one K/V head
    lambda: _bshd(1, 2048, 96, 192),               # nemotron-4-340b's q
    lambda: _bshd(1, 2048, 8, 192),                # its 8 K/V heads
], ids=["contiguous", "bshd", "bshd_d16", "single_row", "length_one_axis",
        "padded_rows", "row_offset", "column_slice", "bshd_d256",
        "bshd_d256_mqa", "bshd_d192", "bshd_d192_gqa"])
def test_tma_ready_tensors_pass_through(make):
    t = make()
    assert tma_ready(t)
    assert kernel_operand(t) is t


@pytest.mark.parametrize("make", [
    lambda: _meta(2, 16, 300, 129)[..., :128],     # rows of 258 bytes
    lambda: _meta(2 * 16 * 300 * 128 + 1)[1:].view(2, 16, 300, 128),
    lambda: _meta(2, 16, 300, 128)[..., 1:65],     # base 2 bytes off
    lambda: _meta(2, 16, 128, 300).transpose(2, 3),    # last axis strided
    lambda: _meta(2, 1, 300, 128).expand(2, 8, 300, 128),  # stride 0
], ids=["odd_row_stride", "odd_base", "misaligned_base", "last_axis_strided",
        "expanded_heads"])
def test_other_tensors_are_copied_contiguous(make):
    t = make()
    assert not tma_ready(t)
    out = kernel_operand(t)
    assert out is not t and out.is_contiguous() and out.shape == t.shape
    assert out.data_ptr() % 16 == 0 and tma_ready(out)


def test_f32_operands_only_need_a_contiguous_last_axis():
    """The f32 SIMT kernel reads through strides of any alignment."""
    odd = _meta(2, 16, 300, 129, dtype=torch.float32)[..., :128]
    assert kernel_operand(odd) is odd
    strided = _meta(2, 16, 128, 300, dtype=torch.float32).transpose(2, 3)
    assert kernel_operand(strided).is_contiguous()


def _f32(*shape):
    return _meta(*shape, dtype=torch.float32)


@pytest.mark.parametrize("make,vector", [
    (lambda: _f32(2, 16, 300, 128), True),                   # contiguous
    (lambda: _bshd(2, 300, 16, 128, dtype=torch.float32), True),  # model's q
    (lambda: _bshd(2, 300, 8, 16, dtype=torch.float32), True),    # D = 16
    (lambda: _f32(2, 16, 300, 132)[..., :128], True),        # rows of 528 B
    (lambda: _f32(2, 16, 300, 128)[:, :, 64:], True),        # whole rows in
    (lambda: _f32(2, 16, 300, 128)[..., 4:68], True),        # base 16 B in
    (lambda: _f32(2, 1, 300, 128).expand(2, 8, 300, 128), True),  # stride 0
    (lambda: torch.empty_strided((1, 1, 1, 64), (7, 7, 7, 1),
                                 dtype=torch.float32, device="meta"), True),
    (lambda: _f32(2, 16, 300, 129)[..., :128], False),       # rows of 516 B
    (lambda: _f32(2, 16, 300, 130)[..., :128], False),       # rows of 520 B
    (lambda: _f32(2 * 16 * 300 * 128 + 1)[1:].view(2, 16, 300, 128), False),
    (lambda: _f32(2, 16, 300, 128)[..., 1:65], False),       # base 4 B off
    (lambda: torch.empty_strided((2, 4, 300, 64), (4 * 19201, 19201, 64, 1),
                                 dtype=torch.float32, device="meta"), False),
    (lambda: _bshd(1, 4096, 16, 256, dtype=torch.float32), True),  # D = 256
    (lambda: _f32(1, 2, 300, 257)[..., :256], False),        # rows of 1028 B
], ids=["contiguous", "bshd", "bshd_d16", "padded_rows", "row_offset",
        "column_slice", "expanded_heads", "single_row", "odd_row_stride",
        "row_stride_8_bytes_off", "odd_base", "misaligned_base",
        "head_stride_off", "bshd_d256", "odd_row_stride_d256"])
def test_f32_copy_width_follows_base_and_strides(make, vector):
    """16-byte copies where the base and every outer stride of an axis
    longer than 1 are on 16 bytes, 4-byte copies elsewhere; never a
    copy of the tensor."""
    t = make()
    assert f32_vector_loads(t) is vector
    assert kernel_operand(t) is t


@pytest.mark.parametrize("batch,heads,sq,tile", [
    (1, 16, 4096, 128),     # the qwen3-1.7b layer: 512 blocks
    (2, 16, 2048, 128),     # the bf16 prefill's launch: 512 blocks
    (1, 16, 512, 64),       # the f32 prefill's launch: 64 blocks at 128
    (1, 1, 4096, 64),       # one head: 32 blocks at 128
    (1, 132, 128, 128),     # one 128-row tile on every SM
    (1, 131, 128, 64),      # one SM short
    (4, 1, 4225, 128),      # ragged: 4 x 34 tiles
])
def test_f32_query_tile_fills_the_card(batch, heads, sq, tile):
    assert tile in F32_QUERY_TILES
    assert f32_query_tile(batch, heads, sq, H100_SMS) == tile


@pytest.mark.parametrize("batch,heads,sq", [
    (1, 16, 4096),          # the recurrentgemma-9b layer: 512 blocks at 128
    (1, 132, 128),          # one 128-row tile on every SM
    (1, 2, 300),            # a small grid
])
def test_f32_query_tile_is_64_rows_at_head_dim_256(batch, heads, sq):
    """At D = 256 a 128-row tile does not fit in shared memory: only the
    64-row tile is built, whatever the grid."""
    assert f32_query_tiles(256) == (64,)
    assert f32_query_tiles(128) == F32_QUERY_TILES
    assert f32_query_tile(batch, heads, sq, H100_SMS, 256) == 64


def test_f32_query_tile_is_64_rows_at_head_dim_192():
    """At D = 192 a 128-row tile would take 242 KB of shared memory: only
    the 64-row tile is built, also for nemotron-4-340b's 1 x 96-head x
    2048 layer, whose 128-row grid would fill the card."""
    assert f32_query_tiles(192) == (64,)
    assert f32_query_tile(1, 96, 2048, H100_SMS, 192) == 64


def test_copied_operand_keeps_the_values():
    x = torch.arange(2 * 3 * 5 * 17, dtype=torch.float32).view(2, 3, 5, 17)
    t = x.bfloat16()[..., 1:]
    assert not tma_ready(t)
    assert torch.equal(kernel_operand(t), t)


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, np.float32)).bfloat16()
               for s in ((1, 4, 40, 64), (1, 2, 40, 64), (1, 2, 40, 64)))
    # a head dim outside HEAD_DIMS, strided: the CPU takes any
    q, k, v = q[..., :32], k[..., :32], v[..., :32]
    before = [kern.launches for kern in KERNELS]
    got = flash_attention(q, k, v, causal=True)
    assert [kern.launches for kern in KERNELS] == before
    assert torch.equal(got, ref.flash_attention(q, k, v, causal=True))


@pytest.mark.parametrize("d", [272, 320, 512])
def test_head_dim_outside_the_kernels_raises(d):
    """A head dim past the widest kernel no longer raises: it runs in
    slabs, and the kernel path on ``meta`` tensors gives q's shape, the
    first d columns of rows n w wide."""
    assert d > MAX_KERNEL_WIDTH
    n, w = kernel_slabs(d)
    for dtype in (torch.bfloat16, torch.float32):
        q, kv = _meta(1, 4, 64, d, dtype=dtype), _meta(1, 2, 64, d, dtype=dtype)
        out = flash_attention(q, kv, kv)
        assert out.is_meta and out.shape == q.shape and out.dtype == dtype
        assert out.stride(2) == n * w and n * w >= d


@pytest.mark.parametrize("d,width", [
    (1, 16), (16, 16), (17, 32), (32, 32), (33, 64), (64, 64), (65, 96),
    (72, 96), (80, 96), (96, 96), (97, 128), (128, 128), (129, 160),
    (160, 160), (161, 192), (192, 192), (193, 256), (250, 256), (256, 256)])
def test_kernel_width_is_the_next_width_up(d, width):
    assert width in HEAD_DIMS and kernel_width(d) == width
    assert kernel_slabs(d) == (1, width)


@pytest.mark.parametrize("d,slabs", [
    (257, (2, 160)), (300, (2, 160)), (320, (2, 160)), (384, (2, 192)),
    (385, (3, 160)), (448, (3, 160)), (512, (2, 256)), (640, (4, 160)),
    (896, (7, 128)), (1024, (4, 256)), (4096, (16, 256))])
def test_head_dims_above_256_run_in_slabs(d, slabs):
    """Above the widest kernel a head dim runs in n slabs of one width w:
    the fewest columns n w >= d, a tie to the fewer slabs (640 on 4 x 160,
    not 5 x 128)."""
    assert kernel_slabs(d) == slabs and kernel_width(d) == slabs[1]


def test_every_head_dim_up_to_256_has_a_width_and_no_other():
    """The slab plan of every head dim from 1 to 1024: up to 256 one slab
    of the smallest width not below it (under 2x wide above 16, under
    1.5x above 64), as before slabs; above 256 n slabs of a width of
    SLAB_WIDTHS whose n w columns cover it, none fewer, at most 1.25x wide
    (to 4096); 0 raises."""
    for d in range(1, MAX_KERNEL_WIDTH + 1):
        n, w = kernel_slabs(d)
        assert n == 1 and w >= d and not [x for x in HEAD_DIMS if d <= x < w]
        assert d <= 16 or w < 2 * d
        assert d <= 64 or w < 1.5 * d
    for d in range(MAX_KERNEL_WIDTH + 1, 4097):
        n, w = kernel_slabs(d)
        assert w in SLAB_WIDTHS and w in HEAD_DIMS and (n - 1) * w < d <= n * w
        assert n * w == min(-(-d // x) * x for x in SLAB_WIDTHS)
        assert n * w <= 1.25 * d, d
    for d in (0, -1):
        with pytest.raises(ValueError, match="head dims >= 1"):
            kernel_slabs(d)


@pytest.mark.parametrize("d", [1, 20, 33, 100, 250, 255])
def test_bf16_rows_off_16_bytes_are_copied_to_a_16_byte_pitch(d):
    """A bf16 head dim that is no multiple of 8 gives rows off TMA's 16
    bytes: q, k, v are copied to rows at a pitch of the head dim rounded
    up to 8 elements, and the kernel reads the view of their d columns."""
    for t in (_meta(2, 4, 300, d), _bshd(2, 300, 4, d)):
        assert not tma_ready(t)
        out = kernel_operand(t)
        assert out.shape == t.shape and out.stride(-1) == 1
        assert out.stride(2) == -(-d // 8) * 8 and tma_ready(out)
        assert out.stride(1) == 300 * out.stride(2)


def test_pitch_copy_keeps_the_values():
    x = torch.arange(2 * 3 * 5 * 33, dtype=torch.float32).view(2, 3, 5, 33)
    t = x.bfloat16()
    out = kernel_operand(t)
    assert out.stride(2) == 40 and torch.equal(out, t)


def test_a_single_bf16_row_of_any_width_is_read_where_it_lies():
    """With every outer axis of length 1 no row pitch is read (the kernel
    supplies a 16-byte one), so nothing is copied."""
    t = _meta(1, 1, 1, 33)
    assert tma_ready(t) and kernel_operand(t) is t


def test_f32_head_dims_off_4_floats_take_4_byte_copies():
    """A row of D floats ends inside a 16-byte chunk unless 4 divides D:
    4-byte copies, also for a single row."""
    for t in (_f32(2, 4, 300, 33), _f32(1, 1, 1, 33), _f32(1, 1, 1, 2)):
        assert not f32_vector_loads(t) and kernel_operand(t) is t
    assert f32_vector_loads(_f32(2, 4, 300, 72))
    assert f32_vector_loads(_f32(1, 1, 1, 100))


@pytest.mark.parametrize("d,tiles", [(32, F32_QUERY_TILES),
                                     (100, F32_QUERY_TILES),
                                     (129, (64,)), (160, (64,)),
                                     (320, (64,)), (896, (64,))])
def test_f32_query_tiles_follow_the_width(d, tiles):
    """The f32 query tiles are those of the width a head dim runs on: 128
    rows up to width 128, 64 rows above (160's O would not fit in
    registers) and in slabs, also of width 128 (896 on 7 x 128)."""
    assert f32_query_tiles(d) == tiles
    assert f32_query_tile(1, 132, 128, H100_SMS, d) == tiles[0]


@pytest.mark.parametrize("d", HEAD_DIMS + (1, 33, 72, 80, 100, 250, 257,
                                          320, 500, 512, 1024))
def test_kernel_path_evaluates_on_meta_tensors(d):
    """The output is the first d columns of rows of the kernel's width, n
    slabs of it above 256: contiguous where they are d wide, a view of
    padded rows elsewhere."""
    q, kv = _bshd(2, 100, 8, d), _bshd(2, 70, 2, d)
    out = flash_attention(q, kv, kv, causal=True, window=16)
    n, w = kernel_slabs(d)
    assert out.is_meta and out.shape == q.shape
    assert out.stride() == (8 * 100 * n * w, 100 * n * w, n * w, 1)
    assert out.is_contiguous() == (n * w == d)

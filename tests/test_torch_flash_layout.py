"""Which q/k/v tensors B6's bf16 kernel reads where they lie.

The bf16 kernel loads its tiles by TMA, which needs the base address and
the outer strides on 16 bytes and the last axis contiguous. The wrapper's
:func:`kernel_operand` passes such tensors through and copies the others
to a contiguous tensor, so every shape still reaches the kernel. These
tests run that decision on ``meta`` and CPU tensors; the kernel itself is
held in ``tests/test_torch_cuda.py`` on the card.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import KERNELS, ref
from repro_torch.kernels.flash_attention import (HEAD_DIMS, flash_attention,
                                                 kernel_operand, tma_ready)


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
], ids=["contiguous", "bshd", "bshd_d16", "single_row", "length_one_axis",
        "padded_rows", "row_offset", "column_slice"])
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


@pytest.mark.parametrize("d", [32, 96, 256])
def test_head_dim_outside_the_kernels_raises(d):
    assert d not in HEAD_DIMS
    q, kv = _meta(1, 4, 64, d), _meta(1, 2, 64, d)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(q, kv, kv)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_kernel_path_evaluates_on_meta_tensors(d):
    q, kv = _bshd(2, 100, 8, d), _bshd(2, 70, 2, d)
    out = flash_attention(q, kv, kv, causal=True, window=16)
    assert out.is_meta and out.shape == q.shape and out.is_contiguous()

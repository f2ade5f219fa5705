"""The port's kernel layer against the JAX package's Pallas kernels.

The same numpy inputs, made from a seed, go through the Pallas kernel
(interpreted on the CPU, as ``tests/test_kernels.py`` runs it) and through
the port's wrapper, which on a CPU tensor takes the kernel's plain
PyTorch version. Integer kernels must agree bit for bit; the matrix
product within the tolerances of ``tests/test_kernels.py`` (2e-5 for f32,
2e-2 for bf16, compared in f32).

The hand-written kernels themselves run only on a card: see
``tests/test_torch_cuda.py`` and ``python3 chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.radix_sort import pallas_radix_pass
from repro.kernels.stream_compact import pallas_local_compact
from repro.kernels.wah import pallas_wah_interleave
from repro_torch.convert import from_jax_arrays
from repro_torch.kernels import KERNELS, ops, ref
from repro_torch.kernels.matmul import matmul
from repro_torch.kernels.radix_sort import radix_pass
from repro_torch.kernels.stream_compact import local_compact
from repro_torch.kernels.wah import wah_interleave


def _u32(rng, n, density=1.0):
    x = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    return x * (rng.random(n) < density)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ----------------------------------------------------------------------------
# B3 radix pass
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("n,bs", [(256, 256), (1024, 256), (1024, 512)])
@pytest.mark.parametrize("bits,shift", [(8, 0), (8, 24), (4, 12)])
def test_radix_pass_matches_pallas(n, bs, bits, shift):
    keys = _u32(np.random.default_rng(n + shift), n)
    j_hist, j_rank = pallas_radix_pass(jnp.asarray(keys), bs=bs, bits=bits,
                                       shift=shift, interpret=True)
    hist, rank = radix_pass(_t(keys), bs=bs, bits=bits, shift=shift)
    assert hist.dtype == rank.dtype == torch.int32
    np.testing.assert_array_equal(hist.numpy(), np.asarray(j_hist))
    np.testing.assert_array_equal(rank.numpy(), np.asarray(j_rank))


def test_radix_pass_ragged_tail_counts_nowhere():
    keys = _u32(np.random.default_rng(3), 300)
    hist, rank = ref.radix_pass(_t(keys), bs=256)
    assert hist.shape == (2, 256) and int(hist.sum()) == 300
    assert (rank[1, 300 - 256:] == 0).all()
    full_hist, full_rank = ref.radix_pass(_t(keys[:256]), bs=256)
    assert torch.equal(hist[0], full_hist[0]) and torch.equal(rank[0], full_rank[0])


# ----------------------------------------------------------------------------
# B4 local compaction
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("n,bs", [(256, 256), (1024, 256), (2048, 512)])
@pytest.mark.parametrize("density,drop", [(0.0, 0), (0.3, 0), (1.0, 0),
                                          (0.5, 7)])
def test_local_compact_matches_pallas(n, bs, density, drop):
    rng = np.random.default_rng(n)
    x = _u32(rng, n, density)
    if drop:
        x = np.where(rng.random(n) < 0.5, np.uint32(drop), x).astype(np.uint32)
    j_blocks, j_counts = pallas_local_compact(jnp.asarray(x), bs=bs,
                                              drop_value=drop, interpret=True)
    blocks, counts = local_compact(_t(x), bs=bs, drop_value=drop)
    assert blocks.dtype == torch.uint32 and counts.dtype == torch.int32
    np.testing.assert_array_equal(blocks.numpy(), np.asarray(j_blocks))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(j_counts))


# ----------------------------------------------------------------------------
# B5 interleave
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("n,bs", [(512, 512), (2048, 512), (1024, 256)])
def test_wah_interleave_matches_pallas(n, bs):
    rng = np.random.default_rng(n)
    f, l = _u32(rng, n), _u32(rng, n)
    want = pallas_wah_interleave(jnp.asarray(f), jnp.asarray(l), bs=bs,
                                 interpret=True)
    got = wah_interleave(_t(f), _t(l))
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------------------------------------
# B1 matmul
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (256, 384, 128),
                                   (128, 256, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_matches_pallas(m, k, n, dtype):
    rng = np.random.default_rng(m + k + n)
    jdt = np.float32 if dtype == "float32" else jnp.bfloat16
    a = rng.standard_normal((m, k), np.float32).astype(jdt)
    b = rng.standard_normal((k, n), np.float32).astype(jdt)
    want = jops.matmul(jnp.asarray(a), jnp.asarray(b), impl="pallas")
    ta, tb = from_jax_arrays((a, b), device="cpu")
    got = matmul(ta, tb)
    assert got.dtype == getattr(torch, dtype)
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


def test_matmul_ragged_shape_takes_no_other_path():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((100, 77), np.float32)
    b = rng.standard_normal((77, 130), np.float32)
    got = ops.matmul(_t(a), _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jref.matmul(jnp.asarray(a), jnp.asarray(b))), rtol=2e-5, atol=2e-5)


# ----------------------------------------------------------------------------
# ops: full sort and compaction
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("n", [256, 1024, 4096])
@pytest.mark.parametrize("bits", [4, 8])
def test_radix_sort_matches_jax(n, bits):
    keys = _u32(np.random.default_rng(n * bits), n)
    vals = np.arange(n, dtype=np.int32)
    j_k, j_v = jops.radix_sort(jnp.asarray(keys), jnp.asarray(vals),
                               bits_per_pass=bits, impl="pallas")
    k, v = ops.radix_sort(_t(keys), _t(vals), bits_per_pass=bits)
    np.testing.assert_array_equal(k.numpy(), np.asarray(j_k))
    np.testing.assert_array_equal(v.numpy(), np.asarray(j_v))
    np.testing.assert_array_equal(k.numpy(), np.sort(keys))


def test_radix_sort_stability():
    """Equal keys keep input order (the WAH build depends on it)."""
    keys = np.array([3, 1, 3, 1, 2, 3, 1, 2] * 32, np.uint32)
    _, vp = ops.radix_sort(_t(keys), torch.arange(keys.size, dtype=torch.int32))
    vp = vp.numpy()
    for key in (1, 2, 3):
        positions = vp[np.sort(np.flatnonzero(keys[vp] == key))]
        assert (np.diff(positions) > 0).all()


def test_radix_sort_16bit_takes_the_plain_sort():
    keys = _u32(np.random.default_rng(9), 512)
    got = ops.radix_sort(_t(keys), bits_per_pass=16)
    np.testing.assert_array_equal(got.numpy(), np.sort(keys))


@pytest.mark.parametrize("n", [256, 1024, 2048])
@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("impl", ["auto", "ref"])
def test_stream_compact_matches_jax(n, density, impl):
    x = _u32(np.random.default_rng(n), n, density)
    j_out, j_cnt = jops.stream_compact(jnp.asarray(x), impl="pallas")
    out, cnt = ops.stream_compact(_t(x), impl=impl)
    assert int(cnt) == int(j_cnt) == int((x != 0).sum())
    assert out.dtype == torch.uint32 and cnt.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(j_out))


def test_ops_reject_unknown_impl():
    x = torch.zeros(256, dtype=torch.uint32)
    with pytest.raises(ValueError):
        ops.stream_compact(x, impl="pallas")


# ----------------------------------------------------------------------------
# dispatch by the tensor's device; abstract evaluation on meta tensors
# ----------------------------------------------------------------------------
def test_cpu_tensors_never_launch_a_kernel():
    before = [k.launches for k in KERNELS]
    x = _t(_u32(np.random.default_rng(1), 512))
    ops.radix_sort(x)
    ops.stream_compact(x)
    ops.wah_interleave(x, x)
    ops.matmul(torch.ones(4, 4), torch.ones(4, 4))
    assert [k.launches for k in KERNELS] == before


@pytest.mark.parametrize("fn,args,shapes", [
    (lambda a, b: ops.matmul(a, b),
     [((3, 4), torch.float32), ((4, 5), torch.float32)], [(3, 5)]),
    (lambda x: radix_pass(x, bits=8),
     [((1000,), torch.uint32)], [(4, 256), (4, 256)]),
    (lambda x: local_compact(x), [((512,), torch.uint32)], [(2, 256), (2, 1)]),
    (lambda f, l: ops.wah_interleave(f, l),
     [((8,), torch.uint32), ((8,), torch.uint32)], [(16,)]),
])
def test_kernels_evaluate_on_meta_tensors(fn, args, shapes):
    metas = [torch.empty(s, dtype=d, device="meta") for s, d in args]
    out = fn(*metas)
    out = out if isinstance(out, tuple) else (out,)
    assert [tuple(o.shape) for o in out] == shapes
    assert all(o.is_meta for o in out)


def test_kernel_wrappers_refuse_a_cpu_tensor_at_the_kernel():
    """The custom ops hold the CUDA kernels only: a CPU tensor that
    reaches one raises instead of computing anything."""
    from repro_torch.kernels.matmul import _matmul_cuda
    with pytest.raises(ValueError, match="CUDA"):
        _matmul_cuda(torch.ones(2, 2), torch.ones(2, 2))


@pytest.mark.parametrize("bad", [
    lambda: radix_pass(torch.zeros(8, dtype=torch.int32)),
    lambda: radix_pass(torch.zeros(8, dtype=torch.uint32), bits=9),
    lambda: local_compact(torch.zeros(8, dtype=torch.uint32), bs=100),
    lambda: wah_interleave(torch.zeros(8, dtype=torch.uint32),
                           torch.zeros(4, dtype=torch.uint32)),
])
def test_kernel_wrappers_validate_inputs(bad):
    with pytest.raises((TypeError, ValueError)):
        bad()


def test_convert_keeps_uint32_and_bfloat16_exactly():
    rng = np.random.default_rng(2)
    u = _u32(rng, 64)
    bf = jnp.asarray(rng.standard_normal(64, np.float32), jnp.bfloat16)
    tu, tbf, none = from_jax_arrays((u, bf, None), device="cpu")
    assert tu.dtype == torch.uint32 and none is None
    np.testing.assert_array_equal(tu.numpy(), u)
    assert tbf.dtype == torch.bfloat16
    np.testing.assert_array_equal(tbf.float().numpy(),
                                  np.asarray(bf, np.float32))

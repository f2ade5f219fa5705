"""Two contracts where the port and the JAX package part on purpose, with
both of the port's paths (``impl="auto"`` and ``"ref"``) agreeing.

C1: ``ops.radix_sort`` refuses a payload that is not 1-d. The JAX package
takes ``jnp.take(values, idx)`` with no axis, which reads a payload of
rows flattened: its result has the keys' length and mixes the rows' first
elements. C2: ``ops.stream_compact`` takes 32-bit integer words; float32
raises ``TypeError`` on both paths, and uint32 and int32 still equal the
JAX package.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops

IMPLS = ("auto", "ref")


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("n", [256, 1000])
def test_radix_sort_refuses_a_payload_of_rows(impl, n):
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    rows = rng.integers(0, 9, (n, 3)).astype(np.int32)
    with pytest.raises(ValueError, match="1-d payload"):
        ops.radix_sort(torch.from_numpy(keys), torch.from_numpy(rows),
                       impl=impl)
    # what the JAX package gives instead: the flattened payload taken at
    # the sorted positions, not the rows
    _, j_v = jops.radix_sort(jnp.asarray(keys), jnp.asarray(rows))
    order = np.argsort(keys, kind="stable")
    assert np.asarray(j_v).shape == (n,)
    np.testing.assert_array_equal(np.asarray(j_v), rows.ravel()[order])
    # a 1-d payload still sorts on both paths, equal to the JAX package
    k, v = ops.radix_sort(torch.from_numpy(keys),
                          torch.from_numpy(rows[:, 0].copy()), impl=impl)
    j_k, j_v = jops.radix_sort(jnp.asarray(keys), jnp.asarray(rows[:, 0]))
    np.testing.assert_array_equal(k.numpy(), np.asarray(j_k))
    np.testing.assert_array_equal(v.numpy(), np.asarray(j_v))


@pytest.mark.parametrize("impl", IMPLS)
def test_stream_compact_refuses_float32(impl):
    x = np.tile(np.array([0.5, 1.5, 0.0, -0.0, 2.0, 0.25, 3.0, 1.0],
                         np.float32), 32)
    with pytest.raises(TypeError, match="int32"):
        ops.stream_compact(torch.from_numpy(x), impl=impl)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("dtype", [np.uint32, np.int32])
@pytest.mark.parametrize("drop", [0, 2])
def test_stream_compact_on_32_bit_words_matches_jax(impl, dtype, drop):
    rng = np.random.default_rng(3)
    x = (rng.integers(0, 4, 512) * rng.integers(1, 1000, 512)).astype(dtype)
    j_out, j_cnt = jops.stream_compact(jnp.asarray(x), drop_value=drop)
    out, cnt = ops.stream_compact(torch.from_numpy(x), drop_value=drop,
                                  impl=impl)
    assert out.dtype == torch.from_numpy(x).dtype
    assert int(cnt) == int(j_cnt) == int((x != drop).sum())
    np.testing.assert_array_equal(out.numpy(), np.asarray(j_out))

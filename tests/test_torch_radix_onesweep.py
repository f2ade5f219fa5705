"""B3's sort entries on the CPU: the plain versions of ``radix_histogram``
and ``radix_onesweep``, and ``ops.radix_sort`` built from them, against
numpy and the JAX package.

The same numpy keys, made from a seed, go through numpy (``bincount``, a
stable ``argsort``), the JAX package's ``ops.radix_sort`` (its Pallas pass
interpreted, or its oracle at a ragged length) and the port. Everything is
integer and must agree bit for bit. The kernels themselves run only on a
card: ``tests/test_torch_cuda.py`` and ``python3 chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import KERNELS, ops
from repro_torch.kernels.radix_sort import (TILE, radix_histogram,
                                            radix_onesweep)

DISTRIBUTIONS = ("random", "equal", "two_digits", "sorted", "reversed")


def _keys(dist, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    if dist == "equal":
        return np.full(n, 0x9E3779B9, np.uint32)
    if dist == "two_digits":
        return rng.choice(np.array([0x01234567, 0xFEDCBA98], np.uint32), n)
    if dist == "sorted":
        return np.sort(x)
    if dist == "reversed":
        return np.sort(x)[::-1].copy()
    return x


def _digits(keys, bits, shift):
    return (keys.astype(np.int64) >> shift) & ((1 << bits) - 1)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("dist", ["random", "equal", "two_digits"])
def test_radix_histogram_counts_each_pass(bits, dist):
    keys = _keys(dist, 5000, bits)
    hist = radix_histogram(torch.from_numpy(keys), bits=bits)
    assert hist.dtype == torch.int32 and hist.shape == (32 // bits, 1 << bits)
    for p in range(32 // bits):
        np.testing.assert_array_equal(
            hist[p].numpy(),
            np.bincount(_digits(keys, bits, p * bits), minlength=1 << bits))


@pytest.mark.parametrize("n", [1, 255, 257, TILE + 1])
@pytest.mark.parametrize("dist", DISTRIBUTIONS)
@pytest.mark.parametrize("bits,shift", [(8, 0), (8, 24), (4, 12)])
def test_radix_onesweep_is_a_stable_digit_pass(n, dist, bits, shift):
    keys = _keys(dist, n, n + shift)
    idx = np.random.default_rng(n).permutation(n).astype(np.int32)
    digits = _digits(keys, bits, shift)
    counts = torch.from_numpy(np.bincount(digits, minlength=1 << bits)
                              .astype(np.int32))
    got_k, got_i = radix_onesweep(torch.from_numpy(keys),
                                  torch.from_numpy(idx), counts, bits, shift)
    order = np.argsort(digits, kind="stable")
    assert got_k.dtype == torch.uint32 and got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_k.numpy(), keys[order])
    np.testing.assert_array_equal(got_i.numpy(), idx[order])


def test_radix_onesweep_without_a_payload_carries_the_positions():
    keys = _keys("random", 3000, 4)
    counts = radix_histogram(torch.from_numpy(keys))[1]
    got_k, got_i = radix_onesweep(torch.from_numpy(keys), None, counts, 8, 8)
    order = np.argsort(_digits(keys, 8, 8), kind="stable")
    np.testing.assert_array_equal(got_k.numpy(), keys[order])
    assert got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_i.numpy(), order)


def test_radix_onesweep_refuses_counts_of_other_keys():
    keys = _keys("random", 300, 1)
    idx = torch.arange(300, dtype=torch.int32)
    wrong = radix_histogram(torch.from_numpy(keys + 1))[0]
    keys = torch.from_numpy(keys)
    with pytest.raises(ValueError, match="histogram"):
        radix_onesweep(keys, idx, wrong)


@pytest.mark.parametrize("n", [256, 1024, 4096])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("dist", ["random", "card64"])
def test_radix_sort_matches_jax_pallas(n, bits, dist):
    rng = np.random.default_rng(n + bits)
    keys = (rng.integers(0, 64, n).astype(np.uint32) if dist == "card64"
            else _keys(dist, n, n + bits))
    vals = rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32)
    j_k, j_v = jops.radix_sort(jnp.asarray(keys), jnp.asarray(vals),
                               bits_per_pass=bits, impl="pallas")
    k, v = ops.radix_sort(torch.from_numpy(keys), torch.from_numpy(vals),
                          bits_per_pass=bits)
    np.testing.assert_array_equal(k.numpy(), np.asarray(j_k))
    np.testing.assert_array_equal(v.numpy(), np.asarray(j_v))


@pytest.mark.parametrize("bits", [4, 8])
def test_radix_sort_matches_the_jax_oracle_at_a_ragged_length(bits):
    """At a length that no 256-key block divides, the JAX wrapper takes
    its oracle; the port runs its onesweep passes all the same."""
    keys = _keys("random", 1000, bits)
    vals = np.arange(1000, dtype=np.int32)[::-1].copy()
    j_k, j_v = jref.radix_sort_u32(jnp.asarray(keys), jnp.asarray(vals),
                                   bits_per_pass=bits)
    k, v = ops.radix_sort(torch.from_numpy(keys), torch.from_numpy(vals),
                          bits_per_pass=bits)
    np.testing.assert_array_equal(k.numpy(), np.asarray(j_k))
    np.testing.assert_array_equal(v.numpy(), np.asarray(j_v))


@pytest.mark.parametrize("layout", ["int64", "float32", "rows"])
def test_radix_sort_payloads_carried_or_gathered(layout):
    """A 1-d payload of 32-bit words rides through the passes; any other
    1-d payload is gathered at the end by the carried index. Both equal
    numpy's stable order. A payload of rows is refused on both paths
    (``tests/test_torch_faults.py`` states the JAX package's flattened
    result it differs from)."""
    rng = np.random.default_rng(7)
    keys = rng.integers(0, 1000, 2000).astype(np.uint32)
    vals = {"int64": rng.integers(-2 ** 62, 2 ** 62, 2000),
            "float32": rng.standard_normal(2000).astype(np.float32),
            "rows": rng.integers(0, 9, (2000, 3)).astype(np.int32)}[layout]
    if layout == "rows":
        for impl in ("auto", "ref"):
            with pytest.raises(ValueError, match="1-d payload"):
                ops.radix_sort(torch.from_numpy(keys), torch.from_numpy(vals),
                               impl=impl)
        return
    k, v = ops.radix_sort(torch.from_numpy(keys), torch.from_numpy(vals))
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(k.numpy(), keys[order])
    assert v.dtype == torch.from_numpy(vals).dtype
    np.testing.assert_array_equal(v.numpy(), vals[order])


def test_radix_sort_on_the_cpu_launches_nothing():
    before = [dict(k.function_launches) for k in KERNELS]
    ops.radix_sort(torch.from_numpy(_keys("random", 3000, 2)),
                   torch.arange(3000, dtype=torch.int32))
    assert [dict(k.function_launches) for k in KERNELS] == before


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("bits", [4, 8])
def test_sort_entries_evaluate_on_meta_tensors(bits):
    n = 3 * TILE + 5
    keys = _meta((n,), torch.uint32)
    hist = radix_histogram(keys, bits=bits)
    assert hist.is_meta and hist.dtype == torch.int32
    assert tuple(hist.shape) == (32 // bits, 1 << bits)
    for idx in (_meta((n,), torch.int32), None):
        k, i = radix_onesweep(keys, idx, _meta((1 << bits,), torch.int32),
                              bits, 0)
        assert k.is_meta and i.is_meta
        assert (k.dtype, i.dtype) == (torch.uint32, torch.int32)
        assert tuple(k.shape) == tuple(i.shape) == (n,)


@pytest.mark.parametrize("bad", [
    lambda: radix_histogram(_meta((64,), torch.uint32), bits=9),
    lambda: radix_onesweep(_meta((64,), torch.uint32),
                           _meta((64,), torch.int32),
                           _meta((512,), torch.int32), 9, 0),
    lambda: radix_histogram(_meta((64,), torch.int32)),
    lambda: radix_onesweep(_meta((64,), torch.int64),
                           _meta((64,), torch.int32),
                           _meta((256,), torch.int32)),
    lambda: radix_histogram(_meta((2 ** 31,), torch.uint32)),
    lambda: radix_onesweep(_meta((2 ** 31,), torch.uint32),
                           _meta((2 ** 31,), torch.int32),
                           _meta((256,), torch.int32)),
], ids=["histogram-bits9", "onesweep-bits9", "histogram-int32",
        "onesweep-int64", "histogram-2**31", "onesweep-2**31"])
def test_sort_entries_refuse_what_the_kernels_do_not_take(bad):
    with pytest.raises(ValueError):
        bad()

"""The port's WAH index (paper §4) against the JAX package's.

The same numpy values go through ``repro.indexing.build_wah_index`` and
``repro_torch.indexing.build_wah_index`` (on the CPU, where the port's
kernel wrappers take their plain versions); words, word count, starts and
counts must agree bit for bit. The Listing 5 actor pipeline and the
``m_mult`` actor are held against their JAX counterparts the same way.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ActorSystem as JaxActorSystem
from repro.core import In as JIn
from repro.core import NDRange as JNDRange
from repro.core import Out as JOut
from repro.core import dim_vec as jdim_vec
from repro.core import kernel as jkernel
from repro.indexing import build_wah_index as jax_build_wah_index
from repro.indexing import wah_index_pipeline_actors as jax_pipeline
from repro.kernels import ops as jops
from repro_torch.core import ActorSystem, In, NDRange, Out, dim_vec, kernel
from repro_torch.core.memref import registry
from repro_torch.indexing import (build_wah_index, build_wah_index_numpy,
                                  decode_wah_bitmap,
                                  wah_index_pipeline_actors)
from repro_torch.kernels import ops


def _index_cases():
    cases = []
    for n, card, seed in [(1024, 8, 0), (4096, 64, 1), (2048, 3, 2)]:
        rng = np.random.default_rng(seed)
        cases.append((rng.integers(0, card, n).astype(np.uint32), card))
    rng = np.random.default_rng(7)
    skewed = np.clip((rng.pareto(1.5, 4096) * 3).astype(np.uint32), 0, 31)
    cases.append((skewed, 32))
    return cases


@pytest.mark.parametrize("case", range(4),
                         ids=["n1024-card8", "n4096-card64", "n2048-card3",
                              "skewed"])
@pytest.mark.parametrize("impl", ["auto", "ref"])
def test_build_wah_index_matches_jax(case, impl):
    values, card = _index_cases()[case]
    want = jax_build_wah_index(jnp.asarray(values), card)
    got = build_wah_index(torch.from_numpy(values), card, impl=impl)
    names = ("words", "n_words", "starts", "counts")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


@pytest.mark.parametrize("case", range(4))
def test_build_wah_index_round_trips_and_matches_numpy(case):
    values, card = _index_cases()[case]
    words, n_words, starts, counts = build_wah_index(torch.from_numpy(values),
                                                     card)
    words = words.numpy()[:int(n_words)]
    ref_words, ref_n, ref_starts, ref_counts = build_wah_index_numpy(values, card)
    assert int(n_words) == ref_n
    np.testing.assert_array_equal(counts.numpy(), ref_counts)
    np.testing.assert_array_equal(starts.numpy(), ref_starts)
    np.testing.assert_array_equal(words, ref_words)
    for v in range(card):
        got = decode_wah_bitmap(words, int(starts[v]), int(counts[v]))
        np.testing.assert_array_equal(got, np.flatnonzero(values == v))


def test_build_wah_index_compresses_sparse_data():
    values = np.zeros(31 * 1000, np.uint32)
    values[31 * 999] = 1
    _, _, _, counts = build_wah_index(torch.from_numpy(values), 2)
    assert int(counts[1]) == 2  # one fill (999 chunks) + one literal


def _fills_literals(k, seed):
    rng = np.random.default_rng(seed)
    fills = (rng.integers(0, 2, k) * ((1 << 31) | rng.integers(1, 100, k))
             ).astype(np.uint32)
    literals = rng.integers(1, 2 ** 31, k).astype(np.uint32)
    return fills, literals


@pytest.fixture(scope="module")
def jax_listing5():
    """The JAX pipeline's answer for the shared Listing 5 input."""
    fills, literals = _fills_literals(1024, 11)
    with JaxActorSystem(max_workers=4) as system:
        out, n = jax_pipeline(system, 1024).ask(fills, literals)
    return fills, literals, np.asarray(out), int(n)


@pytest.mark.parametrize("mode", ["staged", "fused"])
def test_listing5_pipeline_matches_jax(jax_listing5, mode):
    fills, literals, want, want_n = jax_listing5
    with ActorSystem(max_workers=4, device="cpu") as system:
        pipe = wah_index_pipeline_actors(system, 1024, mode=mode)
        before = registry.stats()
        out, n = pipe.ask(fills, literals)
        after = registry.stats()
    assert isinstance(out, np.ndarray) and out.dtype == np.uint32
    assert int(n) == want_n
    np.testing.assert_array_equal(out, want)
    # only the two final outputs come back to the host
    assert after["readbacks"] - before["readbacks"] == 2
    assert after["transfers"] == before["transfers"]
    if mode == "fused":
        assert len(pipe.plan.fused_regions) == 1
        assert len(pipe.plan.fused_regions[0]) == 3


def test_listing5_pipeline_matches_plain_compaction():
    fills, literals = _fills_literals(512, 3)
    want, want_n = ops.stream_compact(
        ops.wah_interleave(torch.from_numpy(fills), torch.from_numpy(literals),
                           impl="ref"), impl="ref")
    with ActorSystem(max_workers=2, device="cpu") as system:
        out, n = wah_index_pipeline_actors(system, 512).ask(fills, literals)
    assert int(n) == int(want_n)
    np.testing.assert_array_equal(out, want.numpy())


@pytest.mark.parametrize("n", [128, 256])
def test_m_mult_actor_matches_jax(n):
    """Paper Listings 1+2: the quickstart's ``m_mult`` actor in both
    packages, fed the same matrices."""
    rng = np.random.default_rng(n)
    m1 = rng.random((n, n), np.float32)
    m2 = rng.random((n, n), np.float32)

    j_m_mult = jkernel(JIn(jnp.float32), JIn(jnp.float32),
                       JOut(jnp.float32, shape=(n, n)),
                       nd_range=JNDRange(jdim_vec(n, n)),
                       name="m_mult")(lambda a, b: jops.matmul(a, b))
    m_mult = kernel(In(torch.float32), In(torch.float32),
                    Out(torch.float32, shape=(n, n)),
                    nd_range=NDRange(dim_vec(n, n)),
                    name="m_mult")(lambda a, b: ops.matmul(a, b))
    with JaxActorSystem(max_workers=2) as jsys:
        want = jsys.spawn(j_m_mult).ask(m1, m2)
    with ActorSystem(max_workers=2, device="cpu") as system:
        got = system.spawn(m_mult).ask(m1, m2)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, m1 @ m2, rtol=1e-4, atol=1e-4)

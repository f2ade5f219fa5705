"""The port's paged KV-cache pool and disaggregated prefill/decode on the
CPU, case for case with ``tests/test_kvpool.py``, and the paged engine
held against the JAX package's.

Covers: page alloc/release accounting against the DeviceRef registry,
write_pages/gather roundtrips, page-table two-phase append (boundary
allocation, copy-on-write at a shared tail), prefix sharing (same Page
objects, exactly-once allocation, pin survival and eviction), the
prefix-safety guarantees (AccessViolation on a sealed write — directly
and through the decode worker — and COW divergence leaving the sibling's
pages byte-identical), the paged ServeEngine end to end (zero host
transfers on the prefill→decode handoff), exactly-once replay of a
crashed prefill worker, page pressure in
``DeviceManager.memory_stats()``, and the launcher's one-layer paged
decoder giving the JAX paged engine's tokens on the same numpy weights.
"""
import gc
import math
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ActorSystem as JActorSystem
from repro.serve import PagePool as JPagePool
from repro.serve import ServeEngine as JServeEngine
from repro_torch.core import (AccessViolation, ActorSystem, live_ref_count,
                              transfer_count)
from repro_torch.core.memref import memory_stats, tree_release
from repro_torch.launch.serve import (contiguous_tokens, paged_model,
                                      paged_prompts, run_paged)
from repro_torch.configs import get_smoke_config
from repro_torch.serve import (PagePool, PageTable, PoolExhausted,
                               ServeEngine, make_paged_decode_worker,
                               make_prefill_worker)

WAIT = 120


@pytest.fixture(scope="module")
def system():
    s = ActorSystem(max_workers=8, device="cpu")
    yield s
    s.shutdown()


def ref_baseline():
    gc.collect()
    return live_ref_count()


def assert_refs_settle(baseline: int, timeout: float = 5.0) -> None:
    deadline = time.monotonic() + timeout
    while True:
        gc.collect()
        n = live_ref_count()
        if n <= baseline:
            return
        if time.monotonic() > deadline:
            assert n == baseline, f"{n - baseline} DeviceRefs leaked"
        time.sleep(0.02)


# ----------------------------------------------------------------------------
# toy paged model: single leaf [T, 1] holding the token value as float;
# next token = (sum of context + last token) mod 997
# ----------------------------------------------------------------------------
MOD = 997


def toy_prefill(prompt):
    arr = torch.tensor(np.asarray(prompt, dtype=np.float32)).reshape(-1, 1)
    return [arr], int(np.sum(np.asarray(prompt)) % MOD)


def toy_paged_step(kv, lengths, tokens):
    k = kv[0]  # [B, T, 1]
    t = k.shape[1]
    mask = (torch.arange(t)[None, :] < lengths[:, None]).to(k.dtype)
    s = torch.sum(k[..., 0] * mask, dim=1)
    nxt = (s.to(torch.int32) + tokens) % MOD
    return nxt, [nxt.to(torch.float32)[:, None]]


def simulate(prompt, steps):
    h = list(prompt)
    last = sum(prompt) % MOD
    out = []
    for _ in range(steps):
        nxt = (sum(h) + last) % MOD
        out.append(nxt)
        h.append(nxt)
        last = nxt
    return out


def make_pool(**kw):
    kw.setdefault("page_tokens", 4)
    kw.setdefault("max_pages", 64)
    kw.setdefault("device", "cpu")
    return PagePool([((1,), torch.float32)], **kw)


# ----------------------------------------------------------------------------
# pool allocation / accounting
# ----------------------------------------------------------------------------
def test_alloc_release_accounting():
    base = ref_baseline()
    pool = make_pool()
    pages = [pool.alloc_page() for _ in range(3)]
    st = pool.stats()
    assert st["pages_live"] == 3
    assert st["pages_free"] == pool.max_pages - 3
    assert st["allocated"] == 3
    assert live_ref_count() == base + 3  # one leaf per page
    pool.release_pages(pages)
    st = pool.stats()
    assert st["pages_live"] == 0 and st["freed"] == 3
    assert st["peak_pages"] == 3
    assert_refs_settle(base)


def test_release_is_idempotent():
    pool = make_pool()
    page = pool.alloc_page()
    pool.release_page(page)
    pool.release_page(page)  # double release must not underflow
    assert pool.stats()["pages_live"] == 0
    assert pool.stats()["freed"] == 1


def test_pool_exhausted_raises():
    pool = make_pool(max_pages=2)
    pages = [pool.alloc_page(), pool.alloc_page()]
    with pytest.raises(PoolExhausted):
        pool.alloc_page()
    pool.release_pages(pages)
    pool.alloc_page()  # space again after release


def test_write_pages_gather_roundtrip():
    base = ref_baseline()
    pool = make_pool(page_tokens=4)
    vals = np.arange(10, dtype=np.float32).reshape(-1, 1)
    pages, length = pool.write_pages([torch.from_numpy(vals)])
    assert length == 10
    assert len(pages) == 3           # ceil(10 / 4)
    assert [p.used for p in pages] == [4, 4, 2]
    table = PageTable(pool, pages=pages, length=length)
    (got,) = table.gather()
    np.testing.assert_array_equal(got[:10].numpy(), vals)
    np.testing.assert_array_equal(got[10:].numpy(),
                                  np.zeros((2, 1), np.float32))
    assert 0.0 < pool.stats()["fragmentation"] < 1.0
    table.release_pages()
    assert_refs_settle(base)


def test_prepare_append_allocates_at_boundary():
    pool = make_pool(page_tokens=4)
    pages, length = pool.write_pages([torch.zeros((4, 1))])
    table = PageTable(pool, pages=pages, length=length)
    assert table.capacity == 4
    tail, off = table.prepare_append()
    assert len(table.pages) == 2 and off == 0  # fresh page, offset 0
    table.commit_append([torch.ones((4, 1))])
    assert table.length == 5
    tail, off = table.prepare_append()
    assert len(table.pages) == 2 and off == 1  # same page, next slot
    table.release_pages()


def test_tree_release_recognizes_page_tables():
    base = ref_baseline()
    pool = make_pool()
    pages, length = pool.write_pages([torch.zeros((6, 1))])
    table = PageTable(pool, pages=pages, length=length)
    tree_release((table, 7, False))
    assert pool.stats()["pages_live"] == 0
    assert_refs_settle(base)


# ----------------------------------------------------------------------------
# prefix sharing: exactly-once allocation, sealing, eviction
# ----------------------------------------------------------------------------
def test_prefix_sharing_maps_same_pages_exactly_once():
    base = ref_baseline()
    pool = make_pool()
    prefill = make_prefill_worker(toy_prefill, pool)
    prompt = [3, 1, 4, 1, 5, 9]
    t1, first1, hit1 = prefill("prefill", prompt)
    t2, first2, hit2 = prefill("prefill", prompt)
    assert (hit1, hit2) == (False, True)
    assert first1 == first2 == sum(prompt) % MOD
    assert [id(p) for p in t1.pages] == [id(p) for p in t2.pages]
    st = pool.stats()
    assert st["allocated"] == len(t1.pages)   # allocated exactly once
    assert st["prefix_hits"] == 1
    assert st["pages_shared"] == len(t1.pages)
    assert all(p.sealed for p in t1.pages)
    t1.release_pages()
    t2.release_pages()
    assert pool.stats()["pages_live"] == len(pool._prefix[
        pool.prefix_key(prompt)].pages)
    assert pool.evict_prefixes() == 1
    assert pool.stats()["pages_live"] == 0
    assert_refs_settle(base)


def test_prefix_key_of_a_tensor_equals_its_list():
    assert PagePool.prefix_key(torch.tensor([3, 1, 4])) == (3, 1, 4) == \
        PagePool.prefix_key([3, 1, 4]) == JPagePool.prefix_key([3, 1, 4])
    assert PagePool.prefix_key(7) == (7,)


def test_prefix_cache_lru_cap():
    pool = make_pool(max_prefixes=2)
    prefill = make_prefill_worker(toy_prefill, pool)
    tables = [prefill("prefill", [i, i])[0] for i in range(3)]
    assert pool.stats()["prefix_entries"] == 2
    assert pool.stats()["prefix_evicted"] == 1
    for t in tables:
        t.release_pages()
    pool.evict_prefixes()


def test_allocation_pressure_evicts_idle_prefixes():
    pool = make_pool(page_tokens=4, max_pages=1)
    prefill = make_prefill_worker(toy_prefill, pool)
    t1, _, _ = prefill("prefill", [1, 2])
    t1.release_pages()                 # now held only by the cache pin
    assert pool.stats()["pages_live"] == 1
    t2, _, _ = prefill("prefill", [5, 6])   # needs space → evicts idle entry
    assert pool.stats()["prefix_evicted"] >= 1
    t2.release_pages()
    pool.evict_prefixes()


# ----------------------------------------------------------------------------
# prefix-safety guarantees
# ----------------------------------------------------------------------------
def test_sealed_page_write_raises_access_violation():
    pool = make_pool()
    prefill = make_prefill_worker(toy_prefill, pool)
    table, _, _ = prefill("prefill", [1, 2, 3])
    sealed = table.pages[-1]
    assert sealed.shared
    sealed.arrays()                    # reading a sealed page is fine
    with pytest.raises(AccessViolation):
        sealed.writable_arrays()
    with pytest.raises(AccessViolation):
        sealed._replace([torch.zeros((4, 1))])
    table.release_pages()
    pool.evict_prefixes()


def test_decode_worker_rejects_shared_tail():
    pool = make_pool()
    prefill = make_prefill_worker(toy_prefill, pool)
    table, first, _ = prefill("prefill", [1, 2, 3])
    decode = make_paged_decode_worker(toy_paged_step, pool)
    with pytest.raises(AccessViolation):
        decode("pstep", (first,), ((tuple(table.pages), table.length),))
    table.release_pages()
    pool.evict_prefixes()


def test_cow_divergence_leaves_sibling_byte_identical():
    base = ref_baseline()
    pool = make_pool(page_tokens=4)
    prefill = make_prefill_worker(toy_prefill, pool)
    prompt = [1, 2, 3, 4, 5, 6]        # length 6: full page + partial tail
    ta, first, _ = prefill("prefill", prompt)
    tb, _, _ = prefill("prefill", prompt)
    assert ta.pages[-1] is tb.pages[-1]
    (before,) = tb.gather()
    before = before.clone()
    tail_before = ta.pages[-1]
    tail, off = ta.prepare_append()
    assert tail is not tail_before and not tail.shared
    assert off == ta.tail_offset() == 2
    assert pool.stats()["cow"] == 1
    # A's committed write lands only in its private copy
    new = tail.writable_arrays()[0].clone()
    new[off] = 999.0
    ta.commit_append([new])
    (ga,) = ta.gather()
    assert float(ga[6, 0]) == 999.0
    (after,) = tb.gather()
    assert torch.equal(after, before)  # untouched
    ta.release_pages()
    tb.release_pages()
    pool.evict_prefixes()
    assert_refs_settle(base)


def test_decode_worker_writes_copies_and_replays():
    """The worker returns new tail tensors and leaves every page as it
    was, so the same step replays to the same result."""
    pool = make_pool(page_tokens=4)
    pages, length = pool.write_pages([torch.arange(6.0).reshape(-1, 1)])
    table = PageTable(pool, pages=pages, length=length)
    table.prepare_append()
    decode = make_paged_decode_worker(toy_paged_step, pool)
    snapshot = [t.clone() for p in table.pages for t in p.arrays()]
    row = ((tuple(table.pages), table.length),)
    tok_a, tails_a = decode("pstep", (5,), row)
    tok_b, tails_b = decode("pstep", (5,), row)
    assert tok_a.tolist() == tok_b.tolist() == [(15 + 5) % MOD]
    assert torch.equal(tails_a[0][0], tails_b[0][0])
    assert float(tails_a[0][0][2, 0]) == float(tok_a[0])
    assert all(torch.equal(t, s) for t, s in zip(
        [t for p in table.pages for t in p.arrays()], snapshot))
    table.release_pages()


# ----------------------------------------------------------------------------
# paged ServeEngine end to end
# ----------------------------------------------------------------------------
def test_engine_paged_end_to_end(system):
    base = ref_baseline()
    pool = make_pool(page_tokens=4, max_pages=128)
    engine = ServeEngine(system, step_fn=toy_paged_step, cache_pool=pool,
                         prefill_fn=toy_prefill, prefill_workers=2,
                         n_workers=2, max_batch=4, step_timeout=60.0)
    t0 = transfer_count()
    with engine:
        futs = [engine.submit([i, i + 1, i + 2], max_new_tokens=6)
                for i in range(8)]
        results = [f.result(timeout=WAIT) for f in futs]
    for i, r in enumerate(results):
        assert r.tokens == simulate([i, i + 1, i + 2], 6), f"request {i}"
    assert transfer_count() - t0 == 0
    st = engine.stats()
    assert st["completed"] == 8 and st["prefills"] == 8
    assert 0.0 < st["occupancy"] <= 1.0
    pool.evict_prefixes()
    assert pool.stats()["pages_live"] == 0
    assert_refs_settle(base)


def test_engine_paged_prefix_hits_across_requests(system):
    pool = make_pool(page_tokens=4, max_pages=128)
    engine = ServeEngine(system, step_fn=toy_paged_step, cache_pool=pool,
                         prefill_fn=toy_prefill, prefill_workers=1,
                         n_workers=2, max_batch=4, step_timeout=60.0)
    prompt = [7, 7, 7, 7]
    with engine:
        futs = [engine.submit(prompt, max_new_tokens=3) for _ in range(4)]
        results = [f.result(timeout=WAIT) for f in futs]
    expected = simulate(prompt, 3)
    assert all(r.tokens == expected for r in results)
    st = engine.stats()
    assert st["prefix_hits"] == 3              # first miss, three hits
    assert sum(1 for r in results if r.prefix_hit) == 3
    pool.evict_prefixes()


def test_engine_paged_prefill_crash_replays_exactly_once(system):
    crashes = [1]

    def flaky_prefill(prompt):
        if crashes and crashes.pop():
            raise RuntimeError("injected prefill crash")
        return toy_prefill(prompt)

    base = ref_baseline()
    pool = make_pool(page_tokens=4, max_pages=64)
    engine = ServeEngine(system, step_fn=toy_paged_step, cache_pool=pool,
                         prefill_fn=flaky_prefill, prefill_workers=2,
                         n_workers=2, max_batch=4, step_timeout=60.0)
    with engine:
        res = engine.submit([2, 3, 4], max_new_tokens=4).result(timeout=WAIT)
    assert res.tokens == simulate([2, 3, 4], 4)   # replay, exactly once
    assert engine.stats()["prefill_dispatch"]["failed"] >= 1
    pool.evict_prefixes()
    assert_refs_settle(base)


def test_engine_paged_validation():
    pool = make_pool()
    with pytest.raises(ValueError):               # no prefill_fn
        ServeEngine(object(), step_fn=toy_paged_step, cache_pool=pool)
    with pytest.raises(ValueError):               # init_fn in paged mode
        ServeEngine(object(), step_fn=toy_paged_step, cache_pool=pool,
                    prefill_fn=toy_prefill, init_fn=lambda p: (None, 0))


def test_memory_stats_reports_page_pressure(system):
    pool = make_pool(max_pages=32)
    pages = [pool.alloc_page() for _ in range(2)]
    stats = system.opencl_manager().memory_stats()
    dev = stats["cpu:0"]
    for key in ("pages_total", "pages_free", "pages_shared",
                "fragmentation"):
        assert key in dev
    assert dev["pages_total"] >= 32
    assert dev["pages_total"] - dev["pages_free"] >= 2
    assert memory_stats()["pages_total"] >= 32
    pool.release_pages(pages)


# ----------------------------------------------------------------------------
# the launcher's paged decoder against the JAX paged engine
# ----------------------------------------------------------------------------
def _numpy_weights(d, vocab, seed):
    rng = np.random.default_rng(seed)
    scale = 1.0 / math.sqrt(d)
    w = {"emb": rng.standard_normal((vocab, d), np.float32) * scale}
    for name in ("wq", "wk", "wv", "wo"):
        w[name] = rng.standard_normal((d, d), np.float32) * scale
    return w


def _jax_paged_tokens(w, prompts, steps, batch):
    """The JAX launcher's paged demo (``repro/launch/serve.py:105``) on
    the weights ``w``."""
    emb, wq, wk, wv, wo = (jnp.asarray(w[n]) for n in
                           ("emb", "wq", "wk", "wv", "wo"))
    vocab, d = emb.shape

    def attend(q, k, v, lengths):
        t = k.shape[1]
        scores = jnp.einsum("bd,btd->bt", q, k) / np.sqrt(d)
        mask = jnp.arange(t)[None, :] < lengths[:, None]
        scores = jnp.where(mask, scores, -jnp.inf)
        return jnp.einsum("bt,btd->bd", jax.nn.softmax(scores, axis=-1), v)

    def prefill_fn(prompt):
        toks = jnp.asarray(np.asarray(prompt, dtype=np.int64) % vocab)
        x = emb[toks]
        entries = {"k": x @ wk, "v": x @ wv}
        o = attend((x[-1] @ wq)[None, :], entries["k"][None],
                   entries["v"][None], jnp.asarray([toks.shape[0]]))
        return entries, int(jnp.argmax((o @ wo) @ emb.T, axis=-1)[0])

    def step_fn(kv, lengths, tokens):
        x = emb[tokens % vocab]
        entry = {"k": x @ wk, "v": x @ wv}
        k = kv["k"].at[jnp.arange(x.shape[0]), lengths].set(entry["k"])
        v = kv["v"].at[jnp.arange(x.shape[0]), lengths].set(entry["v"])
        o = attend(x @ wq, k, v, lengths + 1)
        return jnp.argmax((o @ wo) @ emb.T, axis=-1).astype(jnp.int32), entry

    with JActorSystem(name="jax-paged") as jsystem:
        pool = JPagePool.for_entries(prefill_fn(prompts[1])[0],
                                     page_tokens=16, max_pages=256)
        engine = JServeEngine(jsystem, step_fn=step_fn, cache_pool=pool,
                              prefill_fn=prefill_fn, prefill_workers=2,
                              n_workers=2, max_batch=batch)
        with engine:
            futs = [engine.submit(p, max_new_tokens=steps) for p in prompts]
            return [[int(t) for t in f.result(timeout=300).tokens]
                    for f in futs]


def test_paged_engine_tokens_equal_the_jax_paged_engine():
    cfg = get_smoke_config("qwen3-1.7b")
    w = _numpy_weights(cfg.d_model, cfg.vocab_size, 13)
    steps, requests = 12, 9
    prompts = paged_prompts(cfg.vocab_size, requests)
    want = _jax_paged_tokens(w, prompts, steps, batch=4)
    weights = {n: torch.from_numpy(a) for n, a in w.items()}
    run = run_paged(cfg, torch.device("cpu"), requests=requests, batch=4,
                    steps=steps, workers=2, prefill_workers=2, pages=256,
                    weights=weights, timeout=300)
    assert run["prompts"] == prompts
    got = [[int(t) for t in r.tokens] for r in run["results"]]
    assert got == want
    stats = run["stats"]
    assert stats["prefix_hits"] > 0 and stats["pool"]["cow"] > 0
    for key in ("transfers", "spills"):
        assert run["memref_after"][key] == run["memref_before"][key]
    # the same step function over contiguous caches, no pool
    prefill_fn, step_fn = paged_model(weights)
    for p, toks in zip(prompts[:4], got[:4]):
        assert contiguous_tokens(prefill_fn, step_fn, p, steps) == toks
    pool = run["pool"]
    pool.evict_prefixes()
    assert pool.stats()["pages_live"] == 0

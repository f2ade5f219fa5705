"""The port's decode path against the JAX package, on the CPU.

The qwen3-1.7b smoke config is initialised by JAX and its parameters are
handed to the port through ``convert.params_from_jax``; both packages
teacher-force the same numpy tokens one at a time through their decode
steps. Logits must agree within 2e-4 in f32 and 3e-2 in bf16 (the
tolerances of ``tests/test_torch_models.py``'s prefill check) at every
step, from a fresh cache and from a nonzero cache carried across by
``convert.cache_from_jax``. ``decode_attention``'s ring-buffer write
(``write_pos``) and local ``window`` are held against the JAX function;
greedy ``serve_step`` tokens must be equal; and a decode step must leave
the cache it was given as it was (the engine's replay contract).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.dist.step import build_serve_step as jbuild_serve_step
from repro.models import Model as JModel
from repro.models import attention as jattn
from repro_torch.configs import get_smoke_config
from repro_torch.convert import cache_from_jax, from_jax_arrays, params_from_jax
from repro_torch.dist.step import build_serve_step
from repro_torch.models import Model
from repro_torch.models import attention as attn
from repro_torch.models.model import serve_input_specs

ARCH = "qwen3-1.7b"
TOL = {"float32": 2e-4, "bfloat16": 3e-2}


def _configs(dtype):
    jcfg, cfg = jget_smoke(ARCH), get_smoke_config(ARCH)
    if dtype != "float32":
        jcfg = dataclasses.replace(jcfg, param_dtype=dtype,
                                   compute_dtype=dtype)
        cfg = dataclasses.replace(cfg, param_dtype=dtype, compute_dtype=dtype)
    return jcfg, cfg


def _models(dtype, seed=0):
    jcfg, cfg = _configs(dtype)
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.key(seed))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    return jmodel, jparams, Model(cfg, device="cpu"), params


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


def _tokens(cfg, seed, b, n):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, n)).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_logits_match_jax_from_a_fresh_cache(dtype):
    jmodel, jparams, model, params = _models(dtype)
    tokens = _tokens(model.cfg, 1, 2, 10)
    jcache = jmodel.init_cache(2, 12)
    cache = model.init_cache(2, 12)
    for t in range(tokens.shape[1]):
        want, jcache = jmodel.decode_step(jparams, jnp.asarray(tokens[:, t:t + 1]),
                                          jcache)
        got, cache = model.decode_step(params,
                                       torch.from_numpy(tokens[:, t:t + 1]),
                                       cache)
        assert got.shape == (2, 1, model.cfg.vocab_size)
        assert got.dtype == model.cfg.dtype()
        np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype],
                                   atol=TOL[dtype], err_msg=f"step {t}")
    assert int(cache["len"]) == int(jcache["len"]) == tokens.shape[1]
    for c, jc in zip(cache["groups"][0], jcache["groups"][0]):
        for name in ("k", "v"):
            np.testing.assert_allclose(_np(c[name]), _np(jc[name]),
                                       rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_logits_match_jax_from_a_carried_cache(dtype):
    """Both packages decode 8 steps from one nonzero cache: the JAX cache
    after 5 steps, converted by ``cache_from_jax``."""
    jmodel, jparams, model, params = _models(dtype, seed=3)
    tokens = _tokens(model.cfg, 4, 2, 13)
    jcache = jmodel.init_cache(2, 16)
    for t in range(5):
        _, jcache = jmodel.decode_step(jparams, jnp.asarray(tokens[:, t:t + 1]),
                                       jcache)
    cache = cache_from_jax(model.cfg, jax.tree.map(np.asarray, jcache),
                           device="cpu")
    assert cache["len"].dtype == torch.int32 and int(cache["len"]) == 5
    assert float(cache["groups"][0][0]["k"].abs().sum()) > 0
    for t in range(5, 13):
        want, jcache = jmodel.decode_step(jparams, jnp.asarray(tokens[:, t:t + 1]),
                                          jcache)
        got, cache = model.decode_step(params,
                                       torch.from_numpy(tokens[:, t:t + 1]),
                                       cache)
        np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype],
                                   atol=TOL[dtype], err_msg=f"step {t}")


def test_cache_from_jax_checks_the_structure():
    jmodel, _, model, _ = _models("float32")
    jcache = jax.tree.map(np.asarray, jmodel.init_cache(1, 4))
    cache = cache_from_jax(model.cfg, jcache, device="cpu")
    assert tuple(cache["groups"][0][0]["k"].shape) == \
        np.shape(jcache["groups"][0][0]["k"])
    bad = dataclasses.replace(model.cfg, n_kv_heads=1)
    with pytest.raises(ValueError, match="cache leaf"):
        cache_from_jax(bad, jcache, device="cpu")


def test_meta_caches_have_the_jax_shapes():
    jmodel, _, model, _ = _models("float32")
    for b in (1, 2):
        want = jax.tree.leaves(jax.eval_shape(lambda: jmodel.init_cache(b, 7)))
        got = jax.tree.leaves(model.init_cache(b, 7, device="meta"),
                              is_leaf=lambda x: isinstance(x, torch.Tensor))
        assert all(t.device.type == "meta" for t in got)
        assert [tuple(t.shape) for t in got] == [tuple(s.shape) for s in want]
        assert [str(t.dtype).split(".")[-1] for t in got] == \
            [str(s.dtype) for s in want]
    spec = serve_input_specs(model.cfg, 3)["tokens"]
    assert spec.device.type == "meta" and tuple(spec.shape) == (3, 1)
    assert spec.dtype == torch.int32


def _attn_case(seed, b, smax, window, cache_len, write_pos):
    jcfg, cfg = _configs("float32")
    rng = np.random.default_rng(seed)
    jp = jattn.init_attention(jax.random.key(seed), jcfg, jnp.float32)
    p = from_jax_arrays(jax.tree.map(np.asarray, jp), device="cpu")
    hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    x = rng.standard_normal((b, 1, cfg.d_model), np.float32)
    k = rng.standard_normal((b, smax, hkv, hd), np.float32)
    v = rng.standard_normal((b, smax, hkv, hd), np.float32)
    pos = np.full((b, 1), cache_len, np.int32)
    want = jattn.decode_attention(
        jp, jcfg, jnp.asarray(x), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(cache_len, jnp.int32), jnp.asarray(pos), window=window,
        write_pos=None if write_pos is None
        else jnp.asarray(write_pos, jnp.int32))
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    got = attn.decode_attention(
        p, cfg, torch.from_numpy(x), kt, vt,
        torch.tensor(cache_len, dtype=torch.int32), torch.from_numpy(pos),
        window=window,
        write_pos=None if write_pos is None
        else torch.tensor(write_pos, dtype=torch.int32))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-4)
    # pure: the caches it was given are untouched
    assert np.array_equal(kt.numpy(), k) and np.array_equal(vt.numpy(), v)


@pytest.mark.parametrize("cache_len", [3, 8, 13, 21])
def test_decode_attention_ring_buffer_write_matches_jax(cache_len):
    """A ring-buffer cache of 8 slots written at ``len % 8``; once it has
    wrapped, every slot is live."""
    _attn_case(cache_len, 2, 8, None, cache_len, cache_len % 8)


@pytest.mark.parametrize("window,cache_len", [(4, 6), (4, 11), (16, 9)])
def test_decode_attention_window_matches_jax(window, cache_len):
    _attn_case(window + cache_len, 2, 12, window, cache_len, None)


def test_decode_attention_clamps_a_write_past_the_end_as_jax_does():
    _attn_case(5, 1, 6, None, 9, None)


def test_serve_step_tokens_equal_jax():
    jmodel, jparams, model, params = _models("float32", seed=5)
    jstep, step = jbuild_serve_step(jmodel), build_serve_step(model)
    first = _tokens(model.cfg, 6, 4, 1)
    jtok, tok = jnp.asarray(first), torch.from_numpy(first)
    jcache, cache = jmodel.init_cache(4, 17), model.init_cache(4, 17)
    want, got = [], []
    for _ in range(16):
        jtok, _, jcache = jstep(jparams, jcache, jtok)
        tok, logits, cache = step(params, cache, tok)
        assert tok.dtype == torch.int32 and tok.shape == (4, 1)
        want.append(np.asarray(jtok))
        got.append(tok.numpy())
    np.testing.assert_array_equal(np.concatenate(got, 1),
                                  np.concatenate(want, 1))


def test_decode_step_is_pure_and_replays():
    """Two calls on one cache give identical logits and caches, and the
    cache they were given — the 0-d ``len`` included — is unchanged."""
    _, _, model, params = _models("float32", seed=7)
    tokens = _tokens(model.cfg, 8, 3, 4)
    cache = model.init_cache(3, 8)
    for t in range(3):
        _, cache = model.decode_step(params, torch.from_numpy(tokens[:, t:t + 1]),
                                     cache)
    leaves = jax.tree.leaves(cache, is_leaf=lambda x: isinstance(x, torch.Tensor))
    before = [t.clone() for t in leaves]
    versions = [t._version for t in leaves]
    step_tok = torch.from_numpy(tokens[:, 3:4])
    a_logits, a_cache = model.decode_step(params, step_tok, cache)
    b_logits, b_cache = model.decode_step(params, step_tok, cache)
    assert torch.equal(a_logits, b_logits)
    for x, y in zip(jax.tree.leaves(a_cache, is_leaf=torch.is_tensor),
                    jax.tree.leaves(b_cache, is_leaf=torch.is_tensor)):
        assert torch.equal(x, y)
    assert [t._version for t in leaves] == versions
    assert all(torch.equal(t, b) for t, b in zip(leaves, before))
    assert int(cache["len"]) == 3 and int(a_cache["len"]) == 4
    assert a_cache["len"] is not cache["len"]

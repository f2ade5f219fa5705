"""``tests/test_models.py``'s nine tests, case for case on the port, over
all ten archs, on the CPU.

Where the JAX test only checks shapes and finiteness, the port is also
held against the JAX package on the same parameters (carried over by
``convert.params_from_jax``) and the same numpy inputs: the smoke forward
and loss (logits 2e-4, loss rtol 1e-5), the gradient's global norm (rtol
1e-4) and three greedy decode steps (logits 2e-4, the same tokens). The
self-checks keep the JAX test's own limits: decode against the
teacher-forced forward (2e-3 dense, 5e-3 recurrent), SSD chunk invariance
(2e-4), chunked prefill against plain (``"ref_chunked:8"``, 2e-4) and
MoE group-size invariance (1e-4 / 1e-5).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro import configs as jconfigs
from repro.models import Model as JModel
from repro_torch import configs
from repro_torch.convert import params_from_jax
from repro_torch.dist import step as step_mod
from repro_torch.models import Model
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import plain_tree

ARCHS = configs.list_archs()
CPU = "cpu"


def _make_batch(cfg, batch=2, seq=16, key=0):
    rng = np.random.default_rng(key)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)}
    if cfg.family == "encdec":
        b["frames"] = rng.standard_normal(
            (batch, cfg.encdec.n_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        b["vision_embeds"] = rng.standard_normal(
            (batch, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
        b["positions"] = np.broadcast_to(np.arange(seq, dtype=np.int32),
                                         (3, batch, seq)).copy()
    return b


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _models(arch, seed):
    jcfg, cfg = jconfigs.get_smoke_config(arch), configs.get_smoke_config(arch)
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.key(seed))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                             device=CPU)
    return cfg, jmodel, jparams, Model(cfg, device=CPU), params


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_forward_and_loss(arch):
    cfg, jmodel, jparams, model, params = _models(arch, 0)
    batch = _make_batch(cfg)
    logits, aux = model.forward(params, batch)
    assert logits.shape == (2, 16, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    loss, metrics = model.loss(params, batch)
    assert np.isfinite(float(loss)) and float(metrics["ce"]) > 0
    want, _ = jmodel.forward(jparams, _jnp(batch))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    jloss, _ = jmodel.loss(jparams, _jnp(batch))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_grad_step(arch):
    cfg, jmodel, jparams, model, params = _models(arch, 1)
    batch = _make_batch(cfg)
    _, _, grads = step_mod.loss_and_grads(model, plain_tree(params), batch)
    flat = pytree.tree_leaves(grads)
    assert all(bool(torch.isfinite(g).all()) for g in flat)
    # at least one non-zero gradient
    assert any(float(g.abs().max()) > 0 for g in flat)
    jgrads = jax.grad(lambda p: jmodel.loss(p, _jnp(batch))[0])(jparams)
    norm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in flat)))
    jnorm = np.sqrt(sum(np.square(np.asarray(g, np.float64)).sum()
                        for g in jax.tree.leaves(jgrads)))
    np.testing.assert_allclose(norm, jnorm, rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_decode_step(arch):
    cfg, jmodel, jparams, model, params = _models(arch, 2)
    batch_size, max_len = 2, 32
    if cfg.family == "encdec":
        frames = np.random.default_rng(0).standard_normal(
            (batch_size, cfg.encdec.n_frames, cfg.d_model)).astype(np.float32)
        cache = model.init_cache(batch_size, max_len, params=params,
                                 frames=frames)
        jcache = jmodel.init_cache(batch_size, max_len, params=jparams,
                                   frames=jnp.asarray(frames))
    else:
        cache = model.init_cache(batch_size, max_len)
        jcache = jmodel.init_cache(batch_size, max_len)
    tok = torch.zeros((batch_size, 1), dtype=torch.int32)
    jdecode = jax.jit(jmodel.decode_step)
    for step in range(3):
        logits, cache = model.decode_step(params, tok, cache)
        assert logits.shape == (batch_size, 1, cfg.vocab_size)
        assert bool(torch.isfinite(logits).all())
        assert int(cache["len"]) == step + 1
        jlogits, jcache = jdecode(jparams, jnp.asarray(tok.numpy()), jcache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=2e-4, atol=2e-4)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        assert np.array_equal(tok.numpy(),
                              np.asarray(jnp.argmax(jlogits, axis=-1)))


def _decode_against_forward(arch, seed, data_seed, seq, tol):
    cfg = configs.get_smoke_config(arch)
    model = Model(cfg, device=CPU)
    params = model.init(seed)
    tokens = torch.from_numpy(np.random.default_rng(data_seed).integers(
        0, cfg.vocab_size, (1, seq)))
    full_logits, _ = model.forward(params, {"tokens": tokens})
    cache = model.init_cache(1, seq)
    step_logits = []
    for t in range(seq):
        lg, cache = model.decode_step(params, tokens[:, t:t + 1], cache)
        step_logits.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(step_logits, dim=1).numpy(),
                               full_logits.numpy(), rtol=tol, atol=tol)


def test_decode_matches_forward_dense():
    """Greedy decode logits must match teacher-forced forward logits."""
    _decode_against_forward("llama3-8b", 3, 5, 8, 2e-3)


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-9b"])
def test_decode_matches_forward_recurrent(arch):
    """Recurrent/hybrid decode must agree with the parallel path: the SSD
    chunks and the RG-LRU's chunked scan."""
    _decode_against_forward(arch, 4, 6, 16, 5e-3)


def test_ssd_chunking_invariance():
    """SSD output must not depend on the chunk size (state passing exact)."""
    cfg16 = configs.get_smoke_config("mamba2-130m")
    cfg4 = dataclasses.replace(
        cfg16, ssm=dataclasses.replace(cfg16.ssm, chunk=4))
    gen = torch.Generator().manual_seed(0)
    p = ssm_mod.init_ssm(gen, cfg16, torch.float32, CPU)
    u = torch.randn((2, 16, cfg16.d_model), generator=gen)
    y16 = ssm_mod.apply_ssm(p, cfg16, u)
    y4 = ssm_mod.apply_ssm(p, cfg4, u)
    np.testing.assert_allclose(y16.numpy(), y4.numpy(), rtol=2e-4, atol=2e-4)


def test_param_count_sanity():
    """Full configs must land near their published parameter counts."""
    approx = {
        "llama3-8b": 8.0e9,
        "dbrx-132b": 132e9,
        "phi3.5-moe-42b-a6.6b": 42e9,
        "nemotron-4-340b": 340e9,
        "qwen1.5-32b": 32e9,
        "recurrentgemma-9b": 9e9,
        "mamba2-130m": 130e6,
        "qwen3-1.7b": 1.7e9,
        "qwen2-vl-2b": 1.5e9,  # LM backbone only (vision tower stubbed)
        "whisper-tiny": 37e6,
    }
    for arch, want in approx.items():
        got = configs.get_config(arch).param_count()
        assert 0.5 * want < got < 1.6 * want, (arch, got, want)


def test_chunked_prefill_matches_plain():
    """ref_chunked (Sarathi-style prefill) must equal plain attention."""
    cfg = configs.get_smoke_config("llama3-8b")
    m_plain = Model(cfg, attn_impl="ref", device=CPU)
    m_chunk = Model(cfg, attn_impl="ref_chunked:8", device=CPU)
    params = m_plain.init(7)
    batch = _make_batch(cfg, batch=2, seq=32)
    a, _ = m_plain.forward(params, batch)
    b, _ = m_chunk.forward(params, batch)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=2e-4)


def test_moe_group_size_invariance():
    """Routing in groups must keep outputs finite and change only capacity
    truncation; with generous capacity, outputs match exactly."""
    cfg = configs.get_smoke_config("phi3.5-moe-42b-a6.6b")
    cfg_big = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0, group_size=4096))
    cfg_grp = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0, group_size=8))
    gen = torch.Generator().manual_seed(0)
    p = moe_mod.init_moe(gen, cfg_big, torch.float32, CPU)
    x = torch.randn((2, 16, cfg.d_model), generator=gen)
    y_full, _ = moe_mod.apply_moe(p, cfg_big, x)
    y_grp, _ = moe_mod.apply_moe(p, cfg_grp, x)
    np.testing.assert_allclose(y_full.numpy(), y_grp.numpy(), rtol=1e-4,
                               atol=1e-5)

"""The port's moe, ssm, hybrid, encdec and vlm families against the JAX
package, on the CPU.

Each of the six smoke configs (phi-3.5-moe, dbrx-132b, mamba2-130m,
recurrentgemma-9b, whisper-tiny, qwen2-vl-2b) is initialised by JAX, and
its parameters reach the port through ``convert.params_from_jax``; both
packages see the same numpy inputs. Limits, with what this CPU read:

* forward logits in f32 within 2e-4 (measured at most 9.9e-7);
* the loss within rtol 1e-5, the gradient norm 1e-4, every gradient leaf
  rtol 1e-3 / atol 1e-5 (PR 19's limits for the dense configs);
* decode logits within 2e-4 a step, from a fresh cache and from a cache
  carried across by ``convert.cache_from_jax`` (measured at most 6.3e-7),
  the hybrid ring past its window;
* the MoE routing indices exactly, the layer's output within 2e-5
  (measured 4.8e-7);
* three train steps against the jitted JAX step for phi-3.5-moe (the aux
  loss) and mamba2-130m, as ``tests/test_torch_training.py`` holds the
  dense step;
* the RG-LRU's chunked scan against ``jax.lax.associative_scan`` within
  2e-5 over 200 steps, three chunks and a part (measured 1.3e-5 on
  states up to ~40, where both lie ~1e-5 from a float64 loop).

Every arch's ``param_count()`` equals JAX's, and each smoke parameter tree
has JAX's leaves and ``eval_shape`` numel. The launchers run here too:
``launch.serve.main --device cpu`` for whisper-tiny (the sync loop),
mamba2-130m and recurrentgemma-9b (the engine), ``launch.train.main
--device cpu`` for phi-3.5-moe.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro import configs as jconfigs
from repro.dist import step as jstep
from repro.models import Model as JModel
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import rglru as jrglru
from repro.models import transformer as jtransformer
from repro.optim import AdamWConfig as JAdamWConfig
from repro_torch import configs
from repro_torch.convert import (cache_from_jax, params_from_jax,
                                 train_state_from_jax)
from repro_torch.data import SyntheticLM
from repro_torch.dist import step as step_mod
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import Model, layers, transformer
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models.layers import plain_tree
from repro_torch.optim import AdamWConfig

CPU = "cpu"
FAMILIES = ("phi3.5-moe-42b-a6.6b", "dbrx-132b", "mamba2-130m",
            "recurrentgemma-9b", "whisper-tiny", "qwen2-vl-2b")
MOE = ("phi3.5-moe-42b-a6.6b", "dbrx-132b")
TOL = 2e-4


def _pair(arch, seed=0):
    """(JAX config, port config, JAX model, JAX params, port params)."""
    jcfg, cfg = jconfigs.get_smoke_config(arch), configs.get_smoke_config(arch)
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.key(seed))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                             device=CPU)
    return jcfg, cfg, jmodel, jparams, params


def _batch(cfg, b=2, s=32, seed=0):
    """Tokens and labels [B,S], and the family's extras: frames (encdec),
    vision_embeds and [3,B,S] positions whose three streams differ over
    the vision block (vlm: time 0, then row and column of a 2-wide grid),
    so that M-RoPE's sections matter."""
    rng = np.random.default_rng(seed)
    out = {k: rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
           for k in ("tokens", "labels")}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (b, cfg.encdec.n_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        n = cfg.n_vision_tokens
        out["vision_embeds"] = rng.standard_normal(
            (b, n, cfg.d_model)).astype(np.float32)
        pos = np.broadcast_to(np.arange(s, dtype=np.int32), (3, b, s)).copy()
        pos[0, :, :n] = 0
        pos[1, :, :n] = np.arange(n) // 2
        pos[2, :, :n] = np.arange(n) % 2
        out["positions"] = pos
    return out


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _leaves(tree):
    return pytree.tree_leaves(tree)


def _key(entry) -> str:
    for attr in ("key", "idx"):
        if hasattr(entry, attr):
            return str(getattr(entry, attr))
    return str(entry)


def _named(tree) -> dict:
    """The leaves of a torch tree by path (``groups/0/1/k``): JAX
    flattens a dict in sorted key order, torch in insertion order."""
    return {"/".join(_key(k) for k in path): leaf
            for path, leaf in pytree.tree_flatten_with_path(tree)[0]}


def _jnamed(tree) -> dict:
    return {"/".join(_key(k) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ----------------------------------------------------------------------------
# forward, loss and gradients
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("impl", ["ref", "kernel", "ref_chunked:8"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_logits_match_jax(arch, impl):
    jcfg, cfg, jmodel, jparams, params = _pair(arch)
    batch = _batch(cfg)
    want, jaux = jmodel.forward(jparams, _jnp(batch))
    got, aux = Model(cfg, attn_impl=impl, device=CPU).forward(params, batch)
    assert got.shape == (2, 32, cfg.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    assert (float(aux) > 0) == (cfg.family == "moe")


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_jax(arch):
    jcfg, cfg, jmodel, jparams, params = _pair(arch, seed=1)
    batch = _batch(cfg, seed=1)
    (jloss, jparts), jgrads = jax.value_and_grad(
        lambda p: jmodel.loss(p, _jnp(batch)), has_aux=True)(jparams)
    loss, parts, grads = step_mod.loss_and_grads(
        Model(cfg, device=CPU), plain_tree(params), batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for key in ("ce", "aux"):
        np.testing.assert_allclose(float(parts[key]), float(jparts[key]),
                                   rtol=1e-5)
    want = plain_tree(params_from_jax(cfg, jax.tree.map(np.asarray, jgrads),
                                      device=CPU))
    assert pytree.tree_structure(grads) == pytree.tree_structure(want)
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in _leaves(grads)))
    jnorm = np.sqrt(sum(np.square(np.asarray(g, np.float64)).sum()
                        for g in jax.tree.leaves(jgrads)))
    np.testing.assert_allclose(float(norm), jnorm, rtol=1e-4)
    for a, b in zip(_leaves(grads), _leaves(want)):
        assert bool(torch.isfinite(a).all())
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3, atol=1e-5)


# ----------------------------------------------------------------------------
# decode
# ----------------------------------------------------------------------------
def _caches(jmodel, model, jparams, params, cfg, batch, max_len):
    if cfg.family == "encdec":
        return (jmodel.init_cache(2, max_len, params=jparams,
                                  frames=jnp.asarray(batch["frames"])),
                model.init_cache(2, max_len, params=params,
                                 frames=batch["frames"]))
    return jmodel.init_cache(2, max_len), model.init_cache(2, max_len)


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_logits_match_jax(arch):
    """Teacher-forced decode from a fresh cache, then from the JAX cache
    carried across; recurrentgemma's smoke window is 16, so its local
    attention ring (16 slots of a 32-token cache) wraps after step 16."""
    jcfg, cfg, jmodel, jparams, params = _pair(arch, seed=2)
    model = Model(cfg, device=CPU)
    batch = _batch(cfg, s=32, seed=2)
    toks = batch["tokens"]
    jcache, cache = _caches(jmodel, model, jparams, params, cfg, batch, 32)
    if cfg.family == "hybrid":
        assert cache["groups"][0][2]["k"].shape[2] == cfg.hybrid.window
    steps = 24 if cfg.family == "hybrid" else 6
    jdecode = jax.jit(jmodel.decode_step)
    for t in range(steps):
        jlogits, jcache = jdecode(jparams, jnp.asarray(toks[:, t:t + 1]),
                                  jcache)
        logits, cache = model.decode_step(
            params, torch.from_numpy(toks[:, t:t + 1]), cache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=TOL, atol=TOL)
    assert int(cache["len"]) == steps
    carried = cache_from_jax(cfg, jax.tree.map(np.asarray, jcache),
                             device=CPU)
    ours, theirs = _named(cache), _named(carried)
    assert ours.keys() == theirs.keys()
    for name, leaf in ours.items():
        assert leaf.shape == theirs[name].shape
        assert leaf.dtype == theirs[name].dtype
    for t in range(steps, steps + 3):
        jlogits, jcache = jdecode(jparams, jnp.asarray(toks[:, t:t + 1]),
                                  jcache)
        logits, carried = model.decode_step(
            params, torch.from_numpy(toks[:, t:t + 1]), carried)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", FAMILIES)
def test_cache_shapes_match_jax_eval_shape(arch):
    jcfg, cfg = jconfigs.get_smoke_config(arch), configs.get_smoke_config(arch)
    jmodel, model = JModel(jcfg), Model(cfg, device=CPU)
    if cfg.family == "encdec":
        jparams = jmodel.init(jax.random.key(0))
        params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                                 device=CPU)
        frames = np.zeros((3, cfg.encdec.n_frames, cfg.d_model), np.float32)
        want = jax.eval_shape(lambda: jmodel.init_cache(
            3, 40, params=jparams, frames=jnp.asarray(frames)))
        got = model.init_cache(3, 40, params=params, frames=frames)
    else:
        want = jax.eval_shape(lambda: jmodel.init_cache(3, 40))
        got = model.init_cache(3, 40, device="meta")
    want, got = _jnamed(want), _named(got)
    assert want.keys() == got.keys()
    for name, w in want.items():
        assert tuple(w.shape) == tuple(got[name].shape)
        assert str(w.dtype) == str(got[name].dtype).removeprefix("torch.")


def test_cache_from_jax_checks_the_structure():
    cfg = configs.get_smoke_config("mamba2-130m")
    cache = jax.tree.map(np.asarray,
                         JModel(jconfigs.get_smoke_config("mamba2-130m"))
                         .init_cache(1, 4))
    cache_from_jax(cfg, cache, device=CPU)
    cache["groups"][0][0]["state"] = cache["groups"][0][0]["state"][..., :3]
    with pytest.raises(ValueError, match="state"):
        cache_from_jax(cfg, cache, device=CPU)


# ----------------------------------------------------------------------------
# the family modules
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE)
def test_moe_routing_and_output_match_jax(arch):
    """The routing indices equal JAX's exactly (``jax.lax.top_k`` and
    ``torch.topk`` order equal values differently; a flipped tie would
    show here as the token it was), and the layer's output and aux loss
    agree."""
    jcfg, cfg = jconfigs.get_smoke_config(arch), configs.get_smoke_config(arch)
    p = jmoe.init_moe(jax.random.key(3), jcfg, jnp.float32)
    x = np.random.default_rng(3).standard_normal(
        (4, 16, cfg.d_model)).astype(np.float32)
    probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", jnp.asarray(x),
                                      p["router"]), axis=-1)
    want_v, want_i = jax.lax.top_k(probs, cfg.moe.top_k)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    got_probs, got_v, got_i = moe_mod.route(tp, cfg, torch.from_numpy(x))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_probs.numpy(), np.asarray(probs),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        got_v.numpy(), np.asarray(want_v / want_v.sum(-1, keepdims=True)),
        rtol=1e-5, atol=1e-6)
    jy, jaux = jmoe.apply_moe(p, jcfg, jnp.asarray(x))
    y, aux = moe_mod.apply_moe(tp, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_moe_drops_tokens_past_capacity_as_jax_does():
    """At capacity factor 0.5 some choices overflow their expert's queue:
    those tokens pass through with a zero contribution, in both."""
    jcfg = dataclasses.replace(
        jconfigs.get_smoke_config("phi3.5-moe-42b-a6.6b"),
        moe=dataclasses.replace(jconfigs.get_smoke_config(
            "phi3.5-moe-42b-a6.6b").moe, capacity_factor=0.5))
    cfg = dataclasses.replace(
        configs.get_smoke_config("phi3.5-moe-42b-a6.6b"),
        moe=dataclasses.replace(configs.get_smoke_config(
            "phi3.5-moe-42b-a6.6b").moe, capacity_factor=0.5))
    p = jmoe.init_moe(jax.random.key(4), jcfg, jnp.float32)
    x = np.random.default_rng(4).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32)
    jy, _ = jmoe.apply_moe(p, jcfg, jnp.asarray(x))
    y, _ = moe_mod.apply_moe({k: torch.from_numpy(np.array(v))
                              for k, v in p.items()}, cfg,
                             torch.from_numpy(x))
    dropped = np.all(np.asarray(jy) == 0, axis=-1)
    assert dropped.any()
    np.testing.assert_array_equal(np.all(y.numpy() == 0, axis=-1), dropped)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=2e-5,
                               atol=2e-5)


def test_rglru_chunked_scan_matches_the_associative_scan():
    """The scan alone, on one (log a, b) from numpy: 200 steps (three
    64-step chunks and a part), half the channels decaying at most 1e-3 a
    step, so that the state carries across chunk edges and grows to ~40,
    half at up to 72, as the init's gates decay. Against
    ``jax.lax.associative_scan`` within 2e-5 (this CPU read 1.3e-5). Then
    the whole block at the init's gates within 2e-5 (read 5.4e-7)."""
    rng = np.random.default_rng(5)
    w = 64
    log_a = -np.where(np.arange(w) % 2 == 0,
                      rng.uniform(0, 1e-3, (2, 200, w)),
                      rng.uniform(0, 72, (2, 200, w))).astype(np.float32)
    b = rng.standard_normal((2, 200, w)).astype(np.float32)

    def combine(p, q):
        return p[0] * q[0], q[0] * p[1] + q[1]

    _, want = jax.lax.associative_scan(
        combine, (jnp.exp(jnp.asarray(log_a)), jnp.asarray(b)), axis=1)
    assert 200 > 3 * rglru_mod.RGLRU_CHUNK
    got = rglru_mod._scan(torch.from_numpy(log_a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)

    cfg = configs.get_smoke_config("recurrentgemma-9b")
    jcfg = jconfigs.get_smoke_config("recurrentgemma-9b")
    p = jrglru.init_rglru(jax.random.key(5), jcfg, jnp.float32)
    u = rng.standard_normal((2, 200, cfg.d_model)).astype(np.float32)
    want = jrglru.apply_rglru(p, jcfg, jnp.asarray(u))
    got = rglru_mod.apply_rglru({k: torch.from_numpy(np.array(v))
                                 for k, v in p.items()}, cfg,
                                torch.from_numpy(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def _ssd_float64(params, cfg, u):
    """Mamba-2's mixer as the plain recurrence in float64 (numpy)."""
    from repro_torch.models.ssm import _dims
    d, di, n, p, h, g, conv_dim = _dims(cfg)
    w = {k: np.asarray(v, np.float64) for k, v in params.items()
         if not isinstance(v, dict)}
    u = u.astype(np.float64)
    b, s, _ = u.shape
    zxbcdt = u @ w["in_proj"]
    z, xbc, dt = (zxbcdt[..., :di], zxbcdt[..., di:di + conv_dim],
                  zxbcdt[..., di + conv_dim:])
    width = w["conv_w"].shape[0]
    pad = np.pad(xbc, ((0, 0), (width - 1, 0), (0, 0)))
    xbc = sum(pad[:, i:i + s] * w["conv_w"][i] for i in range(width)) + \
        w["conv_b"]
    xbc = xbc / (1 + np.exp(-xbc))
    x = xbc[..., :di].reshape(b, s, h, p)
    bm = np.repeat(xbc[..., di:di + g * n].reshape(b, s, g, n), h // g, 2)
    cm = np.repeat(xbc[..., di + g * n:].reshape(b, s, g, n), h // g, 2)
    dt = np.log1p(np.exp(dt + w["dt_bias"]))
    decay = np.exp(dt * -np.exp(w["a_log"]))
    state, ys = np.zeros((b, h, n, p)), []
    for t in range(s):
        state = state * decay[:, t, :, None, None] + np.einsum(
            "bhn,bhp->bhnp", bm[:, t], x[:, t] * dt[:, t, :, None])
        ys.append(np.einsum("bhn,bhnp->bhp", cm[:, t], state) +
                  x[:, t] * w["d_skip"][None, :, None])
    y = np.stack(ys, 1).reshape(b, s, di) * (z / (1 + np.exp(-z)))
    y = y / np.sqrt((y * y).mean(-1, keepdims=True) + 1e-6)
    return (y * np.asarray(params["norm"]["scale"], np.float64)) @ \
        w["out_proj"]


def test_ssd_segment_sums_track_a_float64_recurrence():
    """At mamba2's own chunk of 256, the port's SSD (each segment of log
    decays summed on its own) lies within 1e-5 of the float64 recurrence
    (this CPU read 3.6e-6 on outputs up to 4.5), closer than the JAX
    package's SSD, whose ``cum_i - cum_j`` of running sums that reach
    -10^3 in a chunk cancels (read 9.5e-5)."""
    jcfg = jconfigs.get_smoke_config("mamba2-130m")
    cfg = configs.get_smoke_config("mamba2-130m")
    jcfg = dataclasses.replace(jcfg, ssm=dataclasses.replace(jcfg.ssm,
                                                             chunk=256))
    cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                           chunk=256))
    from repro.models import ssm as jssm
    from repro_torch.models import ssm as ssm_mod
    p = jax.tree.map(np.asarray, jssm.init_ssm(jax.random.key(0), jcfg,
                                               jnp.float32))
    u = np.random.default_rng(0).standard_normal(
        (2, 1024, cfg.d_model)).astype(np.float32)
    want = _ssd_float64(p, cfg, u)
    got = ssm_mod.apply_ssm(jax.tree.map(torch.from_numpy, p), cfg,
                            torch.from_numpy(u)).numpy()
    theirs = np.asarray(jssm.apply_ssm(p, jcfg, jnp.asarray(u)))
    err, jerr = np.abs(got - want).max(), np.abs(theirs - want).max()
    assert err < 1e-5 and err < jerr


def test_m_rope_and_sinusoidal_positions_match_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 12, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 50, (3, 2, 12)).astype(np.int32)
    want = jlayers.apply_m_rope(jnp.asarray(x), jnp.asarray(pos), 1e6,
                                (2, 3, 3))
    got = layers.apply_m_rope(torch.from_numpy(x), torch.from_numpy(pos),
                              1e6, (2, 3, 3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(layers.sinusoidal_positions(1500, 384).numpy(),
                               np.asarray(jlayers.sinusoidal_positions(
                                   1500, 384)), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="sections"):
        layers.apply_m_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                            (2, 3, 4))


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_layer_groups_match_jax(arch):
    """recurrentgemma-9b's 38 layers of (rec, rec, attn) make 12 units and
    a (rec, rec) remainder; every other family's groups are JAX's too."""
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    if cfg.family == "encdec":
        with pytest.raises(ValueError, match="family 'encdec'"):
            transformer.layer_groups(cfg)
        return
    assert transformer.layer_groups(cfg) == jtransformer.layer_groups(jcfg)
    assert len(transformer.layer_kinds(cfg)) == cfg.n_layers
    if arch == "recurrentgemma-9b":
        assert transformer.layer_groups(cfg) == [
            (("rec", "rec", "attn"), 12), (("rec", "rec"), 1)]


# ----------------------------------------------------------------------------
# parameter counts and trees, for every arch
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_param_counts_and_smoke_trees_match_jax(arch):
    """``param_count()`` of the published config equals JAX's (no
    full-width model is built here), and the port's smoke tree holds JAX's
    leaves: the same shapes and dtypes as the tree carried over from a JAX
    init, and JAX's ``eval_shape`` numel."""
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    scfg = configs.get_smoke_config(arch)
    jmodel = JModel(jconfigs.get_smoke_config(arch))
    params = Model(scfg, device=CPU).init(0)
    carried = params_from_jax(scfg, jax.tree.map(
        np.asarray, jmodel.init(jax.random.key(0))), device=CPU)
    assert {n: (tuple(p.shape), p.dtype) for n, p in params.named_parameters()} \
        == {n: (tuple(p.shape), p.dtype)
            for n, p in carried.named_parameters()}
    n_jax = sum(int(np.prod(leaf.shape))
                for leaf in jax.tree.leaves(jmodel.param_shapes()))
    assert sum(p.numel() for p in params.parameters()) == n_jax


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_train_input_specs_match_jax(arch):
    """``frames`` for encdec, ``vision_embeds`` and [3,B,S] ``positions``
    for vlm, in the compute dtype, as the JAX specs give them."""
    from repro.models import train_input_specs as jspecs
    from repro_torch.models import train_input_specs
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    want, got = jspecs(jcfg, 2, 64), train_input_specs(cfg, 2, 64)
    assert sorted(got) == sorted(want)
    for k, spec in want.items():
        assert tuple(got[k].shape) == tuple(spec.shape) and got[k].is_meta
        assert str(got[k].dtype).removeprefix("torch.") == str(spec.dtype)


# ----------------------------------------------------------------------------
# training against the jitted JAX step
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "mamba2-130m"])
def test_three_train_steps_match_the_jitted_jax_step(arch):
    lr, steps = 1e-2, 3
    jcfg, cfg = jconfigs.get_smoke_config(arch), configs.get_smoke_config(arch)
    jmodel = JModel(jcfg)
    jocfg = JAdamWConfig(lr=lr)
    jstate = jstep.init_train_state(jmodel, jax.random.key(0), jocfg)
    state = train_state_from_jax(cfg, jax.tree.map(np.asarray, jstate),
                                 device=CPU)
    jtrain = jax.jit(jstep.build_train_step(jmodel, jocfg))
    train = step_mod.build_train_step(Model(cfg, device=CPU),
                                      AdamWConfig(lr=lr))
    data = SyntheticLM(cfg, batch=4, seq=16, seed=2)
    for i in range(steps):
        batch = data.batch_at(i)
        jstate, jm = jtrain(jstate, _jnp(batch))
        state, m = train(state, batch)
        for key in ("loss", "aux", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-4)
        want = train_state_from_jax(cfg, jax.tree.map(np.asarray, jstate),
                                    device=CPU)
        # a near-zero gradient's sign flip moves Adam's step by up to 2 lr
        for a, b in zip(_leaves(state["params"]), _leaves(want["params"])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=2.1 * lr * (i + 1))
    assert (float(m["aux"]) > 0) == (cfg.family == "moe")
    assert int(state["step"]) == int(jstate["step"]) == steps


# ----------------------------------------------------------------------------
# the launchers
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("arch,mode", [("whisper-tiny", "sync"),
                                       ("mamba2-130m", "engine"),
                                       ("recurrentgemma-9b", "engine")])
def test_launch_serve_runs_the_families_on_the_cpu(arch, mode, capsys):
    """whisper-tiny takes the sync loop over frames from numpy seed 0, as
    in the JAX launcher; mamba2's and recurrentgemma's ssm and rec cache
    leaves ride through the engine's combine and split."""
    assert launch_serve.main(["--arch", arch, "--device", CPU, "--requests",
                              "4", "--batch", "2", "--steps", "6",
                              "--workers", "1"]) == 0
    out = capsys.readouterr().out
    assert ("tok/s" in out) and ("sample:" in out)
    if mode == "sync":
        assert "steps × 2 requests" in out and "latency" not in out
    else:
        assert "latency p50" in out and "requeues=0" in out


def test_engine_carries_recurrent_caches_like_the_sync_loop():
    """recurrentgemma's engine tokens (batch 1, one request at a time, its
    ssm/rec leaves split and combined) equal the static-batch loop's."""
    cfg = configs.get_smoke_config("recurrentgemma-9b")
    model = Model(cfg, device=CPU)
    params = model.init(0)
    sync = launch_serve.run_sync(model, params, batch=2, steps=20,
                                 prompts=[3, 7])
    run = launch_serve.run_engine(model, params, requests=2, batch=2,
                                  steps=20, workers=1, prompts=[3, 7])
    assert [list(r.tokens) for r in run["results"]] == sync["tokens"].tolist()


def test_launch_train_runs_a_moe_config(capsys):
    argv = ["--arch", "phi3.5-moe-42b-a6.6b", "--steps", "4", "--batch", "2",
            "--seq", "16", "--log-every", "2", "--device", CPU]
    assert launch_train.main(argv) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("step")]
    assert len(lines) == 2
    rows = launch_train.run(launch_train.parse_args(argv))
    assert all(np.isfinite(r["loss"]) and r["aux"] > 0 for r in rows)

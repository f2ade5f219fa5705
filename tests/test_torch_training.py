"""The port's training substrate against the JAX package, on the CPU.

``tests/test_training.py``'s seven cases case for case on the port, then
parity with the JAX package on the same numpy inputs: the loss and its
gradients for the four dense smoke configs (loss rtol 1e-5, gradients
rtol 1e-3 / atol 1e-5, the limits ``tests/test_training.py`` holds JAX's
accumulated gradients to against its own), the MLP kinds, one AdamW
update (rtol 1e-6), the warmup-cosine schedule (1e-6), three train steps
against the jitted JAX step, ``SyntheticLM``'s arrays (equal) and the
checkpoint format both ways (equal, bfloat16 included). Parameters come
from the JAX init through ``convert.params_from_jax``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
import torch.utils._pytree as pytree

from repro import configs as jconfigs
from repro.checkpoint import checkpoint as jckpt
from repro.data import SyntheticLM as JSyntheticLM
from repro.dist import step as jstep
from repro.models import Model as JModel
from repro.models import layers as jlayers
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule
from repro_torch import configs
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.convert import (from_jax_arrays, params_from_jax,
                                 train_state_from_jax)
from repro_torch.data import Prefetcher, SyntheticLM
from repro_torch.dist import step as step_mod
from repro_torch.kernels import KERNELS
from repro_torch.kernels import adamw as fused_adamw
from repro_torch.launch import train as launch_train
from repro_torch.models import Model, train_input_specs
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers
from repro_torch.models.layers import plain_tree
from repro_torch.models.transformer import REMAT_POLICIES
from repro_torch.optim import AdamWConfig, adamw, schedule

CPU = "cpu"
DENSE = ("qwen3-1.7b", "llama3-8b", "qwen1.5-32b", "nemotron-4-340b")


@pytest.fixture(scope="module")
def small():
    cfg = configs.get_smoke_config("llama3-8b")
    model = Model(cfg, device=CPU)
    ocfg = AdamWConfig(lr=1e-2, weight_decay=0.0)
    state = step_mod.init_train_state(model, 0, ocfg)
    return cfg, model, ocfg, state


def _leaves(tree):
    return pytree.tree_leaves(tree)


def _jax_params(arch, seed=0, **replace):
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch), **replace)
    cfg = dataclasses.replace(configs.get_smoke_config(arch), **replace)
    jparams = JModel(jcfg).init(jax.random.key(seed))
    port = plain_tree(params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                                      device=CPU))
    return jcfg, cfg, jparams, port


def _port_tree(cfg, jax_tree):
    """A JAX parameter-shaped tree (params or gradients) in the port's
    layout, for leaf-by-leaf comparison."""
    return plain_tree(params_from_jax(cfg, jax.tree.map(np.asarray, jax_tree),
                                      device=CPU))


# ----------------------------------------------------------------------------
# tests/test_training.py, case for case
# ----------------------------------------------------------------------------
def test_data_deterministic_and_sharded():
    cfg = configs.get_smoke_config("llama3-8b")
    a = SyntheticLM(cfg, batch=8, seq=16, seed=3)
    b = SyntheticLM(cfg, batch=8, seq=16, seed=3)
    np.testing.assert_array_equal(a.batch_at(7)["tokens"], b.batch_at(7)["tokens"])
    assert not np.array_equal(a.batch_at(7)["tokens"], a.batch_at(8)["tokens"])
    s0 = SyntheticLM(cfg, batch=8, seq=16, seed=3, shard=0, num_shards=2)
    s1 = SyntheticLM(cfg, batch=8, seq=16, seed=3, shard=1, num_shards=2)
    assert s0.batch_at(0)["tokens"].shape == (4, 16)
    assert not np.array_equal(s0.batch_at(0)["tokens"], s1.batch_at(0)["tokens"])


def test_prefetcher_orders_batches():
    cfg = configs.get_smoke_config("llama3-8b")
    src = SyntheticLM(cfg, batch=4, seq=8, seed=0)
    pf = Prefetcher(src, depth=2)
    try:
        for want in range(4):
            step, batch = pf.next()
            assert step == want
            np.testing.assert_array_equal(batch["tokens"],
                                          src.batch_at(want)["tokens"])
    finally:
        pf.close()


def test_checkpoint_roundtrip_and_gc(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3),
            "b": [torch.ones((4,), dtype=torch.int32),
                  {"c": torch.zeros((), dtype=torch.float32)}]}
    d = str(tmp_path)
    for s in (1, 2, 3, 4):
        ckpt.save(d, s, tree, keep=2)
    assert ckpt.all_steps(d) == [3, 4]
    restored, manifest = ckpt.restore(d, target=tree)
    assert manifest["step"] == 4
    for x, y in zip(_leaves(tree), _leaves(restored)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_restore_checks_its_directory_and_target(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path))
    ckpt.save(str(tmp_path), 1, {"a": torch.ones(2), "b": torch.zeros(3)})
    with pytest.raises(ValueError, match="2 leaves"):
        ckpt.restore(str(tmp_path), target={"a": torch.zeros(0)})
    assert ckpt.latest_step(str(tmp_path)) == 1


def test_adamw_converges_quadratic():
    ocfg = AdamWConfig(lr=0.1, weight_decay=0.0, clip_norm=None)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw.init(params, ocfg)
    for _ in range(200):
        grads = pytree.tree_map(lambda w: 2 * w, params)  # d/dw w^2
        params, state, _ = adamw.update(grads, state, params, ocfg)
    assert float(params["w"].abs().max()) < 1e-2


def test_grad_accum_matches_full_batch(small):
    """Microbatch-accumulated gradients equal the full-batch gradient
    (compared before the optimizer, as the JAX test does)."""
    cfg, model, ocfg, state = small
    data = SyntheticLM(cfg, batch=8, seq=16, seed=1)
    batch = {k: torch.from_numpy(v) for k, v in data.batch_at(0).items()}
    params = state["params"]
    l_full, _, g_full = step_mod.loss_and_grads(model, params, batch)

    accum = 4
    mbs = step_mod._split_microbatches(batch, accum)
    g_acc = pytree.tree_map(torch.zeros_like, params)
    l_acc = 0.0
    for i in range(accum):
        mb = {k: v[i] for k, v in mbs.items()}
        l, _, g = step_mod.loss_and_grads(model, params, mb)
        l_acc += float(l) / accum
        g_acc = pytree.tree_map(lambda a, b: a + b / accum, g_acc, g)
    np.testing.assert_allclose(l_acc, float(l_full), rtol=1e-5)
    for a, b in zip(_leaves(g_acc), _leaves(g_full)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3, atol=1e-5)
    l4, _, g4 = step_mod.loss_and_grads(model, params, batch, grad_accum=4)
    for a, b in zip(_leaves(g4), _leaves(g_full)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3, atol=1e-5)

    # the two train steps agree on the loss metric
    step4 = step_mod.build_train_step(model, ocfg, grad_accum=4)
    _, m4 = step4(state, batch)
    np.testing.assert_allclose(float(m4["loss"]), float(l_full), rtol=1e-5)


def test_presplit_batch_gives_the_split_result(small):
    cfg, model, ocfg, state = small
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(
        cfg, batch=4, seq=8, seed=6).batch_at(0).items()}
    batch["positions"] = torch.arange(8).expand(3, 4, 8)
    split = step_mod._split_microbatches(batch, 2)
    assert split["tokens"].shape == (2, 2, 8)
    assert split["positions"].shape == (2, 3, 2, 8)
    torch.testing.assert_close(split["positions"][1], batch["positions"][:, 2:])
    del batch["positions"], split["positions"]
    a = step_mod.loss_and_grads(model, state["params"], batch, grad_accum=2)
    b = step_mod.loss_and_grads(model, state["params"], split, grad_accum=2,
                                presplit=True)
    assert float(a[0]) == float(b[0])
    assert all(torch.equal(x, y) for x, y in zip(_leaves(a[2]), _leaves(b[2])))


def test_loss_decreases_over_training(small):
    cfg, model, ocfg, state = small
    data = SyntheticLM(cfg, batch=8, seq=32, seed=2, noise=0.02)
    sched = schedule.warmup_cosine(5, 60)
    tstep = step_mod.build_train_step(model, ocfg, lr_schedule=sched)
    losses = []
    for i in range(60):
        state, metrics = tstep(state, data.batch_at(i))
        losses.append(float(metrics["loss"]))
    assert int(state["step"]) == 60
    first = np.mean(losses[:5])
    last = np.mean(losses[-5:])
    assert last < first * 0.8, (first, last)


def test_serve_step_greedy(small):
    cfg, model, ocfg, state = small
    serve = step_mod.build_serve_step(model)
    cache = model.init_cache(2, 16)
    tok = torch.zeros((2, 1), dtype=torch.int32)
    nxt, logits, cache = serve(state["params"], cache, tok)
    assert nxt.shape == (2, 1)
    assert logits.shape == (2, 1, cfg.vocab_size)
    assert int(cache["len"]) == 1


# ----------------------------------------------------------------------------
# parity with the JAX package
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_grads_match_jax(arch):
    jcfg, cfg, jparams, params = _jax_params(arch)
    batch = SyntheticLM(cfg, batch=4, seq=16, seed=5).batch_at(0)
    jmodel = JModel(jcfg)
    (jloss, jparts), jgrads = jax.value_and_grad(
        lambda p: jmodel.loss(p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jparams)
    loss, parts, grads = step_mod.loss_and_grads(Model(cfg, device=CPU),
                                                 params, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(parts["ce"]), float(jparts["ce"]),
                               rtol=1e-5)
    assert float(parts["aux"]) == float(jparts["aux"]) == 0.0
    want = _port_tree(cfg, jgrads)
    assert pytree.tree_structure(grads) == pytree.tree_structure(want)
    for a, b in zip(_leaves(grads), _leaves(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu", "relu2"])
def test_mlp_kinds_match_jax(kind):
    rng = np.random.default_rng(3)
    d, f = 24, 40
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    p = {"w_gate": rng.standard_normal((d, f)).astype(np.float32) * 0.3,
         "w_up": rng.standard_normal((d, f)).astype(np.float32) * 0.3,
         "w_out": rng.standard_normal((f, d)).astype(np.float32) * 0.3}
    if kind in ("gelu", "relu2"):
        del p["w_gate"]
    want = np.asarray(jlayers.apply_mlp(jax.tree.map(jnp.asarray, p),
                                        jnp.asarray(x), kind))
    got = layers.apply_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x), kind)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    init = layers.init_mlp(torch.Generator().manual_seed(0), d, f, kind,
                           torch.float32, CPU)
    jinit = jlayers.init_mlp(jax.random.key(0), d, f, kind, jnp.float32)
    assert {k: tuple(v.shape) for k, v in init.items()} == \
        {k: tuple(v.shape) for k, v in jinit.items()}


@pytest.mark.parametrize("bias", [False, True])
def test_linear_matches_jax(bias):
    """JAX's ``init_linear`` weights, carried over by ``convert``, give
    JAX's ``apply_linear`` output through the port's; the port's own
    ``init_linear`` draws the same shapes, dtype and scale (its bits come
    from a ``torch.Generator``)."""
    d_in, d_out = 256, 40
    x = np.random.default_rng(5).standard_normal((3, 7, d_in)).astype(
        np.float32)
    jp = jlayers.init_linear(jax.random.key(1), d_in, d_out, jnp.float32,
                             bias=bias)
    if bias:    # JAX initialises it to zero: give the sum something to add
        jp = {**jp, "b": jnp.linspace(-1.0, 1.0, d_out, dtype=jnp.float32)}
    want = np.asarray(jlayers.apply_linear(jp, jnp.asarray(x)))
    got = layers.apply_linear(from_jax_arrays(jp, device=CPU),
                              torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    init = layers.init_linear(torch.Generator().manual_seed(0), d_in, d_out,
                              torch.float32, CPU, bias=bias)
    jinit = jlayers.init_linear(jax.random.key(0), d_in, d_out, jnp.float32,
                                bias=bias)
    assert {k: (tuple(v.shape), v.dtype) for k, v in init.items()} == \
        {k: (tuple(v.shape), torch.float32) for k, v in jinit.items()}
    assert all(v.dtype == jnp.float32 for v in jinit.values())
    # 10,240 draws: the standard deviation within 5 % of 1 / sqrt(d_in)
    assert abs(float(init["w"].std()) * d_in ** 0.5 - 1.0) < 0.05
    if bias:
        assert not init["b"].any()


def test_gelu_is_the_tanh_approximation_as_in_jax():
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    tanh = F.gelu(torch.from_numpy(x), approximate="tanh").numpy()
    erf = F.gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(tanh, want, rtol=1e-6, atol=1e-6)
    assert np.abs(erf - want).max() > 1e-4      # the erf form would differ
    with pytest.raises(ValueError, match="unknown MLP"):
        layers.apply_mlp({}, torch.zeros(1, 4), "mish")


@pytest.mark.parametrize("remat", REMAT_POLICIES)
def test_remat_policies_give_the_same_gradients(remat):
    _, cfg, _, params = _jax_params("qwen3-1.7b", remat="none")
    batch = SyntheticLM(cfg, batch=2, seq=16, seed=4).batch_at(0)
    want = step_mod.loss_and_grads(Model(cfg, device=CPU), params, batch)
    rcfg = dataclasses.replace(cfg, remat=remat)
    got = step_mod.loss_and_grads(Model(rcfg, device=CPU), params, batch)
    assert float(got[0]) == float(want[0])
    for a, b in zip(_leaves(got[2]), _leaves(want[2])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="remat"):
        step_mod.loss_and_grads(
            Model(dataclasses.replace(cfg, remat="dots_nobatch"), device=CPU),
            params, batch)


def test_adamw_update_matches_jax():
    rng = np.random.default_rng(7)
    shapes = {"w": (16, 8), "b": (8,), "norm": {"scale": (8,)}}
    mk = lambda s: rng.standard_normal(s).astype(np.float32)
    params, grads = (jax.tree.map(mk, shapes, is_leaf=lambda s: isinstance(
        s, tuple)) for _ in range(2))
    grads = jax.tree.map(lambda g: g * 3.0, grads)       # norm > clip_norm
    jcfg = JAdamWConfig(lr=1e-2, weight_decay=0.1)
    cfg = AdamWConfig(lr=1e-2, weight_decay=0.1)
    to_t = lambda tree: pytree.tree_map(torch.from_numpy, tree)
    jstate = jadamw.init(jax.tree.map(jnp.asarray, params), jcfg)
    state = adamw.init(to_t(params), cfg)
    jp = jax.tree.map(jnp.asarray, params)
    p = to_t(params)
    for i in range(3):          # count > 1 exercises the bias correction
        g = jax.tree.map(lambda a: a * (i + 1), grads)
        jp, jstate, jm = jadamw.update(jax.tree.map(jnp.asarray, g), jstate,
                                       jp, jcfg, jnp.float32(0.5))
        p, state, m = adamw.update(to_t(g), state, p, cfg,
                                   torch.tensor(0.5))
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        for got, want in ((p, jp), (state["m"], jstate["m"]),
                          (state["v"], jstate["v"])):
            for k in ("w", "b"):
                np.testing.assert_allclose(got[k].numpy(),
                                           np.asarray(want[k]), rtol=1e-6)
            np.testing.assert_allclose(got["norm"]["scale"].numpy(),
                                       np.asarray(want["norm"]["scale"]),
                                       rtol=1e-6)
    assert int(state["count"]) == int(jstate["count"]) == 3
    assert state["count"].dtype == torch.int32


def test_adamw_keeps_dtypes_and_writes_nothing():
    cfg = AdamWConfig(state_dtype="bfloat16")
    params = {"w": torch.ones(4, dtype=torch.bfloat16)}
    state = adamw.init(params, cfg)
    before = [t.clone() for t in _leaves((params, state))]
    p, s, _ = adamw.update({"w": torch.ones(4, dtype=torch.bfloat16)},
                           state, params, cfg)
    assert p["w"].dtype == torch.bfloat16 and s["m"]["w"].dtype == torch.bfloat16
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                 _leaves((params, state))))


def test_adamw_cpu_leaves_take_the_loop_and_count_it():
    from repro_torch import trace
    cfg = AdamWConfig()
    params = {"w": torch.ones(3, 4), "b": {"c": torch.ones(5)}}
    state = adamw.init(params, cfg)
    grads = pytree.tree_map(lambda p: torch.full_like(p, 0.5), params)
    before = [dict(k.function_launches) for k in KERNELS]
    with trace.recording():
        for _ in range(2):
            adamw.update(grads, state, params, cfg)
        counts = trace.counters()
    assert counts["optim.loop_leaves"] == 4
    assert counts["optim.fused_leaves"] == 0
    assert [dict(k.function_launches) for k in KERNELS] == before


def test_adamw_kernel_module_imports_without_nvcc():
    """Importing builds nothing: the library is built at the first launch,
    on a machine with nvcc."""
    assert fused_adamw.KERNEL in KERNELS
    assert fused_adamw.KERNEL._lib is None
    assert fused_adamw.KERNEL.source_path.exists()
    assert set(fused_adamw.KERNEL.functions) == {
        "adamw_norm_chunks", "adamw_norm_leaves", "adamw_update"}
    assert fused_adamw.CHUNK % 8 == 0


def test_adamw_kernel_takes_plain_cuda_leaves_only():
    """CPU and ``meta`` leaves take the loop; so does an empty tree."""
    assert not fused_adamw.takes([torch.ones(2), torch.ones(2)])
    assert not fused_adamw.takes([torch.empty(2, device="meta")])
    assert not fused_adamw.takes([])


@pytest.mark.parametrize("g_dt,p_dt,s_dt", [
    (g, p, s) for g in (torch.bfloat16, torch.float32)
    for p in (torch.bfloat16, torch.float32)
    for s in (torch.float32, torch.bfloat16)])
def test_adamw_leaf_update_in_each_dtype_set_the_kernel_takes(g_dt, p_dt,
                                                              s_dt):
    """The loop's leaf, the plain version the kernel is held to, in each
    of the kernel's eight dtype sets: ``p'`` in ``p``'s dtype, ``m'`` and
    ``v'`` in the state's, each the f64 update rounded to its dtype."""
    cfg = AdamWConfig(lr=1e-2, weight_decay=0.1,
                      state_dtype=str(s_dt).removeprefix("torch."))
    gen = torch.Generator().manual_seed(0)
    draw = lambda scale: torch.randn(64, generator=gen) * scale
    g, p = draw(1.0).to(g_dt), draw(1.0).to(p_dt)
    m, v = draw(0.1).to(s_dt), draw(0.1).square().to(s_dt)
    bc1, bc2 = 1 - cfg.b1 ** 3, 1 - cfg.b2 ** 3
    got = adamw.leaf_update(g, m, v, p, torch.tensor(bc1), torch.tensor(bc2),
                            cfg.lr, cfg)
    assert [t.dtype for t in got] == [p_dt, s_dt, s_dt]
    gd, md, vd, pd = (t.double() for t in (g, m, v, p))
    mw = md * cfg.b1 + gd * (1 - cfg.b1)
    vw = vd * cfg.b2 + gd ** 2 * (1 - cfg.b2)
    pw = pd - cfg.lr * ((mw / bc1) / (torch.sqrt(vw / bc2) + cfg.eps) +
                        cfg.weight_decay * pd)
    for x, want in zip(got, (pw, mw, vw)):
        tol = 1e-2 if x.dtype == torch.bfloat16 else 1e-5
        np.testing.assert_allclose(x.double().numpy(), want.numpy(),
                                   rtol=tol, atol=tol * 1e-2)


@pytest.mark.parametrize("g_dt,p_dt,s_dt", [
    (torch.float16, torch.float32, torch.float32),
    (torch.float32, torch.float64, torch.float32),
    (torch.bfloat16, torch.bfloat16, torch.float16)])
def test_adamw_kernel_refuses_other_dtypes(g_dt, p_dt, s_dt):
    """On ``meta`` tensors: the table is refused before anything is
    allocated on a card or launched."""
    mk = lambda dt: [torch.empty(3, dtype=dt, device="meta")]
    with pytest.raises(TypeError, match="bf16 or f32"):
        fused_adamw.Leaves(mk(g_dt), mk(s_dt), mk(s_dt), mk(p_dt), s_dt)


def test_adamw_kernel_refuses_mismatched_leaves():
    meta = lambda shape, dt=torch.float32: [
        torch.empty(shape, dtype=dt, device="meta")]
    with pytest.raises(ValueError, match="differ in size"):
        fused_adamw.Leaves(meta(3), meta(3), meta(3), meta(4), torch.float32)
    with pytest.raises(TypeError, match="AdamW state"):
        fused_adamw.Leaves(meta(3), meta(3, torch.bfloat16), meta(3),
                           meta(3), torch.float32)
    with pytest.raises(ValueError, match="leaves"):
        fused_adamw.Leaves(meta(3), meta(3), meta(3), meta(3) + meta(3),
                           torch.float32)


def test_warmup_cosine_matches_jax():
    for warm, total, floor in ((5, 60, 0.1), (0, 10, 0.0), (10, 10, 0.2)):
        jsched = jschedule.warmup_cosine(warm, total, floor)
        sched = schedule.warmup_cosine(warm, total, floor)
        for s in range(61):
            np.testing.assert_allclose(
                float(sched(torch.tensor(s, dtype=torch.int32))),
                float(jsched(jnp.int32(s))), atol=1e-6)
    assert schedule.constant()(torch.tensor(3)) == 1.0


def test_three_train_steps_match_the_jitted_jax_step():
    arch, lr, steps = "llama3-8b", 1e-2, 3
    jcfg = jconfigs.get_smoke_config(arch)
    cfg = configs.get_smoke_config(arch)
    jmodel = JModel(jcfg)
    jocfg = JAdamWConfig(lr=lr)
    jstate = jstep.init_train_state(jmodel, jax.random.key(0), jocfg)
    state = train_state_from_jax(cfg, jax.tree.map(np.asarray, jstate),
                                 device=CPU)
    jtrain = jax.jit(jstep.build_train_step(
        jmodel, jocfg, grad_accum=2,
        lr_schedule=jschedule.warmup_cosine(2, 10)))
    train = step_mod.build_train_step(
        Model(cfg, device=CPU), AdamWConfig(lr=lr), grad_accum=2,
        lr_schedule=schedule.warmup_cosine(2, 10))
    data = SyntheticLM(cfg, batch=8, seq=16, seed=2)
    for i in range(steps):
        batch = data.batch_at(i)
        jstate, jm = jtrain(jstate, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
        state, m = train(state, batch)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-4)
        want = train_state_from_jax(cfg, jax.tree.map(np.asarray, jstate),
                                    device=CPU)
        # a near-zero gradient's sign flip moves Adam's step by up to 2 lr
        for a, b in zip(_leaves(state["params"]), _leaves(want["params"])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=2.1 * lr * (i + 1))
    assert int(state["step"]) == int(jstate["step"]) == steps
    assert int(state["opt"]["count"]) == steps


def test_train_state_from_jax_mirrors_init_train_state():
    cfg = configs.get_smoke_config("qwen1.5-32b")
    ocfg = AdamWConfig()
    jstate = jstep.init_train_state(
        JModel(jconfigs.get_smoke_config("qwen1.5-32b")), jax.random.key(0),
        JAdamWConfig())
    carried = train_state_from_jax(cfg, jax.tree.map(np.asarray, jstate),
                                   device=CPU)
    fresh = step_mod.init_train_state(Model(cfg, device=CPU), 0, ocfg)
    assert pytree.tree_structure(carried) == pytree.tree_structure(fresh)
    for a, b in zip(_leaves(carried), _leaves(fresh)):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_train_step_is_pure(small):
    cfg, model, ocfg, state = small
    before = [t.clone() for t in _leaves(state)]
    train = step_mod.build_train_step(model, ocfg)
    new, _ = train(state, SyntheticLM(cfg, batch=2, seq=8).batch_at(0))
    assert all(torch.equal(a, b) for a, b in zip(before, _leaves(state)))
    assert int(new["step"]) == int(state["step"]) + 1
    assert not any(p.requires_grad for p in _leaves(new))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", ["dense", "vlm", "encdec"])
def test_synthetic_lm_matches_jax(dtype, family):
    kw = dict(param_dtype=dtype, compute_dtype=dtype, family=family)
    if family == "vlm":
        kw["n_vision_tokens"] = 3
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("llama3-8b"), **kw)
    cfg = dataclasses.replace(configs.get_smoke_config("llama3-8b"), **kw)
    for shard in (0, 1):
        want = JSyntheticLM(jcfg, batch=4, seq=12, seed=11, shard=shard,
                            num_shards=2).batch_at(5)
        got = SyntheticLM(cfg, batch=4, seq=12, seed=11, shard=shard,
                          num_shards=2).batch_at(5)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            if dtype == "bfloat16" and v.dtype.kind == "V":
                # the port's extras are f32; JAX's are those values in bf16
                assert got[k].dtype == np.float32
                got_k = np.asarray(jnp.asarray(got[k], jnp.bfloat16))
                np.testing.assert_array_equal(got_k.view(np.uint16),
                                              v.view(np.uint16))
            else:
                assert got[k].dtype == v.dtype
                np.testing.assert_array_equal(got[k], v)


def _ckpt_tree(rng):
    bf = rng.standard_normal((3, 5)).astype(np.float32)
    return {"a": bf, "b": [rng.integers(0, 9, 4).astype(np.int32),
                           {"c": np.float32(2.5)}],
            "d": rng.standard_normal(7).astype(np.float32)}


def test_jax_checkpoint_reads_in_the_port(tmp_path):
    host = _ckpt_tree(np.random.default_rng(0))
    jtree = jax.tree.map(jnp.asarray, host)
    jtree["a"] = jtree["a"].astype(jnp.bfloat16)
    jckpt.save(str(tmp_path), 7, jtree)
    leaves, manifest = ckpt.restore(str(tmp_path))
    assert manifest["step"] == 7
    assert manifest["leaves"][0]["dtype"] == "bfloat16"
    for got, want in zip(leaves, jax.tree.leaves(jtree)):
        if want.dtype == jnp.bfloat16:
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                got.view(torch.int16).numpy(),
                np.asarray(want).view(np.int16))
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    target = {"a": torch.zeros(0), "b": [torch.zeros(0), {"c": torch.zeros(0)}],
              "d": torch.zeros(0)}
    tree, _ = ckpt.restore(str(tmp_path), target=target)
    assert tree["a"].dtype == torch.bfloat16 and tree["b"][1]["c"].shape == ()


def test_port_checkpoint_reads_in_jax(tmp_path):
    host = _ckpt_tree(np.random.default_rng(1))
    tree = pytree.tree_map(lambda a: torch.from_numpy(np.asarray(a)), host)
    tree["a"] = tree["a"].bfloat16()
    ckpt.save(str(tmp_path), 3, tree, metadata={"by": "port"})
    arrays, manifest = jckpt.restore(str(tmp_path))
    assert manifest["metadata"] == {"by": "port"}
    jtree, _ = jckpt.restore(str(tmp_path), target=jax.tree.map(
        jnp.asarray, host))
    for want, got in zip(_leaves(tree), jax.tree.leaves(jtree)):
        if want.dtype == torch.bfloat16:
            assert got.dtype == jnp.bfloat16
            np.testing.assert_array_equal(np.asarray(got).view(np.int16),
                                          want.view(torch.int16).numpy())
        else:
            np.testing.assert_array_equal(np.asarray(got), want.numpy())


# ----------------------------------------------------------------------------
# the kernel stays out of gradients; the model and the launcher
# ----------------------------------------------------------------------------
def test_kernel_attention_raises_under_grad():
    cfg = configs.get_smoke_config("qwen3-1.7b")
    model = Model(cfg, attn_impl="kernel", device=CPU)
    params = model.init(0)
    batch = SyntheticLM(cfg, batch=2, seq=8).batch_at(0)
    with pytest.raises(NotImplementedError, match="ROADMAP B6"):
        step_mod.loss_and_grads(model, plain_tree(params), batch)
    x = torch.randn(1, 8, cfg.d_model, requires_grad=True)
    block = plain_tree(params)["layers"][0]["attn"]
    with pytest.raises(NotImplementedError, match="forward only"):
        attn_mod.attention(block, cfg, x, torch.arange(8)[None], impl="kernel")
    with torch.no_grad():
        attn_mod.attention(block, cfg, x, torch.arange(8)[None], impl="kernel")
    logits, _ = model.forward(params, batch)          # serving is unchanged
    assert bool(torch.isfinite(logits).all())


def test_model_loss_and_train_input_specs():
    cfg = configs.get_smoke_config("nemotron-4-340b")
    model = Model(cfg, device=CPU)
    specs = train_input_specs(cfg, 4, 32)
    assert {k: (tuple(v.shape), v.dtype, v.device.type)
            for k, v in specs.items()} == {
        "tokens": ((4, 32), torch.int32, "meta"),
        "labels": ((4, 32), torch.int32, "meta")}
    loss, parts = model.loss(model.init(0),
                             SyntheticLM(cfg, batch=2, seq=8).batch_at(0))
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert abs(float(loss) - np.log(cfg.vocab_size)) < 1.0
    with pytest.raises(ValueError, match="family 'foo'"):
        train_input_specs(dataclasses.replace(cfg, family="foo"), 1, 1)


def test_launch_train_runs_and_restores(tmp_path, capsys):
    argv = ["--arch", "qwen3-1.7b", "--steps", "4", "--batch", "2", "--seq",
            "16", "--log-every", "2", "--device", "cpu",
            "--ckpt", str(tmp_path), "--ckpt-every", "2"]
    assert launch_train.main(argv) == 0
    out = capsys.readouterr().out
    assert "step     2 loss=" in out and "step     4 loss=" in out
    assert ckpt.all_steps(str(tmp_path)) == [2, 4]
    rows = launch_train.run(launch_train.parse_args(
        argv[:3] + ["6"] + argv[4:]))
    assert [r["step"] for r in rows] == [5, 6]
    assert all(np.isfinite(r["loss"]) and r["wall_s"] > 0 for r in rows)
    rows = launch_train.run(launch_train.parse_args(
        ["--arch", "nemotron-4-340b", "--steps", "3", "--batch", "2",
         "--seq", "8", "--grad-accum", "2", "--device", "cpu"]))
    assert len(rows) == 3 and set(rows[0]) >= {"loss", "grad_norm", "ce"}

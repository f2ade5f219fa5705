"""The port's flash attention (kernel B6's plain version) and its dense
decoder prefill against the JAX package.

Attention: the same numpy inputs go through the Pallas kernel, interpreted
on the CPU as ``tests/test_kernels.py`` runs it, and through the port,
within that file's tolerances (2e-4 for f32, 3e-2 for bf16). One
difference is by design and pinned here: a query that sees no key (Sq >
Skv, right-aligned) comes out 0 from the port, where the JAX oracle gives
NaN.

Model: the JAX package's qwen3-1.7b smoke config is initialised by JAX,
its parameters are handed to the port through ``convert.params_from_jax``,
and both forward passes see the same tokens. f32 logits must agree
within 2e-4 (what the attention kernel is held to; measured ~6e-7), bf16
ones within the bf16 kernel tolerance 3e-2 (measured ~9e-3 on logits of
magnitude ~0.7). The hand-written kernel itself runs only on a card.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.kernels import ref as jref
from repro.kernels.flash_attention import pallas_flash_attention
from repro.models import Model as JModel
from repro.models import layers as jlayers
from repro_torch.configs import (ARCHS, PORT_ONLY, SHAPES, ModelConfig,
                                 get_config, get_smoke_config, list_archs,
                                 shape_applicable)
from repro_torch.convert import params_from_jax
from repro_torch.kernels import KERNELS, ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import Model
from repro_torch.models import layers

ARCH = "qwen3-1.7b"


def _qkv(seed, b, h, hkv, sq, skv, d, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, d), np.float32).astype(dtype),
            rng.standard_normal((b, hkv, skv, d), np.float32).astype(dtype),
            rng.standard_normal((b, hkv, skv, d), np.float32).astype(dtype))


def _pallas(q, k, v, **kw):
    return np.asarray(pallas_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bq=64, bk=64,
        interpret=True, **kw), np.float32)


def _t(x):
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.astype(np.float32)).bfloat16()
    return torch.from_numpy(x)


# ----------------------------------------------------------------------------
# B6 flash attention
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("b,h,hkv,sq,skv,d", [
    (1, 2, 2, 128, 128, 64),     # MHA square
    (2, 4, 2, 128, 256, 64),     # GQA, kv longer (decode-ish)
    (1, 8, 1, 64, 128, 128),     # MQA
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_pallas(b, h, hkv, sq, skv, d, causal):
    q, k, v = _qkv(sq + skv + d, b, h, hkv, sq, skv, d)
    want = _pallas(q, k, v, causal=causal)
    for got in (flash_attention(_t(q), _t(k), _t(v), causal=causal),
                ops.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                                    impl="ref")):
        assert got.dtype == torch.float32 and got.shape == q.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("d", [32, 72, 80, 96, 160])
def test_flash_attention_matches_pallas_at_the_new_head_dims(d):
    """The head dims the kernels took on in their widths 32, 96 and 160
    (phi-2's 80 and phi-3-mini's 96 among them; 72 and 80 run padded to
    96): GQA, causal, with a window across tiles, against the Pallas
    kernel, which takes any head dim."""
    q, k, v = _qkv(d, 1, 4, 2, 128, 192, d)
    want = _pallas(q, k, v, causal=True, window=100)
    got = flash_attention(_t(q), _t(k), _t(v), causal=True, window=100)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("d", [272, 320, 512])
def test_flash_attention_matches_pallas_above_256(d):
    """Head dims past the widest kernel, which the card runs in slabs of O
    (272 and 320 on 2 x 160, 512 on 2 x 256): GQA, causal, a window
    across tiles, against the Pallas kernel, whose blocks take the whole
    head dim."""
    q, k, v = _qkv(d, 1, 4, 2, 128, 192, d)
    want = _pallas(q, k, v, causal=True, window=100)
    got = flash_attention(_t(q), _t(k), _t(v), causal=True, window=100)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("window", [32, 100, 256])
def test_flash_attention_local_window(window):
    q, k, v = _qkv(window, 1, 2, 2, 128, 256, 64)
    got = flash_attention(_t(q), _t(k), _t(v), causal=True, window=window)
    np.testing.assert_allclose(got.numpy(),
                               _pallas(q, k, v, causal=True, window=window),
                               rtol=2e-4, atol=2e-4)


def test_flash_attention_bf16():
    q, k, v = _qkv(7, 1, 2, 2, 128, 128, 64, jnp.bfloat16)
    got = flash_attention(_t(q), _t(k), _t(v), causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               _pallas(q, k, v, causal=True),
                               rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("window", [None, 16])
def test_query_that_sees_no_key_gives_zero(window):
    """Sq = 128 > Skv = 64: the first 64 queries sit before every key.
    Their 64-query tile is wholly masked, which the Pallas kernel skips
    and finishes as 0; the port gives 0 for every such row (the JAX oracle
    gives NaN)."""
    q, k, v = _qkv(3, 1, 2, 1, 128, 64, 64)
    got = flash_attention(_t(q), _t(k), _t(v), causal=True,
                          window=window).numpy()
    assert (got[:, :, :64] == 0).all()
    np.testing.assert_allclose(got, _pallas(q, k, v, causal=True,
                                            window=window),
                               rtol=2e-4, atol=2e-4)
    oracle = np.asarray(jref.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v), causal=True,
                                             window=window))
    assert np.isnan(oracle[:, :, :64]).all()
    np.testing.assert_allclose(got[:, :, 64:], oracle[:, :, 64:],
                               rtol=2e-4, atol=2e-4)


def test_blind_rows_inside_a_seeing_tile_are_zero():
    """Sq = 100, Skv = 60: rows 0..39 see no key but share tiles with
    rows that do; they are 0, the rest match the oracle."""
    q, k, v = _qkv(4, 1, 2, 2, 100, 60, 32)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=True).numpy()
    assert (got[:, :, :40] == 0).all()
    oracle = np.asarray(jref.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v), causal=True))
    np.testing.assert_allclose(got[:, :, 40:], oracle[:, :, 40:],
                               rtol=2e-4, atol=2e-4)


def test_flash_attention_rejects_bad_inputs():
    q, k, v = (_t(x) for x in _qkv(5, 1, 3, 2, 8, 8, 16))
    with pytest.raises(ValueError):                 # Hkv does not divide H
        flash_attention(q, k, v)
    q, k, v = (_t(x) for x in _qkv(5, 1, 2, 2, 8, 8, 16))
    with pytest.raises(TypeError):
        flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError):
        flash_attention(q, k, v, window=0)
    before = {k_.name: k_.launches for k_ in KERNELS}
    flash_attention(q, k, v)                        # CPU: the plain version
    assert {k_.name: k_.launches for k_ in KERNELS} == before


# ----------------------------------------------------------------------------
# configs and layers
# ----------------------------------------------------------------------------
#: the port's own fields (``sub.field`` in a sub-config), each at the value
#: under which a config computes as the JAX package does
PORT_ONLY_NEUTRAL = {"rope": True, "attention_multiplier": None,
                     "embedding_multiplier": 1.0, "residual_multiplier": 1.0,
                     "logits_scaling": 1.0, "norm_eps": 1e-6,
                     "moe.shared_d_ff": 0}


def _split_fields(ours: dict, theirs: dict, prefix: str = ""):
    """(``ours`` cut to the keys ``theirs`` has, sub-dicts alike; the
    fields only ``ours`` has, as ``{"sub.field": value}``)."""
    same, extra = {}, {}
    for key, value in ours.items():
        if key not in theirs:
            extra[prefix + key] = value
        elif isinstance(value, dict):
            same[key], more = _split_fields(value, theirs[key],
                                            f"{prefix}{key}.")
            extra.update(more)
        else:
            same[key] = value
    return same, extra


def test_configs_are_copies_of_the_jax_configs():
    assert ARCHS == tuple(jconfigs.list_archs())
    assert list_archs() == jconfigs.list_archs() and SHAPES == jconfigs.SHAPES
    for arch in ARCHS:
        for ours, theirs in ((get_config(arch), jget_config(arch)),
                             (get_smoke_config(arch), jget_smoke(arch))):
            assert isinstance(ours, ModelConfig)
            theirs_d = dataclasses.asdict(theirs)
            same, extra = _split_fields(dataclasses.asdict(ours), theirs_d)
            # every field of JAX's ModelConfig, sub-configs too, equal
            assert same == theirs_d
            # and every field of the port's own at its neutral default
            assert extra == PORT_ONLY_NEUTRAL, arch
            assert ours.param_count() == theirs.param_count()
            for shape in SHAPES:
                assert shape_applicable(ours, shape) == \
                    jconfigs.shape_applicable(theirs, shape)
    assert get_config(ARCH).dtype() == torch.bfloat16
    assert get_smoke_config(ARCH).dtype() == torch.float32
    with pytest.raises(KeyError, match="the port runs"):
        get_config("foo")


def test_port_only_archs_resolve_outside_the_jax_list():
    """granite-4.0-h-small resolves in the port, while ``ARCHS`` and
    ``list_archs()`` stay the JAX package's list."""
    assert PORT_ONLY == ("granite-4.0-h-small",)
    assert ARCHS == tuple(jconfigs.list_archs())
    assert list_archs() == jconfigs.list_archs()
    for arch in PORT_ONLY:
        assert arch not in ARCHS and arch not in jconfigs.list_archs()
        for cfg in (get_config(arch), get_smoke_config(arch)):
            assert isinstance(cfg, ModelConfig)
            assert cfg.name.startswith(arch)
            _, extra = _split_fields(dataclasses.asdict(cfg),
                                     dataclasses.asdict(jget_config(ARCH)))
            assert extra.keys() == PORT_ONLY_NEUTRAL.keys()
            assert extra != PORT_ONLY_NEUTRAL


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm_matches_jax(kind):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 48), np.float32) * 3 + 1
    p = {"scale": rng.standard_normal(48).astype(np.float32),
         "bias": rng.standard_normal(48).astype(np.float32)}
    want = np.asarray(jlayers.apply_norm(jax.tree.map(jnp.asarray, p),
                                         jnp.asarray(x), kind))
    got = layers.apply_norm({k: torch.from_numpy(a) for k, a in p.items()},
                            torch.from_numpy(x), kind)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_apply_rope_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 40, 3, 32), np.float32)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32) * 7, (2, 40))
    want = np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                         1_000_000.0))
    got = layers.apply_rope(torch.from_numpy(x),
                            torch.from_numpy(np.ascontiguousarray(pos)),
                            1_000_000.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


# ----------------------------------------------------------------------------
# the dense decoder's prefill forward
# ----------------------------------------------------------------------------
def _jax_and_port_params(cfg, seed):
    jparams = JModel(cfg).init(jax.random.key(seed))
    return jparams, params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                                    device="cpu")


@pytest.mark.parametrize("jimpl,impl", [("pallas", "kernel"), ("xla", "ref")])
def test_prefill_logits_match_jax(jimpl, impl):
    cfg = get_smoke_config(ARCH)
    jparams, params = _jax_and_port_params(cfg, 0)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32)
    want, _ = JModel(cfg, attn_impl=jimpl).forward(jparams, {"tokens": tokens})
    got, aux = Model(cfg, attn_impl=impl, device="cpu").forward(
        params, {"tokens": tokens})
    assert got.shape == (2, 32, cfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)


def test_bf16_prefill_keeps_dtypes_and_matches_jax():
    cfg = dataclasses.replace(get_smoke_config(ARCH), param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    jparams, params = _jax_and_port_params(cfg, 1)
    assert {p.dtype for p in params.parameters()} == {torch.bfloat16}
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32)
    want, _ = JModel(cfg, attn_impl="pallas").forward(jparams,
                                                      {"tokens": tokens})
    got, _ = Model(cfg, attn_impl="kernel", device="cpu").forward(
        params, {"tokens": tokens})
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=3e-2, atol=3e-2)


def test_params_from_jax_unstacks_layers():
    cfg = get_smoke_config(ARCH)
    jparams, params = _jax_and_port_params(cfg, 2)
    assert len(params["layers"]) == cfg.n_layers
    stacked = np.asarray(jparams["groups"][0][0]["attn"]["wq"])
    for i, block in enumerate(params["layers"]):
        np.testing.assert_array_equal(block["attn"]["wq"].numpy(), stacked[i])
    assert "head" not in params          # tied embeddings


def test_init_matches_the_jax_parameter_shapes():
    cfg = get_smoke_config(ARCH)
    params = Model(cfg, device="cpu").init(0)
    jshapes = JModel(cfg).param_shapes()
    _, ported = _jax_and_port_params(cfg, 0)
    assert {n: tuple(p.shape) for n, p in params.named_parameters()} == \
        {n: tuple(p.shape) for n, p in ported.named_parameters()}
    n_jax = sum(int(np.prod(leaf.shape))
                for leaf in jax.tree.leaves(jshapes))
    assert sum(p.numel() for p in params.parameters()) == n_jax
    again = Model(cfg, device="cpu").init(0)
    assert all(torch.equal(a, b) for a, b in zip(params.parameters(),
                                                 again.parameters()))


def test_model_rejects_other_families_and_impls():
    with pytest.raises(ValueError, match="family 'foo'"):
        Model(dataclasses.replace(get_smoke_config(ARCH), family="foo"),
              device="cpu")
    with pytest.raises(ValueError, match="attn_impl"):
        Model(get_smoke_config(ARCH), attn_impl="pallas", device="cpu")


def test_kernel_attention_refuses_a_softcap():
    cfg = dataclasses.replace(get_smoke_config(ARCH), attn_logit_softcap=30.0)
    params = Model(cfg, device="cpu").init(0)
    tokens = np.zeros((1, 8), np.int64)
    with pytest.raises(NotImplementedError, match="softcap"):
        Model(cfg, attn_impl="kernel", device="cpu").forward(
            params, {"tokens": tokens})
    logits, _ = Model(cfg, attn_impl="ref", device="cpu").forward(
        params, {"tokens": tokens})
    assert bool(torch.isfinite(logits).all())


def test_model_binds_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(LookupError):
        Model(get_smoke_config(ARCH))

"""granite-4.0-h-small in the port: a hybrid of Mamba-2 SSD mixers and
global NoPE attention, 72 top-10 experts and a shared expert in every
layer, scaled embedding, residual and logit paths.

At smoke sizes on the CPU in f32, on seeded random weights, the port's
prefill logits (each attention implementation, through the stage actors
too) and its decode through the cache are held to the benchmark's plain
reference, ``bench_h100/reference/granite-4.0-h-small.py``, which imports
nothing of the port; the reference's closed-form SSD is held to the
recurrence stepped one token at a time. The published config's layer
kinds and parameter count are checked on ``meta``, and each of the port's
new config fields is shown to compute as before at its neutral default
and to change the logits away from it.
"""
import dataclasses
import json
import os
import sys

import pytest
import torch

from repro_torch import trace
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import ActorSystem, DeviceRef
from repro_torch.dist.pipeline import PipelineRunner, make_layer_stage_actors
from repro_torch.models import Model
from repro_torch.models.attention import softmax_scale
from repro_torch.models.layers import plain_tree
from repro_torch.models.transformer import layer_kinds

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

ARCH = "granite-4.0-h-small"
CPU = torch.device("cpu")


def _reference():
    from bench_h100 import spec
    return spec.reference(ARCH)


def _run(cfg):
    return {"run": json.loads(json.dumps(dataclasses.asdict(cfg)))}


def _no_drops(cfg):
    """``cfg`` with a capacity of a whole routing group: no expert drops
    a token, so routing one token at a time routes as a whole sequence."""
    moe = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        moe, capacity_factor=moe.n_experts / moe.top_k))


def _tokens(cfg, b, s, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (b, s), generator=g)


def _ref_logits(ref, params, cfg, tokens, mode="f32"):
    """The reference's logits at every position of ``tokens`` [B,S]."""
    b, s = tokens.shape
    rows = torch.arange(b).repeat_interleave(s)
    cols = torch.arange(s).repeat(b)
    return ref.logits_at(plain_tree(params), _run(cfg), tokens, rows, cols,
                         mode=mode).reshape(b, s, -1)


def _close(got, want):
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)


# ----------------------------------------------------------------------------
# the published configuration
# ----------------------------------------------------------------------------
def test_published_config_layer_kinds_and_parameter_count():
    cfg = get_config(ARCH)
    kinds = layer_kinds(cfg)
    assert len(kinds) == 40
    assert [i for i, k in enumerate(kinds) if k == "attn"] == [5, 15, 25, 35]
    tree = Model(cfg, device="meta").param_shapes()
    n = sum(t.numel() for t in tree.parameters())
    d, v, e, f, fs = 4096, 100352, 72, 768, 1536
    di, conv, heads = 8192, 8192 + 2 * 128, 128
    ffn = 2 * d + d * e + 3 * e * d * f + 3 * d * fs      # norms, router
    mamba = d * (di + conv + heads) + 4 * conv + conv + 3 * heads + di + \
        di * d
    attn = 2 * d * 4096 + 2 * d * 1024
    assert n == v * d + d + 36 * (mamba + ffn) + 4 * (attn + ffn)
    assert round(n / 1e9, 2) == 32.21
    assert round(36 * (mamba + ffn) / 36 / 1e6, 1) == 800.9
    assert round(4 * (attn + ffn) / 4 / 1e6, 1) == 740.6
    assert cfg.param_dtype == "bfloat16" and n * 2 / 1e9 == pytest.approx(
        64.4, abs=0.05)


# ----------------------------------------------------------------------------
# against the plain reference
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("impl", ["ref", "kernel", "ref_chunked:8"])
def test_prefill_logits_match_the_reference(impl):
    """Two sequences of 32 (four SSD chunks of 8, capacity drops in the
    experts) through every layer kind and the scaled paths."""
    cfg = get_smoke_config(ARCH)
    model = Model(cfg, attn_impl=impl, device=CPU)
    params = model.init(5)
    tokens = _tokens(cfg, 2, 32, seed=6)
    got, _ = model.forward(params, {"tokens": tokens})
    want = _ref_logits(_reference(), params, cfg, tokens)
    _close(got, want)
    # the fp8 control of the reference reads far from both
    fp8 = _ref_logits(_reference(), params, cfg, tokens, mode="fp8")
    assert float((fp8 - want).abs().max()) > 100 * float(
        (got - want).abs().max())


def test_prompt_then_decode_through_the_cache_matches_the_reference():
    """A prompt of 12 tokens stepped into the cache, then 8 new tokens
    decoded from it: every step's logits against the reference's full
    forward over all 20 (capacity of a whole group, so routing one token
    at a time routes as the whole sequence)."""
    cfg = _no_drops(get_smoke_config(ARCH))
    model = Model(cfg, device=CPU)
    params = model.init(7)
    tokens = _tokens(cfg, 2, 20, seed=8)
    cache = model.init_cache(2, 20)
    steps = []
    for t in range(20):
        logits, cache = model.decode_step(params, tokens[:, t:t + 1], cache)
        steps.append(logits)
    assert int(cache["len"]) == 20
    want = _ref_logits(_reference(), params, cfg, tokens)
    _close(torch.cat(steps, dim=1), want)
    # the global attention layer keeps every position
    kv = cache["groups"][0][1]["k"]
    assert kv.shape[2] == 20


def test_reference_ssd_is_the_recurrence():
    """The reference's closed form, in blocks smaller than the sequence,
    against S_t = exp(Δ_t A) S_{t−1} + Δ_t B_t ⊗ x_t, y_t = C_t · S_t,
    stepped one token at a time in f64."""
    ref = _reference()
    g = torch.Generator().manual_seed(9)
    b, s, h, p, n, groups = 2, 37, 6, 5, 4, 2
    cm = torch.randn(b, s, groups, n, generator=g)
    bm = torch.randn(b, s, groups, n, generator=g)
    x = torch.randn(b, s, h, p, generator=g)
    delta = torch.rand(b, s, h, generator=g) * 0.5
    a = -torch.rand(h, generator=g) * 4
    q_block, h_block = ref.SSD_Q_BLOCK, ref.SSD_H_BLOCK
    ref.SSD_Q_BLOCK, ref.SSD_H_BLOCK = 16, 4
    try:
        got = ref.ssd(cm, bm, x * delta[..., None], delta * a,
                      ref.Arith("f32"))
    finally:
        ref.SSD_Q_BLOCK, ref.SSD_H_BLOCK = q_block, h_block
    per = h // groups
    state = torch.zeros(b, h, n, p, dtype=torch.float64)
    want = []
    for t in range(s):
        bt = bm[:, t].double().repeat_interleave(per, 1)
        ct = cm[:, t].double().repeat_interleave(per, 1)
        dt = delta[:, t].double()
        state = state * torch.exp(dt * a.double())[..., None, None] + \
            torch.einsum("bhn,bhp->bhnp", bt, x[:, t].double() * dt[..., None])
        want.append(torch.einsum("bhn,bhnp->bhp", ct, state))
    torch.testing.assert_close(got.double(), torch.stack(want, 1),
                               rtol=1e-5, atol=1e-5)


def test_stage_actors_give_the_fused_logits():
    """The benchmark's path: ``make_layer_stage_actors`` and
    ``PipelineRunner.submit(..., emit="ref")``, one stage and two, bit for
    bit the fused forward's logits, the logit divisor applied by the one
    head function."""
    cfg = get_smoke_config(ARCH)
    model = Model(cfg, attn_impl="kernel", device=CPU)
    params = model.init(11)
    tokens = _tokens(cfg, 2, 16, seed=12)
    want, _ = model.forward(params, {"tokens": tokens})
    system = ActorSystem(max_workers=4, device="cpu")
    try:
        for n_stages in (1, 2):
            runner = PipelineRunner(system, make_layer_stage_actors(
                system, model, params, n_stages))
            ref = runner.submit(tokens, emit="ref").result(timeout=60)
            assert isinstance(ref, DeviceRef)
            assert torch.equal(ref.array, want)
    finally:
        system.shutdown()


def test_the_ssd_and_shared_expert_record_their_spans():
    cfg = get_smoke_config(ARCH)
    model = Model(cfg, device=CPU)
    params = model.init(13)
    tokens = _tokens(cfg, 2, 32, seed=14)
    trace.reset()
    with trace.recording():
        model.forward(params, {"tokens": tokens})
        spans = trace.spans()
        counters = trace.counters()
    names = [s.name for s in spans]
    n_ssm = layer_kinds(cfg).count("ssm")
    for name in ("ssm.in", "ssm.conv", "ssm.scan", "ssm.out"):
        assert names.count(name) == n_ssm, name
    assert names.count("moe.shared") == cfg.n_layers
    assert counters["ssm.chunks"] == n_ssm * 32 // cfg.ssm.chunk
    scans = sum(s.end - s.start for s in spans if s.name == "ssm.scan")
    assert 0 < counters["ssm.scan_device_ns"] <= scans
    kinds = [s.attrs["kind"] for s in spans if s.name == "layer"]
    assert kinds == layer_kinds(cfg)
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.name.startswith("ssm."):
            assert by_id[s.parent].name in ("layer", "ssm.conv", "ssm.scan",
                                            "ssm.in", "ssm.out")


def test_counts_give_the_published_work_a_token():
    """The benchmark's counts: 17.6 GFLOP of weights a token (the Mamba
    projections 7.4, the routed experts 7.6, the shared 1.5, attention's
    projections 0.34, the head 0.8), and B6's bound of four launches."""
    from bench_h100 import flops, spec
    with open(os.path.join(ROOT, "bench_h100", "configs",
                           f"{ARCH}.json")) as f:
        run = json.load(f)["run"]
    counts = spec.counts(ARCH)
    own = spec._load("counts", ARCH)
    per_token = 2 * own.weights_per_token(run)
    parts = {"mamba": 36 * 2 * (4096 * 16768 + 8192 * 4096),
             "experts": 40 * 2 * 10 * 3 * 4096 * 768,
             "shared": 40 * 2 * 3 * 4096 * 1536,
             "router": 40 * 2 * 4096 * 72,
             "attention": 4 * 2 * (2 * 4096 * 4096 + 2 * 4096 * 1024),
             "head": 2 * 4096 * 100352}
    assert per_token == sum(parts.values())
    assert [round(parts[k] / 1e9, 2) for k in
            ("mamba", "experts", "shared", "attention", "head")] == \
        [7.36, 7.55, 1.51, 0.34, 0.82]
    assert round(per_token / 1e9, 1) == 17.6
    seq = 4096
    ssd = own.ssd_flops(run, 1, seq)
    chunks = seq // 256
    assert ssd == chunks * (256 * 257 // 2) * (2 * 128 + 2 * 64 * 128) + \
        seq * 4 * 128 * 64 * 128
    attn = 4 * 4.0 * 32 * 128 * flops.causal_pairs(seq)
    assert counts.prefill_flops(run, 1, seq) == \
        per_token * seq + attn + 36 * ssd
    assert counts.flash_bound_s(run, 2, seq) == \
        4 * flops.flash_bound_s(run, 2, seq)


# ----------------------------------------------------------------------------
# the new fields: neutral at their defaults
# ----------------------------------------------------------------------------
FIELDS = [("rope", True, False),
          ("attention_multiplier", "1/sqrt(Dh)", 0.0078125),
          ("embedding_multiplier", 1.0, 12.0),
          ("residual_multiplier", 1.0, 0.22),
          ("logits_scaling", 1.0, 16.0),
          ("norm_eps", 1e-6, 1e-5)]


def _prefill_and_step(model, params, tokens, steps=4):
    """(prefill logits, the logits of ``steps`` decode steps through the
    cache)."""
    logits, _ = model.forward(params, {"tokens": tokens})
    cache = model.init_cache(tokens.shape[0], steps)
    out = []
    for t in range(steps):
        step, cache = model.decode_step(params, tokens[:, t:t + 1], cache)
        out.append(step)
    return logits, torch.cat(out, dim=1)


@pytest.mark.parametrize("impl", ["ref", "kernel"])
@pytest.mark.parametrize("field,neutral,other", FIELDS,
                         ids=[f[0] for f in FIELDS])
def test_a_field_at_its_neutral_value_computes_as_unset(field, neutral,
                                                        other, impl):
    """qwen3-1.7b's smoke config (RoPE, 1/√Dh, no multipliers) as the
    unset case: the field set to its neutral value gives the same prefill
    and decode logits bit for bit, and the other value changes both."""
    base = get_smoke_config("qwen3-1.7b")
    if neutral == "1/sqrt(Dh)":
        neutral = base.resolved_head_dim ** -0.5
        assert softmax_scale(base) == neutral
    assert getattr(base, field) == (None if field == "attention_multiplier"
                                    else neutral)
    params = Model(base, device=CPU).init(15)
    tokens = _tokens(base, 2, 16, seed=16)
    unset = _prefill_and_step(Model(base, attn_impl=impl, device=CPU),
                              params, tokens)
    same = _prefill_and_step(Model(dataclasses.replace(
        base, **{field: neutral}), attn_impl=impl, device=CPU), params,
        tokens)
    moved = _prefill_and_step(Model(dataclasses.replace(
        base, **{field: other}), attn_impl=impl, device=CPU), params, tokens)
    for u, s, m in zip(unset, same, moved):
        assert torch.equal(u, s)
        assert not torch.allclose(u, m, rtol=1e-6, atol=0)
    if field == "rope":
        # the first position's logits do not depend on the rotation
        torch.testing.assert_close(unset[0][:, 0], moved[0][:, 0])


def test_shared_expert_at_width_zero_computes_as_unset():
    """phi-3.5-moe's smoke config has no shared expert: width 0 gives its
    parameter tree and its logits bit for bit; a shared expert's MLP adds
    to the routed experts' output, in prefill and decode."""
    base = get_smoke_config("phi3.5-moe-42b-a6.6b")
    assert base.moe.shared_d_ff == 0
    zero = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, shared_d_ff=0))
    with_shared = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, shared_d_ff=48))
    full = Model(with_shared, device=CPU).init(17)
    tree = plain_tree(full)
    for layer in tree["layers"]:
        assert layer["moe"]["shared"]["w_up"].shape == (base.d_model, 48)
    stripped = plain_tree(full)
    for layer in stripped["layers"]:
        del layer["moe"]["shared"]
    unset_shapes = plain_tree(Model(base, device="meta").param_shapes())
    assert json.dumps(unset_shapes, default=lambda t: list(t.shape)) == \
        json.dumps(plain_tree(Model(zero, device="meta").param_shapes()),
                   default=lambda t: list(t.shape)) == \
        json.dumps(stripped, default=lambda t: list(t.shape))
    tokens = _tokens(base, 2, 16, seed=18)
    unset = _prefill_and_step(Model(base, device=CPU), stripped, tokens)
    same = _prefill_and_step(Model(zero, device=CPU), stripped, tokens)
    moved = _prefill_and_step(Model(with_shared, device=CPU), tree, tokens)
    for u, s, m in zip(unset, same, moved):
        assert torch.equal(u, s)
        assert not torch.allclose(u, m, rtol=1e-6, atol=0)

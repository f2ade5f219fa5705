"""The frozen counts equal hand counts at two shapes."""
import math

import pytest

from bench_h100 import flops
from bench_h100.peaks import BF16_FLOPS, HBM_BYTES_PER_S

QWEN = dict(family="dense", n_layers=28, d_model=2048, n_heads=16,
            n_kv_heads=8, d_ff=6144, vocab_size=151936, head_dim=128,
            mlp="swiglu")
PHI = dict(family="moe", n_layers=16, d_model=4096, n_heads=32,
           n_kv_heads=8, d_ff=6400, vocab_size=32064, head_dim=128,
           mlp="swiglu", moe=dict(n_experts=16, top_k=2))


def test_matmul_params_by_hand():
    # qwen3-1.7b: q 2048x2048, k and v 2048x1024, o 2048x2048, MLP 3 x
    # 2048x6144, head 2048x151936
    attn = 2048 * 2048 * 2 + 2048 * 1024 * 2
    mlp = 3 * 2048 * 6144
    assert flops.matmul_params_per_token(QWEN) == 28 * (attn + mlp) + \
        2048 * 151936
    # phi3.5-moe: q, o 4096x4096, k, v 4096x1024, two of 16 experts of
    # 3 x 4096x6400, router 4096x16, head 4096x32064
    attn = 4096 * 4096 * 2 + 4096 * 1024 * 2
    moe = 2 * 3 * 4096 * 6400 + 4096 * 16
    assert flops.matmul_params_per_token(PHI) == 16 * (attn + moe) + \
        4096 * 32064


@pytest.mark.parametrize("b,s", [(16, 512), (1, 32768)])
def test_prefill_and_train_flops_by_hand(b, s):
    pairs = s * (s + 1) // 2
    attn = 4 * b * 16 * 128 * pairs * 28
    want = 2 * flops.matmul_params_per_token(QWEN) * b * s + attn
    assert flops.prefill_flops(QWEN, b, s) == want
    assert flops.train_flops(QWEN, b, s) == 3 * want


@pytest.mark.parametrize("b,s,bound", [(2, 4096, "flops"), (1, 64, "bytes")])
def test_flash_bound_by_hand(b, s, bound):
    f = 4.0 * b * 16 * 128 * (s * (s + 1) // 2)
    nbytes = 2 * b * s * 128 * (2 * 16 + 2 * 8)
    got = flops.flash_bound_s(QWEN, b, s)
    assert math.isclose(got, max(f / BF16_FLOPS, nbytes / HBM_BYTES_PER_S))
    by_flops = f / BF16_FLOPS >= nbytes / HBM_BYTES_PER_S
    assert by_flops == (bound == "flops")


def test_trace_reduction_by_hand():
    from bench_h100.trace import breakdown, reduce
    dev = [("k1", 0.0, 1.0), ("k2", 0.5, 2.0), ("flash_attention_x", 3.0, 4.0),
           ("k1", 6.0, 6.5)]
    spans = [("submit", 2.0, 2.9), ("wait", 1.5, 7.0)]
    s = reduce(dev, spans)
    assert s["busy_s"] == 2.0 + 1.0 + 0.5
    assert s["by_name"]["k1"] == 1.5
    assert sorted(s["gaps"], key=lambda g: g[1]) == [("submit", 1.0),
                                                     ("wait", 2.0)]
    bd = breakdown(s)
    assert bd["device_ops"][0] == ["k2", 1.5] or bd["device_ops"][0][1] == 1.5
    assert bd["idle_gaps"][0] == ["wait", 2.0]

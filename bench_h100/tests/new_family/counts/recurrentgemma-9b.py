"""recurrentgemma-9b's counts: the layers follow ``hybrid.pattern``
(``rec``: an RG-LRU block, ``attn``: local attention over ``window``
keys), each with a gated MLP; only the attention layers launch B6.

Model FLOPs: 2 per multiply-add of every weight a token passes through
(a recurrent block's ``w_x``, ``w_y`` d × W, gates ``w_a``, ``w_i`` W × W
and ``w_out`` W × d; an attention layer's projections; every MLP; the
tied LM head), plus local attention's QK and PV, 4·Dh per (query, key)
pair the causal window leaves, for every head."""
from bench_h100.flops import causal_pairs
from bench_h100.peaks import BF16_FLOPS, HBM_BYTES_PER_S


def kinds(run):
    """The block kind of each layer, the pattern repeated over n_layers."""
    pattern = run["hybrid"]["pattern"]
    return [pattern[i % len(pattern)] for i in range(run["n_layers"])]


def window_pairs(seq, window):
    """(query, key) pairs of a causal window of ``window`` keys."""
    w = min(seq, window)
    return causal_pairs(w) + (seq - w) * w


def _launch(run, batch, seq):
    """(FLOPs, bytes) of one attention layer's B6 launch."""
    h, hkv, hd = run["n_heads"], run["n_kv_heads"], run["head_dim"]
    flops = 4.0 * batch * h * hd * window_pairs(seq, run["hybrid"]["window"])
    return flops, 2 * batch * seq * hd * (2 * h + 2 * hkv)


def prefill_flops(run, batch, seq):
    d, h, hkv, hd = (run["d_model"], run["n_heads"], run["n_kv_heads"],
                     run["head_dim"])
    w = run["hybrid"].get("lru_width") or d
    attn = d * h * hd + 2 * d * hkv * hd + h * hd * d
    rec = 2 * d * w + 2 * w * w + w * d
    layers = kinds(run)
    weights = sum(attn if k == "attn" else rec for k in layers) + \
        len(layers) * 3 * d * run["d_ff"] + d * run["vocab_size"]
    n_attn = layers.count("attn")
    return 2.0 * weights * batch * seq + n_attn * _launch(run, batch, seq)[0]


def flash_bound_s(run, batch, seq):
    flops, nbytes = _launch(run, batch, seq)
    return kinds(run).count("attn") * max(flops / BF16_FLOPS,
                                          nbytes / HBM_BYTES_PER_S)

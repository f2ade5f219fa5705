"""granite-4.0-h-small's counts: the layers follow ``hybrid.pattern``
(``ssm``: a Mamba-2 SSD mixer, ``attn``: global causal attention), each
followed by top-k experts, their router and a shared expert; only the
attention layers launch B6.

Model FLOPs: 2 per multiply-add of every weight a token passes through
(an SSD mixer's ``in_proj`` d × (2·di + 2·g·N + H) and ``out_proj``
di × d; an attention layer's projections; the router d × E, ``top_k`` experts of
3·d·f and the shared expert's 3·d·f_s; the tied LM head d × V), plus
causal attention's QK and PV, 4·Dh per (query, key) pair for every head,
plus the SSD's products by chunks of Q = min(chunk, seq) steps: within a
chunk C_i·B_j (2·N a group) and the masked product with Δx (2·P a head)
for every causal pair of steps, across chunks each chunk's state
(Σ B ⊗ Δx, 2·N·P a head and step) and its read-out (C · S, the same).
Not counted: the one-hot dispatch and combine of the port's MoE layer,
which are no model work."""
from bench_h100.flops import causal_pairs, flash_bound_s as _one_launch
from bench_h100.spec import reference

#: the mixer of each layer, as the configuration's reference reads it
kinds = reference("granite-4.0-h-small").kinds


def _ssd(run):
    ssm = run["ssm"]
    di = ssm["expand"] * run["d_model"]
    n, p, g = ssm["state_dim"], ssm["head_dim"], ssm.get("n_groups", 1)
    return di, n, p, g, di // p


def weights_per_token(run):
    """Weights one token multiplies, the experts' top-k only."""
    d, moe = run["d_model"], run["moe"]
    h, hkv, hd = run["n_heads"], run["n_kv_heads"], run["head_dim"]
    di, n, p, g, nh = _ssd(run)
    mixer = {"attn": d * h * hd + 2 * d * hkv * hd + h * hd * d,
             "ssm": d * (2 * di + 2 * g * n + nh) + di * d}
    ffn = d * moe["n_experts"] + 3 * d * (
        moe["top_k"] * run["d_ff"] + moe.get("shared_d_ff", 0))
    return sum(mixer[k] + ffn for k in kinds(run)) + d * run["vocab_size"]


def ssd_flops(run, batch, seq):
    """One SSD layer's chunked products over ``batch`` sequences."""
    di, n, p, g, nh = _ssd(run)
    q = min(run["ssm"]["chunk"], seq)
    intra = (seq // q) * causal_pairs(q) * (2 * n * g + 2 * p * nh)
    inter = seq * 4 * n * p * nh
    return float(batch * (intra + inter))


def prefill_flops(run, batch, seq):
    layers = kinds(run)
    attn = 4.0 * batch * run["n_heads"] * run["head_dim"] * causal_pairs(seq)
    return (2.0 * weights_per_token(run) * batch * seq +
            layers.count("attn") * attn +
            layers.count("ssm") * ssd_flops(run, batch, seq))


def flash_bound_s(run, batch, seq):
    return kinds(run).count("attn") * _one_launch(run, batch, seq)

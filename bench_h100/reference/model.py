"""The plain reference: a decoder-only transformer (dense or top-k MoE
with GShard capacity) in plain PyTorch, computed in float32 with TF32 off,
one layer at a time and attention in blocks of queries.

It takes a configuration file's ``run`` sizes and the weights the
benchmark drew (bf16 leaves, upcast here layer by layer), and imports
nothing of the program. ``mode="fp8"`` is the control: every product's
two operands rounded to float8 e4m3 (one scale per tensor) before an
f32 product, the precision below the configuration's bf16.

The equations are those of the port's configurations, in the layout of
its weight tree (``x @ W``, weights ``[in, out]``, experts ``[E, in,
out]``): RMSNorm in f32 (eps from the configuration file), q/k RMSNorm
over the head dim where ``qk_norm``, RoPE by halves (NeoX) at positions
0..S-1 after it, causal GQA attention (query head i reads key head
i // (H / Hkv)), SwiGLU, residual adds, the final norm and the LM head
(the embedding's transpose where tied). The MoE layer routes by the
softmax of an f32 router, keeps the top k renormalised, and gives each
expert at most C = ⌈k·g/E·cf⌉ (token, choice) pairs of a group of
g = min(group_size, S) tokens of one sequence, earlier tokens first and a
token's choices in order; a dropped pair adds nothing.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

F8 = torch.float8_e4m3fn
F8_MAX = 448.0
#: query rows of one attention block
Q_BLOCK = 1024


def exact() -> None:
    """f32 products in f32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def q8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale for the tensor, in f32;
    the gradient passes straight through the rounding."""
    xd = x.detach()
    scale = xd.abs().amax().clamp_min(1e-12) / F8_MAX
    r = (xd / scale).to(F8).to(torch.float32) * scale
    return x + (r - xd) if x.requires_grad else r


class Arith:
    """The products of one precision: ``"f32"`` or ``"fp8"``."""

    def __init__(self, mode: str = "f32"):
        if mode not in ("f32", "fp8"):
            raise ValueError(mode)
        self.mode = mode

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        return q8(x) if self.mode == "fp8" else x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.cast(a) @ self.cast(b)


def f32(t: torch.Tensor) -> torch.Tensor:
    return t.detach().float() if t.dtype != torch.float32 else t


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B,S,H,D] rotated by halves at positions 0..S-1."""
    s, d = x.shape[1], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=x.device) / d))
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q, k, v, ar: Arith) -> torch.Tensor:
    """q [B,S,H,D], k/v [B,S,Hkv,D] → [B,S,H,D]: causal softmax attention
    in blocks of Q_BLOCK queries, each over the keys up to its last."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, h // hkv, d).permute(0, 2, 3, 1, 4)  # B,Hkv,G,S,D
    kt = k.permute(0, 2, 1, 3)                                    # B,Hkv,S,D
    vt = v.permute(0, 2, 1, 3)
    if ar.mode == "fp8":
        qg, kt, vt = ar.cast(qg), ar.cast(kt), ar.cast(vt)
    outs = []
    for lo in range(0, s, Q_BLOCK):
        hi = min(lo + Q_BLOCK, s)
        sc = torch.einsum("bkgqd,bksd->bkgqs", qg[:, :, :, lo:hi],
                          kt[:, :, :hi]) * (d ** -0.5)
        qpos = torch.arange(lo, hi, device=q.device)[:, None]
        kpos = torch.arange(hi, device=q.device)[None, :]
        sc = sc.masked_fill(kpos > qpos, float("-inf"))
        p = torch.softmax(sc, dim=-1)
        if ar.mode == "fp8":
            p = ar.cast(p)
        outs.append(torch.einsum("bkgqs,bksd->bkgqd", p, vt[:, :, :hi]))
    o = torch.cat(outs, dim=3)                                    # B,Hkv,G,S,D
    return o.permute(0, 3, 1, 2, 4).reshape(b, s, h, d)


def attention_block(p, run, x, eps, ar: Arith) -> torch.Tensor:
    b, s, _ = x.shape
    h, hkv = run["n_heads"], run["n_kv_heads"]
    hd = run.get("head_dim") or run["d_model"] // h
    q = ar.mm(x, f32(p["wq"])).reshape(b, s, h, hd)
    k = ar.mm(x, f32(p["wk"])).reshape(b, s, hkv, hd)
    v = ar.mm(x, f32(p["wv"])).reshape(b, s, hkv, hd)
    if run.get("qk_norm"):
        q = rmsnorm(q, f32(p["q_norm"]["scale"]), eps)
        k = rmsnorm(k, f32(p["k_norm"]["scale"]), eps)
    theta = float(run.get("rope_theta", 10000.0))
    q, k = rope(q, theta), rope(k, theta)
    o = causal_attention(q, k, v, ar).reshape(b, s, h * hd)
    return ar.mm(o, f32(p["wo"]))


def swiglu(x, w_gate, w_up, w_out, ar: Arith) -> torch.Tensor:
    return ar.mm(F.silu(ar.mm(x, w_gate)) * ar.mm(x, w_up), w_out)


def route(run, x: torch.Tensor, router: torch.Tensor, ar: Arith):
    """x [T,D] → (top-k experts [T,k], their renormalised weights [T,k])."""
    probs = torch.softmax(ar.mm(x, f32(router)), dim=-1)
    topv, topi = torch.topk(probs, run["moe"]["top_k"], dim=-1, sorted=True)
    return topi, topv / topv.sum(-1, keepdim=True)


def queue_rank(eids: torch.Tensor, n_experts: int) -> torch.Tensor:
    """For each (token, choice) of one group, flattened token-major, its
    rank among the pairs of the same expert before it."""
    n = eids.numel()
    order = torch.sort(eids * n + torch.arange(n, device=eids.device)).indices
    sorted_e = eids[order]
    counts = torch.bincount(eids, minlength=n_experts)
    starts = torch.cumsum(counts, 0) - counts
    rank_sorted = torch.arange(n, device=eids.device) - starts[sorted_e]
    rank = torch.empty_like(rank_sorted)
    rank[order] = rank_sorted
    return rank


def moe_block(p, run, x, ar: Arith) -> torch.Tensor:
    """x [B,S,D] → [B,S,D]."""
    moe = run["moe"]
    e, k = moe["n_experts"], moe["top_k"]
    b, s, d = x.shape
    g = min(moe["group_size"], s)
    cap = max(int(math.ceil(k * g / e * moe["capacity_factor"])), 1)
    flat = x.reshape(b * s, d)
    topi, w = route(run, flat, p["router"], ar)
    rank = torch.cat([queue_rank(topi[i:i + g].reshape(-1), e)
                      for i in range(0, b * s, g)]).reshape(b * s, k)
    keep = rank < cap
    y = torch.zeros_like(flat)
    for ex in range(e):
        sel = (topi == ex) & keep
        tok, ch = sel.nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        out = swiglu(flat[tok], f32(p["w_gate"][ex]), f32(p["w_up"][ex]),
                     f32(p["w_out"][ex]), ar)
        y.index_add_(0, tok, out * w[tok, ch][:, None])
    return y.reshape(b, s, d)


def layer(p, run, x, eps, ar: Arith) -> torch.Tensor:
    h = rmsnorm(x, f32(p["norm1"]["scale"]), eps)
    x = x + attention_block(p["attn"], run, h, eps, ar)
    h = rmsnorm(x, f32(p["norm2"]["scale"]), eps)
    if "moe" in p:
        return x + moe_block(p["moe"], run, h, ar)
    m = p["mlp"]
    return x + swiglu(h, f32(m["w_gate"]), f32(m["w_up"]), f32(m["w_out"]), ar)


def head_matrix(params, run) -> torch.Tensor:
    return params["embed"].T if run.get("tie_embeddings") else params["head"]


def logits_at(params, config: Dict[str, Any], tokens: torch.Tensor,
              rows: torch.Tensor, cols: torch.Tensor, mode: str = "f32"
              ) -> torch.Tensor:
    """The logits [n, V] f32 of ``tokens`` [B,S] at the positions
    ``(rows[i], cols[i])``."""
    run, eps = config["run"], float(config.get("norm_eps", 1e-6))
    ar = Arith(mode)
    with torch.no_grad():
        x = f32(params["embed"])[tokens]
        for p in params["layers"]:
            x = layer(p, run, x, eps, ar)
        h = rmsnorm(x[rows, cols], f32(params["final_norm"]["scale"]), eps)
        return ar.mm(h, f32(head_matrix(params, run)))


# ----------------------------------------------------------------------------
# training: three AdamW steps from the same weights and batches
# ----------------------------------------------------------------------------
def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, it) for v in tree]
    return next(it)


def loss_fn(params, config, tokens, labels, ar: Arith) -> torch.Tensor:
    """Mean next-token cross entropy in f32, each layer recomputed in the
    backward (``torch.utils.checkpoint``)."""
    from torch.utils.checkpoint import checkpoint
    run, eps = config["run"], float(config.get("norm_eps", 1e-6))
    if run.get("family") == "moe":
        raise NotImplementedError("the train reference is dense only")
    x = params["embed"][tokens]
    for p in params["layers"]:
        x = checkpoint(layer, p, run, x, eps, ar, use_reentrant=False)
    h = rmsnorm(x, params["final_norm"]["scale"], eps)
    logits = ar.mm(h, head_matrix(params, run))
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1))


def train_steps(params0, config, batches: List[Tuple[torch.Tensor, torch.Tensor]],
                ocfg: Dict[str, float], mode: str = "f32"
                ) -> Dict[str, Any]:
    """AdamW steps from the bf16 weights ``params0`` over ``batches``, in
    f32 products, the parameters stored back in their own dtype after each
    update as the configuration states. → ``{"loss": [per step],
    "grad_norm": [leaf norms of step 1's clipped gradient], "delta_norm":
    [leaf norms of the change after the last step], "paths": [leaf
    paths]}``."""
    ar = Arith(mode)
    leaves = list(_leaves(params0))
    paths = [p for p, _ in leaves]
    dtypes = [t.dtype for _, t in leaves]
    cur = [t.detach().float().clone() for _, t in leaves]
    m = [torch.zeros_like(t) for t in cur]
    v = [torch.zeros_like(t) for t in cur]
    b1, b2, eps = ocfg["b1"], ocfg["b2"], ocfg["eps"]
    losses, grad_norms = [], None
    for step, (tok, lab) in enumerate(batches, start=1):
        ps = [t.requires_grad_() for t in cur]
        tree = _rebuild(params0, iter(ps))
        with torch.enable_grad():
            loss = loss_fn(tree, config, tok, lab, ar)
            grads = torch.autograd.grad(loss, ps)
        losses.append(float(loss))
        cur = [t.detach() for t in ps]
        gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        scale = torch.clamp(ocfg["clip_norm"] / (gnorm + 1e-9), max=1.0)
        grads = [g * scale for g in grads]
        if step == 1:
            grad_norms = [float(torch.linalg.vector_norm(g)) for g in grads]
        bc1, bc2 = 1.0 - b1 ** step, 1.0 - b2 ** step
        with torch.no_grad():
            for i, g in enumerate(grads):
                m[i] = m[i] * b1 + g * (1 - b1)
                v[i] = v[i] * b2 + g * g * (1 - b2)
                upd = (m[i] / bc1) / (torch.sqrt(v[i] / bc2) + eps) + \
                    ocfg["weight_decay"] * cur[i]
                cur[i] = (cur[i] - ocfg["lr"] * upd).to(dtypes[i]).float()
        del grads
    delta = [float(torch.linalg.vector_norm(c - t.detach().float()))
             for c, (_, t) in zip(cur, leaves)]
    return {"loss": losses, "grad_norm": grad_norms, "delta_norm": delta,
            "paths": paths}

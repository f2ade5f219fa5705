"""Serving launcher: a thin CLI over :class:`repro_torch.serve.ServeEngine`
— the port of the JAX package's ``repro/launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --full --requests 32 --batch 8 --steps 64

Each request decodes ``--steps`` greedy tokens against its own
device-resident cache; the engine batches requests (gang-scheduled — the
model cache carries a batch-uniform decode position, so mid-batch joins
are disabled) and reports per-request p50/p95/p99 latency, the time to
first token, and the DeviceRef traffic counters. ``--sync`` runs the
static-batch loop instead of the engine; an encdec arch (whisper-tiny)
always takes it, with random frames from numpy seed 0, as in the JAX
launcher. ``--paged`` serves through a
:class:`~repro_torch.serve.PagePool` with disaggregated prefill and
decode: a one-layer greedy attention decoder at the config's widths
whose KV entries live in pages.

It binds ``cuda:0`` (the current CUDA device) unless ``--device cpu``
(or another device) is given; without a card it raises ``LookupError``.
The weights are random, from seed 0.
"""
from __future__ import annotations

import argparse
import math
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["main", "check_cache_capacity", "cache_batch_axes",
           "engine_fns", "run_engine", "sync_frames", "run_sync",
           "paged_weights", "paged_model",
           "paged_prompts",
           "run_paged", "contiguous_tokens"]


def check_cache_capacity(steps: int, capacity: int) -> int:
    """Guard the decode length against the allocated cache.

    A decode of ``steps`` tokens occupies ``steps + 1`` cache slots (the
    prompt token plus one per generated token); a longer decode would
    silently overwrite live KV entries (the write position clamps to the
    last slot) instead of failing loudly. Returns ``capacity`` so call
    sites can chain it.
    """
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")
    if steps + 1 > capacity:
        raise ValueError(
            f"decode of {steps} steps needs {steps + 1} cache slots but "
            f"only {capacity} were allocated; raise the cache capacity or "
            "shorten the decode")
    return capacity


def cache_batch_axes(model, capacity: int) -> List[Optional[int]]:
    """Per-leaf batch axis of the model's cache, found by diffing ``meta``
    caches for batch sizes 1 and 2 (stacked leaves carry the layer count
    on axis 0 and batch on axis 1). A leaf with no batch axis — the
    scalar decode position — is batch-uniform and shared, which gang
    scheduling keeps aligned."""
    import torch.utils._pytree as pytree
    s1 = pytree.tree_leaves(model.init_cache(1, capacity, device="meta"))
    s2 = pytree.tree_leaves(model.init_cache(2, capacity, device="meta"))
    return [next((ax for ax, (a, b) in enumerate(zip(x.shape, y.shape))
                  if a != b), None) for x, y in zip(s1, s2)]


def engine_fns(model, params, capacity: int
               ) -> Tuple[Callable, Callable, Callable]:
    """``(step_fn, combine, split)`` of a decode worker over ``model``'s
    caches of ``capacity`` slots: the greedy serve step on a batch of
    tokens, and the pair that concatenates per-request cache leaves along
    their batch axis (:func:`cache_batch_axes`) and takes request ``b``'s
    slice back out; a leaf with no batch axis is shared."""
    from ..dist.step import build_serve_step

    serve_step = build_serve_step(model)
    batch_axes = cache_batch_axes(model, capacity)

    def step_fn(cache, tokens):
        nxt, _, cache = serve_step(params, cache, tokens[:, None])
        return nxt[:, 0], cache

    def combine(leaves, i):
        ax = batch_axes[i]
        return leaves[0] if ax is None else torch.cat(leaves, dim=ax)

    def split(leaf, b, i):
        ax = batch_axes[i]
        return leaf if ax is None else leaf.narrow(ax, b, 1)

    return step_fn, combine, split


def run_engine(model, params, *, requests: int, batch: int, steps: int,
               workers: int, prompts: Optional[Sequence[int]] = None,
               timeout: float = 600.0) -> Dict:
    """Serve ``requests`` greedy decodes of ``steps`` tokens through a
    :class:`~repro_torch.serve.ServeEngine` with ``workers`` decode
    replicas and batches of up to ``batch``. ``prompts`` are the requests'
    first tokens (all 0 by default, as in the JAX launcher). Returns the
    per-request results, the engine's stats, the wall time in seconds and
    the registry's counters before and after."""
    from ..core import ActorSystem, memory_stats
    from ..serve import ServeEngine

    capacity = check_cache_capacity(steps, steps + 1)
    prompts = [0] * requests if prompts is None else list(prompts)
    step_fn, combine, split = engine_fns(model, params, capacity)

    def init_fn(prompt):
        return model.init_cache(1, capacity), int(prompt)

    with ActorSystem(name="serve", device=model.device) as system:
        engine = ServeEngine(system, step_fn, init_fn,
                             n_workers=workers, max_batch=batch,
                             allow_join=False, combine=combine, split=split)
        before = memory_stats()
        t0 = time.perf_counter()
        with engine:
            futs = [engine.submit(p, max_new_tokens=steps) for p in prompts]
            results = [f.result(timeout=timeout) for f in futs]
        wall = time.perf_counter() - t0
        return {"results": results, "stats": engine.stats(), "wall_s": wall,
                "memref_before": before, "memref_after": memory_stats()}


def sync_frames(cfg, batch: int) -> np.ndarray:
    """The encdec sync loop's frames ``[batch, n_frames, d_model]``:
    standard normal from numpy seed 0, as the JAX launcher draws them, f32
    (the model casts them to its compute dtype)."""
    rng = np.random.default_rng(0)
    return rng.standard_normal(
        (batch, cfg.encdec.n_frames, cfg.d_model)).astype(np.float32)


def run_sync(model, params, *, batch: int, steps: int,
             prompts: Optional[Sequence[int]] = None) -> Dict:
    """The static-batch loop: ``batch`` sequences decode ``steps`` tokens
    together from one cache (for encdec, the encoder's prefill of
    :func:`sync_frames`). ``prompts`` are their first tokens (all 0 by
    default). Returns the tokens ``[batch, steps]`` and the wall time."""
    from ..dist.step import build_serve_step

    capacity = check_cache_capacity(steps, steps + 1)
    serve_step = build_serve_step(model)
    if model.cfg.family == "encdec":
        cache = model.init_cache(batch, capacity, params=params,
                                 frames=sync_frames(model.cfg, batch))
    else:
        cache = model.init_cache(batch, capacity)
    first = [0] * batch if prompts is None else list(prompts)
    toks = torch.tensor(first, dtype=torch.int32,
                        device=model.device)[:, None]
    outs = []
    t0 = time.perf_counter()
    for _ in range(steps):
        toks, _, cache = serve_step(params, cache, toks)
        outs.append(toks.cpu().numpy())
    wall = time.perf_counter() - t0
    tokens = (np.concatenate(outs, axis=1) if outs
              else np.zeros((batch, 0), np.int32))
    return {"tokens": tokens, "wall_s": wall}


# ----------------------------------------------------------------------------
# paged mode: a one-layer greedy attention decoder at the config's widths
# ----------------------------------------------------------------------------
def paged_weights(cfg, device, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Random f32 weights of the paged demo's decoder, from a seeded
    ``torch.Generator`` on ``device``: a token embedding ``[vocab, d]``
    and the q/k/v/o projections ``[d, d]``, each N(0, 1/d)."""
    d = int(cfg.d_model)
    vocab = int(cfg.vocab_size)
    gen = torch.Generator(device=device).manual_seed(seed)
    scale = 1.0 / math.sqrt(d)
    w = {"emb": torch.randn((vocab, d), generator=gen, device=device) * scale}
    for name in ("wq", "wk", "wv", "wo"):
        w[name] = torch.randn((d, d), generator=gen, device=device) * scale
    return w


def paged_model(weights: Dict[str, torch.Tensor]):
    """``(prefill_fn, step_fn)`` of the paged demo's decoder over
    ``weights`` (as :func:`paged_weights` makes them): token embedding,
    one attention layer, logits against the embedding, greedy argmax.
    ``prefill_fn(prompt) → ({"k", "v"} [T, d], first_token)``;
    ``step_fn(kv, lengths, tokens) → (next_tokens, {"k", "v"} [B, d])``,
    the paged decode contract. Both are pure."""
    emb, wq, wk, wv, wo = (weights[n] for n in ("emb", "wq", "wk", "wv",
                                                "wo"))
    vocab, d = emb.shape
    device = emb.device

    def attend(q, k, v, lengths):
        # q [B, d]; k/v [B, T, d]; positions >= length are masked out
        t = k.shape[1]
        scores = torch.einsum("bd,btd->bt", q, k) / math.sqrt(d)
        mask = torch.arange(t, device=device)[None, :] < lengths[:, None]
        scores = scores.masked_fill(~mask, float("-inf"))
        att = torch.softmax(scores, dim=-1)
        return torch.einsum("bt,btd->bd", att, v)

    def prefill_fn(prompt):
        toks = torch.as_tensor(np.asarray(prompt, dtype=np.int64) % vocab,
                               device=device)
        with torch.no_grad():
            x = emb[toks]                       # [T, d]
            entries = {"k": x @ wk, "v": x @ wv}
            q = (x[-1] @ wq)[None, :]
            o = attend(q, entries["k"][None], entries["v"][None],
                       torch.tensor([toks.shape[0]], device=device))
            logits = (o @ wo) @ emb.T
        return entries, int(torch.argmax(logits, dim=-1)[0])

    def step_fn(kv, lengths, tokens):
        x = emb[tokens.long() % vocab]          # [B, d]
        entry = {"k": x @ wk, "v": x @ wv}
        # the incoming token's KV joins the context it attends over
        rows = (torch.arange(x.shape[0], device=device), lengths.long())
        k = kv["k"].index_put(rows, entry["k"])
        v = kv["v"].index_put(rows, entry["v"])
        o = attend(x @ wq, k, v, lengths + 1)
        logits = (o @ wo) @ emb.T
        return torch.argmax(logits, dim=-1).to(torch.int32), entry

    return prefill_fn, step_fn


def paged_prompts(vocab: int, requests: int) -> List[List[int]]:
    """The paged demo's mixed workload, as in the JAX launcher: four base
    prompts of 24, 6, 48 and 12 tokens from numpy seed 0, every third
    request replaying prompt 0 so the prefix cache gets exercised."""
    rng = np.random.default_rng(0)
    base = [rng.integers(0, vocab, size=n).tolist() for n in (24, 6, 48, 12)]
    return [base[0] if i % 3 == 0 else base[i % len(base)]
            for i in range(requests)]


def contiguous_tokens(prefill_fn: Callable, step_fn: Callable, prompt,
                      steps: int) -> List[int]:
    """One request decoded by the paged step function over a contiguous
    cache of ``len(prompt) + steps`` slots, with no pool — the reference
    the paged engine's tokens are held against."""
    entries, first = prefill_fn(prompt)
    n = int(entries["k"].shape[0])
    kv = {}
    for name, leaf in entries.items():
        kv[name] = torch.zeros((1, n + steps) + tuple(leaf.shape[1:]),
                               dtype=leaf.dtype, device=leaf.device)
        kv[name][0, :n] = leaf
    out, last = [], first
    with torch.no_grad():
        for s in range(steps):
            lengths = torch.tensor([n + s], dtype=torch.int32,
                                   device=kv["k"].device)
            nxt, entry = step_fn(kv, lengths, torch.tensor(
                [last], dtype=torch.int32, device=kv["k"].device))
            kv = {name: t.index_put((torch.zeros(1, dtype=torch.long,
                                                 device=t.device),
                                     lengths.long()), entry[name])
                  for name, t in kv.items()}
            last = int(nxt[0])
            out.append(last)
    return out


def run_paged(cfg, device, *, requests: int, batch: int, steps: int,
              workers: int, prefill_workers: int, pages: int,
              weights: Optional[Dict[str, torch.Tensor]] = None,
              timeout: float = 600.0) -> Dict:
    """Serve :func:`paged_prompts` through a paged engine over a
    ``pages``-page :class:`~repro_torch.serve.PagePool` of 16-token pages
    on ``device``. Returns the results, the engine's stats, the pool, the
    device manager's page pressure, the wall time, the registry's
    counters before and after, and the prompts and weights used."""
    from ..core import ActorSystem, memory_stats
    from ..serve import PagePool, ServeEngine

    weights = paged_weights(cfg, device) if weights is None else weights
    prefill_fn, step_fn = paged_model(weights)
    prompts = paged_prompts(int(cfg.vocab_size), requests)
    with ActorSystem(name="serve-paged", device=device) as system:
        manager = system.opencl_manager()
        pool = PagePool.for_entries(prefill_fn(prompts[0])[0],
                                    page_tokens=16, max_pages=pages)
        engine = ServeEngine(system, step_fn=step_fn, cache_pool=pool,
                             prefill_fn=prefill_fn,
                             prefill_workers=prefill_workers,
                             n_workers=workers, max_batch=batch)
        before = memory_stats()
        t0 = time.perf_counter()
        with engine:
            futs = [engine.submit(p, max_new_tokens=steps) for p in prompts]
            results = [f.result(timeout=timeout) for f in futs]
        wall = time.perf_counter() - t0
        return {"results": results, "stats": engine.stats(), "pool": pool,
                "pressure": manager.memory_stats(), "wall_s": wall,
                "memref_before": before, "memref_after": memory_stats(),
                "prompts": prompts, "weights": weights}


# ----------------------------------------------------------------------------
def _memref(stats: Dict) -> Dict:
    return {k: v for k, v in stats.items()
            if k in ("transfers", "readbacks", "live_refs")}


def _report(name: str, run: Dict, args, extra: str = "") -> None:
    stats, results, wall = run["stats"], run["results"], run["wall_s"]
    lat, ttft = stats["latency"], stats["ttft"]
    toks = sum(len(r.tokens) for r in results)
    print(f"{name}: {args.requests} requests × {args.steps} steps "
          f"(batch {args.batch}, {args.workers} workers{extra}) in "
          f"{wall:.2f}s ({toks / wall:,.0f} tok/s)")
    print(f"latency p50={lat['p50_ms']:.1f}ms p95={lat['p95_ms']:.1f}ms "
          f"p99={lat['p99_ms']:.1f}ms ttft p50={ttft['p50_ms']:.1f}ms | "
          f"engine steps={stats['steps']} requeues={stats['requeues']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=32,
                    help="engine mode: how many requests to serve")
    ap.add_argument("--batch", type=int, default=8,
                    help="max batch size (sync mode: the static batch)")
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--workers", type=int, default=2,
                    help="engine mode: decode worker replicas")
    ap.add_argument("--sync", action="store_true",
                    help="static-batch loop instead of the engine")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV-cache demo: disaggregated prefill/decode "
                         "over a PagePool (single-layer attention at the "
                         "config's dims)")
    ap.add_argument("--prefill-workers", type=int, default=2,
                    help="paged mode: prefill worker replicas")
    ap.add_argument("--pages", type=int, default=512,
                    help="paged mode: PagePool capacity in pages")
    ap.add_argument("--full", action="store_true",
                    help="the published config (default: the smoke config)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device; "
                         "'cpu' runs on the CPU)")
    args = ap.parse_args(argv)

    from .. import configs
    from ..core import memory_stats
    from ..core.memref import default_device
    from ..models import Model

    device = default_device() if args.device is None \
        else torch.device(args.device)
    cfg = (configs.get_config if args.full else configs.get_smoke_config)(
        args.arch)
    if args.paged:
        run = run_paged(cfg, device, requests=args.requests, batch=args.batch,
                        steps=args.steps, workers=args.workers,
                        prefill_workers=args.prefill_workers,
                        pages=args.pages)
        stats = run["stats"]
        _report(f"{cfg.name} [paged]", run, args,
                f", {args.prefill_workers} prefill workers")
        print(f"occupancy={stats['occupancy']:.2f} "
              f"prefills={stats['prefills']} "
              f"prefix_hits={stats['prefix_hits']}")
        ps = stats["pool"]
        print(f"pool: {ps['pages_live']}/{ps['pages_total']} pages live "
              f"(peak {ps['peak_pages']}), shared={ps['pages_shared']}, "
              f"cow={ps['cow']}, fragmentation={ps['fragmentation']:.2f}")
        for name, dev in run["pressure"].items():
            print(f"device {name}: pages_total={dev['pages_total']} "
                  f"pages_free={dev['pages_free']} "
                  f"pages_shared={dev['pages_shared']} "
                  f"fragmentation={dev['fragmentation']:.2f}")
        print("memref:", _memref(memory_stats()))
        print("sample:", run["results"][0].tokens[:16])
        return 0
    model = Model(cfg, device=device)
    params = model.init(0)
    if args.sync or cfg.family == "encdec":
        run = run_sync(model, params, batch=args.batch, steps=args.steps)
        n = args.steps * args.batch
        print(f"{cfg.name}: {args.steps} steps × {args.batch} requests "
              f"in {run['wall_s']:.2f}s ({n / run['wall_s']:,.0f} tok/s)")
        print("sample:", run["tokens"][0, :16].tolist())
        return 0
    run = run_engine(model, params, requests=args.requests, batch=args.batch,
                     steps=args.steps, workers=args.workers)
    _report(cfg.name, run, args)
    print("memref:", _memref(memory_stats()))
    print("sample:", run["results"][0].tokens[:16])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Training launcher — the port of the JAX package's
``repro/launch/train.py``: any arch's smoke config (or, with ``--full``,
its published config) trained on synthetic data with AdamW,
a warmup-cosine schedule and optional checkpoints.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --full --steps 12 --batch 8 --seq 512 [--ckpt DIR]

It binds ``cuda:0`` (the current CUDA device) unless ``--device cpu`` (or
another device) is given; without a card it raises ``LookupError``. The
weights are random, from seed 0. :func:`run` returns each step's metrics;
:func:`main` prints every ``--log-every``-th of them.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, Optional

import torch

__all__ = ["parse_args", "run", "main"]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--full", action="store_true",
                    help="the published config (default: the smoke config)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device; "
                         "'cpu' runs on the CPU)")
    return ap.parse_args(argv)


def run(args: argparse.Namespace,
        log: Optional[Callable[[str], None]] = None) -> List[Dict[str, float]]:
    """Train as ``args`` say → one dict a step run: ``step`` (1-based),
    ``loss``, ``ce``, ``aux``, ``grad_norm`` and ``wall_s``, the host wall
    of the step up to its metrics on the host. ``log`` gets the restore
    line and every ``log_every``-th step's line."""
    from .. import configs
    from ..checkpoint import checkpoint as ckpt
    from ..core.memref import default_device
    from ..data import Prefetcher, SyntheticLM
    from ..dist import step as step_mod
    from ..models import Model
    from ..optim import AdamWConfig, schedule

    log = log or (lambda line: None)
    device = default_device() if args.device is None \
        else torch.device(args.device)
    cfg = (configs.get_config if args.full else configs.get_smoke_config)(
        args.arch)
    model = Model(cfg, device=device)
    ocfg = AdamWConfig(lr=args.lr)
    data = SyntheticLM(cfg, batch=args.batch, seq=args.seq, seed=0)
    sched = schedule.warmup_cosine(max(args.steps // 10, 1), args.steps)
    train_step = step_mod.build_train_step(
        model, ocfg, grad_accum=args.grad_accum, lr_schedule=sched)

    start_step = 0
    state = step_mod.init_train_state(model, 0, ocfg)
    if args.ckpt and ckpt.latest_step(args.ckpt) is not None:
        state, manifest = ckpt.restore(args.ckpt, target=state)
        start_step = manifest["step"]
        log(f"restored step {start_step} from {args.ckpt}")

    out: List[Dict[str, float]] = []
    pf = Prefetcher(data, depth=2, start_step=start_step)
    t0 = time.perf_counter()
    try:
        for i in range(start_step, args.steps):
            step_idx, batch = pf.next()
            if step_idx != i:
                raise RuntimeError(f"prefetcher gave step {step_idx}, not {i}")
            ts = time.perf_counter()
            state, metrics = train_step(state, batch)
            row = {k: float(v) for k, v in metrics.items()}
            row.update(step=i + 1, wall_s=time.perf_counter() - ts)
            out.append(row)
            if (i + 1) % args.log_every == 0:
                tok_s = ((i + 1 - start_step) * args.batch * args.seq /
                         (time.perf_counter() - t0))
                log(f"step {i + 1:5d} loss={row['loss']:.4f} "
                    f"gnorm={row['grad_norm']:.3f} tok/s={tok_s:,.0f}")
            if args.ckpt and (i + 1) % args.ckpt_every == 0:
                ckpt.save(args.ckpt, i + 1, state)
    finally:
        pf.close()
    if args.ckpt:
        ckpt.save(args.ckpt, args.steps, state)
    return out


def main(argv=None) -> int:
    run(parse_args(argv), log=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

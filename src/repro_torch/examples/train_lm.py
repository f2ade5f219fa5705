"""End-to-end training, on the port: train a small LM with the
full substrate — deterministic data pipeline, AdamW + warmup-cosine,
checkpointing, and actor-supervised recovery (a fault is injected
mid-run and training resumes from the last checkpoint, bit-exactly).

Defaults are the smoke config; pass ``--arch`` and ``--steps`` to scale
up (e.g. ``--d-model 768 --layers 12`` ≈ a 100M-class model):

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 100
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch import configs
from repro_torch.configs.base import ModelConfig
from repro_torch.core import ActorSystem
from repro_torch.data import SyntheticLM
from repro_torch.dist import fault
from repro_torch.dist import step as step_mod
from repro_torch.models import Model
from repro_torch.optim import AdamWConfig, schedule

CKPT_EVERY = 10


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3-8b",
                    choices=configs.list_archs())
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--d-model", type=int, default=None)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a worker fault at this step (demo)")
    return ap.parse_args(argv)


def smoke_config(arch: str, d_model: Optional[int] = None,
                 layers: Optional[int] = None) -> ModelConfig:
    """``arch``'s smoke config, widened to ``d_model`` and cut or grown to
    ``layers`` where given."""
    cfg = configs.get_smoke_config(arch)
    repl: Dict[str, Any] = {}
    if d_model:
        repl.update(d_model=d_model, head_dim=d_model // max(cfg.n_heads, 1),
                    d_ff=d_model * 3)
    if layers:
        repl.update(n_layers=layers)
    return dataclasses.replace(cfg, **repl) if repl else cfg


def run(cfg: ModelConfig, *, steps: int = 60, batch: int = 8, seq: int = 64,
        fail_at: Optional[int] = None, state=None, device=None
        ) -> Dict[str, Any]:
    """Train ``cfg`` for ``steps`` steps under a ``RecoverableTrainer`` that
    checkpoints every CKPT_EVERY steps, on ``device`` (``cuda:0`` by
    default), a fault injected at ``fail_at``
    (``steps // 2`` by default), from ``state`` (``init_train_state`` at
    seed 0 by default). Raises if the loss at batch 0 does not decrease or
    the fault is not recovered once. Returns each executed step's loss in
    order (the replayed ones too), the loss at batch 0 before and after,
    the recoveries, the final step and the wall seconds and tok/s."""
    losses: List[float] = []
    with ActorSystem(device=device) as system:
        dev = system.opencl_manager().find_device().torch_device
        model = Model(cfg, device=dev)
        ocfg = AdamWConfig(lr=3e-3, weight_decay=0.01)
        data = SyntheticLM(cfg, batch=batch, seq=seq, seed=0, noise=0.02)
        sched = schedule.warmup_cosine(steps // 10 + 1, steps)
        train_step = step_mod.build_train_step(model, ocfg, lr_schedule=sched)

        def logged_step(st, b):
            st, metrics = train_step(st, b)
            losses.append(float(metrics["loss"]))
            return st, metrics

        if state is None:
            state = step_mod.init_train_state(model, 0, ocfg)
        fail_at = steps // 2 if fail_at is None else fail_at
        with tempfile.TemporaryDirectory() as ckpt_dir:
            trainer = fault.RecoverableTrainer(system, logged_step, state,
                                               data, ckpt_dir,
                                               ckpt_every=CKPT_EVERY)
            t0 = time.perf_counter()
            final = trainer.run(steps, fail_at=fail_at)
            seconds = time.perf_counter() - t0
        first = {k: torch.as_tensor(v, device=dev)
                 for k, v in data.batch_at(0).items()}
        with torch.no_grad():
            loss0 = float(model.loss(state["params"], first)[0])
            loss_n = float(model.loss(final["params"], first)[0])
    want = 1 if 0 <= fail_at < steps else 0
    assert trainer.recoveries == want, \
        f"{trainer.recoveries} recoveries, not {want}"
    assert loss_n < loss0, "training failed to reduce loss"
    return {"steps": int(final["step"]), "recoveries": trainer.recoveries,
            "fail_at": fail_at, "losses": losses, "loss0": loss0,
            "loss_n": loss_n, "seconds": seconds,
            "tok_s": steps * batch * seq / seconds}


def main(argv=None) -> None:
    args = parse_args(argv)
    cfg = smoke_config(args.arch, args.d_model, args.layers)
    print(f"training {cfg.name}: {cfg.n_layers}L d={cfg.d_model} "
          f"~{cfg.param_count() / 1e6:.1f}M params")
    r = run(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
            fail_at=args.fail_at)
    print(f"steps={r['steps']} recoveries={r['recoveries']} "
          f"(fault injected at step {r['fail_at']})")
    print(f"loss: {r['loss0']:.3f} → {r['loss_n']:.3f}  "
          f"({r['tok_s']:,.0f} tok/s wall)")
    print("OK: loss decreased; recovery transparent")


if __name__ == "__main__":
    main()

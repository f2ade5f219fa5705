"""Faults planted underneath the timed path, to show that the output
check catches them (``tests/test_bench_h100_faults.py`` on the CPU,
``calibrate.py`` on the card). Each is a context manager that patches the
program in this process and restores it.

* ``unchanged``: a step returns its state unchanged (prefill: the layers
  hand their input on as it came; training: the update is skipped).
* ``half_batch``: half of the batch left out, the rest standing for it
  (prefill: the first half's rows computed and copied over the second
  half; training: the loss and gradients taken over the first half).
* ``altered``: an answer altered where it is produced (prefill: token 0
  made the top of every row's logits; training: the update of the first
  parameter leaf applied twice).
"""
from __future__ import annotations

import contextlib

import torch

FAULTS = ("unchanged", "half_batch", "altered")


@contextlib.contextmanager
def _patched(module, name, make):
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def prefill_fault(name: str):
    from repro_torch.dist import pipeline
    if name == "unchanged":
        return _patched(pipeline, "apply_layers",
                        lambda orig: lambda layers, cfg, x, *a, **k:
                        (x, torch.zeros((), device=x.device)))

    if name == "half_batch":
        def make(orig):
            def half(layers, cfg, x, positions, *a, **k):
                n = (x.shape[0] + 1) // 2
                y, aux = orig(layers, cfg, x[:n], positions[:n], *a, **k)
                idx = torch.arange(x.shape[0], device=x.device) % n
                return y[idx], aux
            return half
        return _patched(pipeline, "apply_layers", make)

    if name == "altered":
        def make(orig):
            def stage_fn(*a, **k):
                fn = orig(*a, **k)

                def altered(x):
                    out = fn(x)
                    if isinstance(out, torch.Tensor):
                        out = out.clone()
                        out[..., 0] = out.amax(-1) + 1
                    return out
                return altered
            return stage_fn
        return _patched(pipeline, "_stage_fn", make)
    raise ValueError(name)


def train_fault(name: str):
    from repro_torch.dist import step
    from repro_torch.optim import adamw
    if name == "unchanged":
        return _patched(adamw, "update",
                        lambda orig: lambda grads, state, params, *a, **k:
                        (params, state, {"grad_norm": torch.zeros(())}))
    if name == "half_batch":
        def make(orig):
            def half(model, params, batch, **k):
                n = (next(iter(batch.values())).shape[0] + 1) // 2
                return orig(model, params, {key: v[:n] for key, v in
                                            batch.items()}, **k)
            return half
        return _patched(step, "loss_and_grads", make)
    if name == "altered":
        import torch.utils._pytree as pytree

        def make(orig):
            def update(grads, state, params, *a, **k):
                new_p, new_s, m = orig(grads, state, params, *a, **k)
                leaves, spec = pytree.tree_flatten(new_p)
                old = pytree.tree_leaves(params)
                leaves[0] = (old[0].float() + 2 * (leaves[0].float() -
                                                   old[0].float())
                             ).to(leaves[0].dtype)
                return pytree.tree_unflatten(leaves, spec), new_s, m
            return update
        return _patched(adamw, "update", make)
    raise ValueError(name)


def fault(kind: str, name: str):
    return prefill_fault(name) if kind == "prefill" else train_fault(name)

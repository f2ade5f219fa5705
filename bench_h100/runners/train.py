"""The train cell: the step ``repro_torch.dist.step.build_train_step(model,
AdamWConfig())`` returns, on the pytree ``init_train_state`` builds
(``{"params", "opt": adamw.init(...), "step"}``) with the benchmark's
weights, ``Model(cfg)`` and the program's defaults (bf16 parameters, f32
AdamW state, remat "full"). Each step is synchronised by reading its loss
on the host.

Set-up drives the same state through the first ``CHECKED_STEPS`` steps of
the window's own call and feed (new rows each), keeping what the
reference follows: each loss, the leaf norms of the first clipped
gradient (from AdamW's ``m`` after one step, m / (1 - b1)) and of the
change of the parameters after the checked steps. The window then runs
on from that state.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import torch

from .. import weights as weights_mod
from ..trace import DeviceTrace, span
from .common import now, sync

#: the steps of set-up that the reference follows
CHECKED_STEPS = 3


def _norms(leaves) -> List[float]:
    return [float(torch.linalg.vector_norm(t.float())) for t in leaves]


class Train:
    def __init__(self, cell, cfg, params, seed: int, device, seconds: float):
        import torch.utils._pytree as pytree
        from repro_torch.dist.step import build_train_step
        from repro_torch.models import Model
        from repro_torch.optim import AdamWConfig, adamw
        self.cell, self.cfg, self.seed = cell, cfg, seed
        self.device = torch.device(device)
        self.seconds = seconds
        mix = cell.traffic
        self.b, self.s = int(mix["batch"]), int(mix["seq"])
        self.checked = CHECKED_STEPS
        self.ocfg = AdamWConfig()
        self.model = Model(cfg, device=self.device)
        self.params0 = params
        self.state = {"params": params, "opt": adamw.init(params, self.ocfg),
                      "step": torch.zeros((), dtype=torch.int32,
                                          device=self.device)}
        self.step_fn = build_train_step(self.model, self.ocfg)
        self.batches = []
        self._next = 0
        p0 = pytree.tree_leaves(params)
        self.losses: List[float] = []
        for i in range(self.checked):
            self.losses.append(self._step())
            if i == 0:
                self.grad_norms = [n / (1 - self.ocfg.b1) for n in _norms(
                    pytree.tree_leaves(self.state["opt"]["m"]))]
        self.delta_norms = _norms(a.float() - b.float() for a, b in zip(
            pytree.tree_leaves(self.state["params"]), p0))
        sync(self.device)

    def batch(self, i: int):
        seq = weights_mod.tokens(self.seed, i, self.b, self.s + 1,
                                 self.cfg.vocab_size, self.device)
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}

    def _step(self) -> float:
        i = self._next
        self._next += 1
        batch = self.batch(i)
        if i < self.checked:
            self.batches.append((batch["tokens"], batch["labels"]))
        with span("step"):
            self.state, metrics = self.step_fn(self.state, batch)
            return float(metrics["loss"])

    def window(self) -> Dict[str, Any]:
        t0 = now()
        steps, t = 0, t0
        while t - t0 < self.seconds:
            loss = self._step()
            if loss != loss:
                raise FloatingPointError(f"step {self._next}: loss {loss}")
            steps += 1
            t = now()
        self.window_steps = steps
        return {"train_tokens_per_s": steps * self.b * self.s / (t - t0),
                "window_s": t - t0, "steps": steps}

    def traced(self) -> Dict[str, Any]:
        n = int(self.cell.traffic["traced_steps"])
        sync(self.device)
        with DeviceTrace(self.device) as tr:
            t0 = now()
            for _ in range(n):
                self._step()
            t1 = now()
        return {"summary": tr.summary(), "window_s": t1 - t0, "steps": n}

    def outputs(self) -> Dict[str, Any]:
        return {"loss": self.losses, "grad_norm": self.grad_norms,
                "delta_norm": self.delta_norms}

    def ocfg_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self.ocfg)

    def free(self) -> None:
        del self.state, self.step_fn, self.model

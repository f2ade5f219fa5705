"""Fault tolerance on the actor substrate (paper §2.1 applied at scale) —
the port of the JAX package's ``repro/dist/fault.py``.

* :class:`RecoverableTrainer` — the training loop runs inside a worker
  actor; a supervisor monitors it (``DownMessage``), and on failure the
  trainer restores the latest published checkpoint and respawns the
  worker. Because the data pipeline is stateless-deterministic
  (``batch_at(step)``), the train step is pure and the checkpoint
  roundtrip is lossless, recovery is **bit-exact** wherever the step is
  deterministic: a faulted run converges to the identical parameters as
  an unfaulted one. On a CUDA card that needs
  ``torch.use_deterministic_algorithms(True)`` (the embedding's backward
  accumulates with atomics otherwise).

* :class:`ElasticDPDriver` — data-parallel gradient workers as actors; a
  worker death mid-step is detected through its failed response future
  and the batch is re-split over the survivors, so the step result is
  independent of the worker count (weighted recombination).
"""
from __future__ import annotations

from concurrent.futures import TimeoutError as FuturesTimeoutError
from typing import Any, Callable, Dict, Optional

import torch
import torch.utils._pytree as pytree

from ..checkpoint import checkpoint as ckpt
from ..core import Actor, ActorSystem, DownMessage
from ..core.memref import as_device_array

__all__ = ["FaultInjected", "RecoverableTrainer", "ElasticDPDriver"]


class FaultInjected(RuntimeError):
    """Deliberate fault (tests / demos): kills the receiving actor."""


def _to_device(system: ActorSystem, batch: Dict[str, Any]) -> Dict[str, Any]:
    """The batch's arrays as tensors on the system's device (the current
    CUDA device when the system names none)."""
    return {k: as_device_array(v, device=system.device)
            for k, v in batch.items()}


# ----------------------------------------------------------------------------
# supervised checkpoint/restart training
# ----------------------------------------------------------------------------
class _TrainWorker(Actor):
    """Owns the train state; one message = one optimizer step."""

    def __init__(self, train_step: Callable, state):
        super().__init__()
        self._train_step = train_step
        self.state = state

    def receive(self, cmd: str, *args):
        if cmd == "step":
            step_idx, batch, inject = args
            if inject:
                raise FaultInjected(f"injected fault at step {step_idx}")
            self.state, metrics = self._train_step(self.state, batch)
            return metrics
        if cmd == "state":
            return self.state
        raise ValueError(f"unknown command {cmd!r}")


class RecoverableTrainer:
    """Checkpoint-every-k training with supervised restart."""

    def __init__(self, system: ActorSystem, train_step: Callable, state,
                 data, ckpt_dir: str, *, ckpt_every: int = 2, keep: int = 3,
                 step_timeout: float = 600.0):
        self.system = system
        self.train_step = train_step
        self.data = data
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.keep = keep
        self.step_timeout = step_timeout
        self.recoveries = 0
        # structure and device donor for restore: a zero-size tensor a leaf
        self._template = pytree.tree_map(lambda t: t.new_empty(0), state)
        self._downs: list = []
        self._sup = system.spawn(self._record_down)
        # step-0 checkpoint: the recovery floor before the first periodic save
        ckpt.save(ckpt_dir, 0, state, keep=keep)
        self._worker = self._spawn_worker(state)

    def _record_down(self, msg):
        if isinstance(msg, DownMessage):
            self._downs.append(msg)

    def _spawn_worker(self, state):
        ref = self.system.spawn(_TrainWorker(self.train_step, state))
        self.system.monitor(self._sup, ref)
        return ref

    def run(self, total_steps: int, fail_at: Optional[int] = None):
        """Run ``total_steps`` optimizer steps; returns the final state.

        ``fail_at`` injects one fault before that step executes — the
        worker dies, the supervisor restores the latest checkpoint, and
        training resumes from the restored step."""
        step, injected = 0, False
        while step < total_steps:
            batch = _to_device(self.system, self.data.batch_at(step))
            inject = fail_at is not None and step == fail_at and not injected
            try:
                self._worker.ask("step", step, batch, inject,
                                 timeout=self.step_timeout)
            except Exception:
                injected = True
                self.recoveries += 1
                step = self._recover()
                continue
            step += 1
            if step % self.ckpt_every == 0:
                self._checkpoint(step)
        final = self._worker.ask("state", timeout=self.step_timeout)
        if int(final["step"]) != total_steps:  # pragma: no cover - invariant
            raise RuntimeError(
                f"state.step={int(final['step'])} != {total_steps}")
        return final

    def _checkpoint(self, step: int) -> None:
        state = self._worker.ask("state", timeout=self.step_timeout)
        ckpt.save(self.ckpt_dir, step, state, keep=self.keep)

    def _recover(self) -> int:
        state, manifest = ckpt.restore(self.ckpt_dir, target=self._template)
        self._worker = self._spawn_worker(state)
        return int(manifest["step"])


# ----------------------------------------------------------------------------
# elastic data parallelism
# ----------------------------------------------------------------------------
class _GradWorker(Actor):
    """Computes (loss, grads) on its batch shard; may carry a planted
    fault (``fail_at[index] == step_idx``) that kills it mid-step."""

    def __init__(self, grad_fn: Callable, index: int,
                 fail_at: Dict[int, int]):
        super().__init__()
        self._grad_fn = grad_fn
        self.index = index
        self._fail_at = dict(fail_at)

    def receive(self, params, shard, step_idx):
        if self._fail_at.get(self.index) == step_idx:
            raise FaultInjected(
                f"worker {self.index} died at step {step_idx}")
        loss, grads = self._grad_fn(params, shard)
        return loss, grads


class ElasticDPDriver:
    """Data-parallel gradient computation that survives worker loss.

    Each step splits the batch rows over the live workers; if a worker
    dies mid-step the step is retried over the survivors. The combined
    (loss, grads) is the row-weighted average, so it equals the
    single-worker result regardless of the split."""

    def __init__(self, system: ActorSystem, grad_fn: Callable, *,
                 n_workers: int = 4,
                 fail_at: Optional[Dict[int, int]] = None,
                 step_timeout: float = 600.0,
                 workers: Optional[list] = None):
        """``workers`` adopts pre-spawned gradient workers instead of
        spawning locally — including :class:`repro_torch.net.RemoteActorRef`\\ s
        (e.g. from ``NodeRuntime.spawn_remote``): a remote *node* death
        fails its response futures just like a local worker death, so the
        elastic re-split covers whole-node loss with no extra code. A
        remote worker's gradients come back as CPU tensors; the combined
        gradients lie on the first result's device."""
        self.system = system
        self.step_timeout = step_timeout
        if workers is not None:
            self.workers = list(workers)
        else:
            self.workers = [
                system.spawn(_GradWorker(grad_fn, i, fail_at or {}))
                for i in range(n_workers)
            ]

    @staticmethod
    def _shard(batch: Dict[str, Any], start: int, size: int):
        return {k: (v[:, start:start + size] if k == "positions"
                    else v[start:start + size])
                for k, v in batch.items()}

    def step(self, params, step_idx: int, batch: Dict[str, Any]):
        """→ ``(loss, grads, n_workers_used)``."""
        batch = _to_device(self.system, batch)
        rows = next(v.shape[1] if k == "positions" else v.shape[0]
                    for k, v in batch.items())
        for _ in range(len(self.workers) + 1):
            live = [w for w in self.workers if w.is_alive()]
            if not live:
                raise RuntimeError("no live gradient workers")
            n = len(live)
            sizes = [rows // n + (1 if i < rows % n else 0) for i in range(n)]
            dispatched, start = [], 0
            for w, sz in zip(live, sizes):
                if sz:
                    dispatched.append(
                        (w, w.request(params, self._shard(batch, start, sz),
                                      step_idx), sz))
                start += sz
            results, dead = [], []
            for w, fut, sz in dispatched:
                try:
                    results.append((fut.result(self.step_timeout), sz))
                except FuturesTimeoutError:
                    # the worker is healthy but slow — surface the timeout
                    # instead of misclassifying it as a death
                    raise
                except Exception:
                    dead.append(w.actor_id)
            if dead:
                self.workers = [w for w in self.workers
                                if w.actor_id not in dead]
                continue
            used = sum(1 for _, sz in results if sz)
            loss = sum(float(l) * sz for (l, _), sz in results) / rows
            grads = pytree.tree_map(
                lambda *gs: sum(
                    g.to(device=gs[0].device, dtype=torch.float32) *
                    (sz / rows)
                    for g, (_, sz) in zip(gs, results)),
                *[g for (_, g), _ in results])
            return loss, grads, used
        raise RuntimeError("elastic step did not converge")  # pragma: no cover

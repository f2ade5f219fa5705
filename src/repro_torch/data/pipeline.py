"""Deterministic synthetic data pipeline — the port of the JAX package's
``repro/data/pipeline.py``: pure numpy, the same Philox counters, so both
packages give the same arrays for the same ``(seed, step, shard)``.

Stateless by construction: ``batch_at(step)`` derives every batch from
``(seed, step, shard)`` with a counter-based RNG, so a restarted (or
re-sharded, for elastic rescale) trainer reproduces the exact stream —
the property the checkpoint/restart test and the paper-style supervisor
recovery rely on.

The token stream has learnable structure (a noisy affine next-token rule)
so small-model training loss demonstrably decreases.

The encdec and vlm extras (``frames``, ``vision_embeds``) are host arrays
of the compute dtype, f32 where that is bfloat16: numpy has no bfloat16
unless ``ml_dtypes`` is loaded, which the port never imports.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from ..configs.base import ModelConfig

__all__ = ["SyntheticLM", "Prefetcher"]


class SyntheticLM:
    def __init__(self, cfg: ModelConfig, batch: int, seq: int, *,
                 seed: int = 0, shard: int = 0, num_shards: int = 1,
                 noise: float = 0.05):
        assert batch % num_shards == 0, (batch, num_shards)
        self.cfg = cfg
        self.global_batch = batch
        self.batch = batch // num_shards
        self.seq = seq
        self.seed = seed
        self.shard = shard
        self.num_shards = num_shards
        self.noise = noise

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.Generator(np.random.Philox(
            key=np.uint64(self.seed),
            counter=[np.uint64(step), np.uint64(self.shard), 0, 0]))

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = self._rng(step)
        v = self.cfg.vocab_size
        b, s = self.batch, self.seq
        # noisy affine chain: x_{t+1} = (a*x_t + c) % v, occasionally random
        a = 31
        c = 7
        x = np.empty((b, s + 1), np.int32)
        x[:, 0] = rng.integers(0, v, b)
        noise = rng.random((b, s)) < self.noise
        rand = rng.integers(0, v, (b, s))
        for t in range(s):
            nxt = (x[:, t] * a + c) % v
            x[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt)
        out = {"tokens": x[:, :-1], "labels": x[:, 1:]}
        if self.cfg.family not in ("encdec", "vlm"):
            return out
        dt = (np.float32 if self.cfg.compute_dtype == "bfloat16"
              else np.dtype(self.cfg.compute_dtype))
        if self.cfg.family == "encdec":
            out["frames"] = rng.standard_normal(
                (b, self.cfg.encdec.n_frames, self.cfg.d_model)).astype(dt)
        if self.cfg.family == "vlm":
            out["vision_embeds"] = rng.standard_normal(
                (b, self.cfg.n_vision_tokens, self.cfg.d_model)).astype(dt)
            pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
            out["positions"] = np.broadcast_to(pos, (3, b, s)).copy()
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch queue over any step-indexed source."""

    def __init__(self, source: SyntheticLM, depth: int = 2,
                 start_step: int = 0):
        self._source = source
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            batch = self._source.batch_at(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)

"""Dynamic batch formation: max-batch / max-wait policies, shape-bucketed.

The :class:`Batcher` turns the admission queue's request stream into
decode batches. Two policies bound how long a request waits for company:

* **max-batch** — the moment ``max_batch`` same-bucket requests are
  available the batch dispatches, without waiting out the window;
* **max-wait** — once a seed request arrives, the window stays open at
  most ``max_wait_ms``; whatever joined by then goes, so a lone request
  is never held hostage to a batch that might fill later.

Batches are **shape-bucketed**: only requests whose prompt bucket matches
the seed's join, keeping the stacked decode step's shapes uniform. The engine's continuous-batching join path calls
``take(bucket=..., max_wait_s=0)`` — pinned to the running batch's bucket
and windowless, a running batch never stalls to wait for joiners.
"""
from __future__ import annotations

import time
from typing import List, Optional

from .request import Request, RequestQueue

__all__ = ["Batcher"]


class Batcher:
    def __init__(self, queue: RequestQueue, *, max_batch: int = 8,
                 max_wait_ms: float = 2.0, clock=time.monotonic):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if max_wait_ms < 0:
            raise ValueError("max_wait_ms must be >= 0")
        self.queue = queue
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self.clock = clock

    def take(self, max_n: Optional[int] = None, *, bucket=None,
             wait_s: float = 0.0,
             max_wait_s: Optional[float] = None) -> List[Request]:
        """Form one batch of up to ``min(max_n, max_batch)`` requests.

        Blocks up to ``wait_s`` for the seed request; once seeded, keeps
        the window open ``max_wait_s`` (default: the configured max-wait)
        for same-bucket requests, returning early the moment the batch is
        full. ``bucket`` pins the batch to a running batch's shape bucket
        (the join path) instead of adopting the seed's. Returns ``[]``
        when nothing arrives in time.
        """
        n = self.max_batch if max_n is None else min(max_n, self.max_batch)
        if n <= 0:
            return []
        seed = self.queue.pop(bucket=bucket, timeout=wait_s)
        if seed is None:
            return []
        batch = [seed]
        if bucket is None:
            bucket = seed.bucket
        window = self.max_wait_s if max_wait_s is None else max_wait_s
        deadline = self.clock() + window
        while len(batch) < n:
            remaining = deadline - self.clock()
            req = self.queue.pop(bucket=bucket, timeout=max(0.0, remaining))
            if req is None:
                break
            batch.append(req)
        return batch

    def take_one(self, *, bucket=None, wait_s: float = 0.0
                 ) -> Optional[Request]:
        """Pop a single request without opening a batching window — the
        prefill stage of a paged engine consumes prompts one at a time
        (pages need no shape bucketing; batching happens at decode)."""
        return self.queue.pop(bucket=bucket, timeout=wait_s)

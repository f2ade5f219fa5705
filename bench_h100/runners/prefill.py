"""Prefill cells: requests through the port's stage actors.

``PipelineRunner.submit(tokens, emit="ref")`` over
``make_layer_stage_actors(system, model, params, n_stages=1)`` in an
``ActorSystem``, with ``Model(cfg, attn_impl="kernel")``: the port's
request-level prefill entry, through its actor runtime, ``dist.pipeline``,
``models`` and the flash-attention kernel. A request is done when its
first token, the argmax of each row's last-position logits read through
the returned ``DeviceRef``, is on the host.

One dispatcher sends the backlog's requests as the runner takes them (its
depth bounds those in flight); one reader takes the results in order.
The window closes at the first completion at or after ``--seconds``.
"""
from __future__ import annotations

import itertools
import queue
import random
import threading
from typing import Any, Dict, List, Optional

import torch

from .. import traffic as traffic_mod
from .. import weights as weights_mod
from ..trace import DeviceTrace, span
from .common import now, sync

#: every shape of the mix is sent this many times in set-up
WARM_PASSES = 2
#: the index of the first traced request
TRACED_BASE = 1 << 30


def row_plan(req: traffic_mod.Request, seed: int, per_row: int) -> tuple:
    """(row, positions) of a request: one row, drawn from the seed and the
    request's index, its last position and ``per_row`` others. Every
    request keeps these logits; the sample compared is chosen among the
    completed ones after the window (``choose``)."""
    rng = random.Random(f"{int(seed)}:{req.index}")
    row = rng.randrange(req.batch)
    cols = sorted(rng.sample(range(req.seq - 1), min(per_row, req.seq - 1)))
    return row, cols + [req.seq - 1]


def choose(completed: List[traffic_mod.Request], seed: int,
           budget: int) -> List[int]:
    """The requests whose planned row is compared: the first completed one
    of the longest rows, then others in an order drawn from the seed while
    the reference's token budget lasts."""
    if not completed:
        return []
    rng = random.Random(int(seed) * 104729 + 3)
    longest = max(r.seq for r in completed)
    first = next(r for r in completed if r.seq == longest)
    rest = [r for r in completed if r is not first]
    rng.shuffle(rest)
    out, used = [first.index], first.seq
    for r in rest:
        if used + r.seq <= budget:
            out.append(r.index)
            used += r.seq
    return out


class Prefill:
    def __init__(self, cell, cfg, params, seed: int, device, seconds: float):
        self.cell, self.cfg, self.seed = cell, cfg, seed
        self.device = torch.device(device)
        self.mix = cell.traffic
        self.seconds = seconds
        self.per_row = int(cell.limits.get("positions_per_row", 16))
        self.sent: Dict[int, traffic_mod.Request] = {}
        self.plan: Dict[int, tuple] = {}
        self.params = params
        self._build()

    # -- set-up ------------------------------------------------------------
    def _build(self) -> None:
        from repro_torch.core import ActorSystem
        from repro_torch.dist.pipeline import (PipelineRunner,
                                               make_layer_stage_actors)
        from repro_torch.models import Model
        from repro_torch.models.layers import ParamTree
        self.model = Model(self.cfg, attn_impl="kernel", device=self.device)
        self.tree = ParamTree(self.params)
        self.system = ActorSystem(name="bench", device=self.device)
        stages = make_layer_stage_actors(self.system, self.model, self.tree,
                                         n_stages=1)
        self.runner = PipelineRunner(self.system, stages,
                                     depth=int(self.mix["depth"]))
        vocab = self.cfg.vocab_size
        warm = [tuple(s) for _ in range(WARM_PASSES)
                for s in self.mix["shapes"]]
        for i, (b, s) in enumerate(warm):
            tok = weights_mod.tokens(self.seed, -1 - i, b, s, vocab,
                                     self.device)
            ref = self.runner.submit(tok, emit="ref").result()
            ref.array[:, -1].argmax(-1).cpu()
            ref.release()
        sync(self.device)

    def tokens_of(self, index: int) -> torch.Tensor:
        """The token ids of sent request ``index``, drawn from the seed."""
        r = self.sent[index]
        return weights_mod.tokens(self.seed, r.index, r.batch, r.seq,
                                  self.cfg.vocab_size, self.device)

    # -- the window ----------------------------------------------------------
    def _stream(self, requests, close_s: Optional[float]):
        """Send ``requests`` as the runner takes them and read their first
        tokens. With ``close_s`` (seconds), stop sending once a request
        completes at or after it. → (t0, rows of (request, done), close
        time)."""
        q: "queue.Queue" = queue.Queue()
        done: List[tuple] = []
        state = {"close": None, "error": None}
        kept: Dict[int, torch.Tensor] = self.kept

        def reader():
            while True:
                item = q.get()
                if item is None:
                    return
                req, fut = item
                try:
                    with span("wait"):
                        ref = fut.result()
                    with span("read"):
                        logits = ref.array
                        logits[:, -1].argmax(-1).cpu()
                        t = now()
                        if req.index in self.plan:
                            row, cols = self.plan[req.index]
                            kept[req.index] = logits[row][cols].clone()
                        ref.release()
                except Exception as exc:   # counted as failed; ends the run
                    state["error"] = exc
                    t = float("nan")
                    if state["close"] is None:
                        state["close"] = now()
                done.append((req, t))
                if (close_s is not None and state["close"] is None
                        and t - t0 >= close_s):
                    state["close"] = t

        th = threading.Thread(target=reader, name="bench-reader", daemon=True)
        th.start()
        t0 = now()
        for req in requests:
            if state["close"] is not None:
                break
            self.sent[req.index] = req
            self.plan[req.index] = row_plan(req, self.seed, self.per_row)
            tok = self.tokens_of(req.index)
            with span("submit"):
                fut = self.runner.submit(tok, emit="ref")
            q.put((req, fut))
        q.put(None)
        th.join()
        if state["error"] is not None and not done:
            raise state["error"]
        return t0, done, state["close"]

    def window(self) -> Dict[str, Any]:
        self.kept = {}
        t0, done, close = self._stream(
            traffic_mod.backlog(self.mix, self.seed), self.seconds)
        counted = [(r, t) for r, t in done if t <= close]
        self.counted = [r for r, _ in counted]
        self.failed = sum(1 for _, t in done if t != t)
        span_s = close - t0
        return {"prefill_tokens_per_s": sum(r.tokens for r in self.counted)
                / span_s, "window_s": span_s}

    def traced(self) -> Dict[str, Any]:
        """``traced_requests`` more requests, from an empty runner, under
        the profiler, sent as the window sends them."""
        n = int(self.mix["traced_requests"])
        reqs = list(itertools.islice(
            traffic_mod.backlog(self.mix, self.seed + 1, TRACED_BASE), n))
        saved, self.kept = self.kept, {}
        sync(self.device)
        with DeviceTrace(self.device) as tr:
            t0, done, _ = self._stream(reqs, None)
            t1 = max(t for _, t in done)
        self.kept = saved
        return {"summary": tr.summary(), "window_s": t1 - t0,
                "requests": reqs}

    def outputs(self) -> Dict[str, Any]:
        """The compared rows: a sample of the requests the window counted."""
        done = [r for r in self.counted if r.index in self.kept]
        pick = choose(done, self.seed, int(self.cell.limits["sample_tokens"]))
        return {i: self.kept[i] for i in pick}

    def free(self) -> None:
        self.system.shutdown()
        del self.runner, self.system, self.model, self.tree

"""The one generator of traffic: a mix file of ``traffic/`` and a seed
give the requests of a run.

A prefill mix names its request shapes ``[batch, seq]``, which every
cycle sends once each, in an order the seed draws anew for every cycle,
so every seed does the same work. The requests form a backlog without
end, all due when the window opens: the runner's ``depth`` bounds those
in flight, as that many clients would that each send their next request
when the last one's first token is back. A train mix names ``batch`` and
``seq``. The token ids come from ``weights.tokens``.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Any, Dict, Iterator


@dataclasses.dataclass(frozen=True)
class Request:
    index: int
    batch: int
    seq: int

    @property
    def tokens(self) -> int:
        return self.batch * self.seq


def backlog(mix: Dict[str, Any], seed: int,
            start: int = 0) -> Iterator[Request]:
    """Requests ``start``, ``start + 1``, … without end: whole cycles of
    the mix's shapes, each shuffled by the seed."""
    rng = random.Random(int(seed))
    shapes = [tuple(s) for s in mix["shapes"]]
    index = start
    while True:
        cycle = list(shapes)
        rng.shuffle(cycle)
        for batch, seq in cycle:
            yield Request(index, batch, seq)
            index += 1

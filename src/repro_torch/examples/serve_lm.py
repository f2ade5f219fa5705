"""Batched greedy serving through an actor, on the port: the decode step
(one token across a request batch, KV cache resident) is wrapped in an
actor, so requests flow in as messages and the cache never leaves the
device — the paper's resident-memory pipeline applied to LM decoding.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm

The model is qwen3-1.7b's smoke config with random weights from seed 0;
:func:`run` takes another config and its parameters.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import configs
from repro_torch.configs.base import ModelConfig
from repro_torch.core import Actor, ActorSystem
from repro_torch.dist import step as step_mod
from repro_torch.models import Model

#: requests in the batch, and greedy steps from token 0
BATCH, STEPS = 8, 32


class DecodeActor(Actor):
    """Owns params + KV cache; each message decodes one step for the
    batch."""

    def __init__(self, model: Model, params, batch: int, max_len: int):
        super().__init__()
        self.model = model
        self.params = params
        self.cache = model.init_cache(batch, max_len)
        # eager PyTorch has no jit: the step runs as built
        self.step = step_mod.build_serve_step(model)

    def receive(self, tokens):
        with torch.no_grad():
            nxt, _, self.cache = self.step(
                self.params, self.cache,
                torch.as_tensor(tokens, device=self.model.device))
        return nxt.cpu().numpy()


def run(cfg: Optional[ModelConfig] = None, params=None, *, device=None
        ) -> Dict[str, Any]:
    """Decode STEPS greedy tokens for BATCH requests from token 0 on
    ``device`` (``cuda:0`` by default): ``cfg`` defaults to qwen3-1.7b's
    smoke config, ``params`` to ``Model.init(0)``. Returns the sequences
    ``[BATCH, STEPS + 1]`` (int32, token 0 first), the wall seconds of the
    decode loop and tok/s."""
    batch, steps = BATCH, STEPS
    cfg = cfg or configs.get_smoke_config("qwen3-1.7b")
    with ActorSystem(device=device) as system:
        dev = system.opencl_manager().find_device().torch_device
        model = Model(cfg, device=dev)
        if params is None:
            params = model.init(0)
        decoder = system.spawn(DecodeActor(model, params, batch, steps + 1))
        toks = np.zeros((batch, 1), np.int32)
        outputs = [toks]
        t0 = time.perf_counter()
        for _ in range(steps):
            toks = decoder.ask(toks)
            outputs.append(toks)
        seconds = time.perf_counter() - t0
    return {"tokens": np.concatenate(outputs, axis=1), "seconds": seconds,
            "tok_s": steps * batch / seconds}


def main(argv=None) -> None:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    r = run()
    print(f"decoded {STEPS} steps × {BATCH} requests in {r['seconds']:.2f}s "
          f"({r['tok_s']:.0f} tok/s)")
    print("first sequence:", r["tokens"][0].tolist())


if __name__ == "__main__":
    main()

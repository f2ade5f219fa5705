"""Paper §5.4 — heterogeneous fractional offload of a Mandelbrot frame.

Two workers render row slices of one frame: a "host" worker with the
plain PyTorch loop on the CPU and a "device" worker with the hand-written
kernel on the card, the paper's CPU/GPU split. The device share is swept
with ``split_offload``, then a ``ChunkScheduler`` (through
``ActorPool.map``) pulls row chunks onto whichever worker is free and
re-issues the host's straggling chunk to the card. Every assembled frame
equals the all-card frame bit for bit: both workers round after every
f32 operation. Run on a machine with a CUDA card:

    PYTHONPATH=src python -m repro_torch.examples.mandelbrot_offload
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Dict, Sequence

import numpy as np
import torch

from repro_torch.core import ActorPool, ActorSystem, split_offload
from repro_torch.kernels import ops

SHADES = " .:-=+*#%@"


@dataclass(frozen=True)
class Frame:
    """One frame of the set: its size, iteration cap and view."""
    width: int = 256
    height: int = 64
    max_iter: int = 60
    re_min: float = -2.0
    re_max: float = 0.6
    im_min: float = -1.2
    im_max: float = 1.2

    def render(self, start: int, rows: int, device) -> torch.Tensor:
        """int32 counts of rows ``[start, start + rows)`` on ``device``."""
        return ops.mandelbrot(height=rows, width=self.width,
                              max_iter=self.max_iter, re_min=self.re_min,
                              re_max=self.re_max, im_min=self.im_min,
                              im_max=self.im_max, row_offset=start,
                              total_height=self.height, device=device)


def spawn_workers(system: ActorSystem, frame: Frame, device):
    """``(host, card)`` function actors taking ``(start, rows)``: the host
    worker renders on the CPU, the card worker on ``device``."""
    host = system.spawn(lambda s, n: frame.render(s, n, "cpu"))
    card = system.spawn(lambda s, n: frame.render(s, n, device))
    return host, card


def offload(frame: Frame, host, card, share: float, out_device
            ) -> torch.Tensor:
    """One fractional split: the first ``round(height * share)`` rows on
    the card, the rest on the host, assembled on ``out_device``."""
    rows_card = round(frame.height * share)
    return split_offload(
        [card, host], [share, 1.0 - share],
        make_payload=lambda s, n: (s, n),
        sizes_of=lambda fr: [rows_card, frame.height - rows_card],
        combine=lambda parts: torch.cat([p.to(out_device) for p in parts]))


def scheduled(frame: Frame, pool: ActorPool, chunks: int, out_device,
              **scheduler_kwargs) -> torch.Tensor:
    """The frame in ``chunks`` row chunks pulled by the pool's workers."""
    bounds = np.linspace(0, frame.height, chunks + 1).astype(int)
    payloads = [(int(a), int(b - a)) for a, b in zip(bounds[:-1], bounds[1:])]
    parts = pool.map(payloads, **scheduler_kwargs)
    return torch.cat([p.to(out_device) for p in parts])


def run(system: ActorSystem, frame: Frame, shares: Sequence[float],
        chunks: int, straggler_factor: float = 3.0) -> Dict[str, object]:
    """Render the frame on the card alone, then at every device share and
    through the scheduler; raise if any frame differs from the all-card
    one. Returns the wall seconds of each and the scheduled frame."""
    device = system.opencl_manager().find_device().torch_device
    host, card = spawn_workers(system, frame, device)
    want = card.ask(0, frame.height)
    walls = {}
    for share in shares:
        t0 = time.perf_counter()
        img = offload(frame, host, card, share, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        walls[f"{round(share * 100)}%"] = time.perf_counter() - t0
        if not torch.equal(img, want):
            raise AssertionError(f"device share {share}: the frame differs "
                                 "from the all-card frame")
    pool = ActorPool(system, [card, host])
    t0 = time.perf_counter()
    img = scheduled(frame, pool, chunks, device,
                    straggler_factor=straggler_factor)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    walls["scheduled"] = time.perf_counter() - t0
    if not torch.equal(img, want):
        raise AssertionError("the scheduled frame differs from the all-card "
                             "frame")
    return {"walls": walls, "frame": img}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--width", type=int, default=Frame.width)
    parser.add_argument("--height", type=int, default=Frame.height)
    parser.add_argument("--max-iter", type=int, default=Frame.max_iter)
    parser.add_argument("--chunks", type=int, default=8)
    args = parser.parse_args(argv)
    frame = Frame(width=args.width, height=args.height,
                  max_iter=args.max_iter)
    with ActorSystem() as system:
        out = run(system, frame, shares=(0.0, 0.5, 1.0), chunks=args.chunks,
                  straggler_factor=2.0)
    print("device share -> wall time (every frame equals the all-card one):")
    for name, wall in out["walls"].items():
        print(f"  {name:>9}: {wall:.3f}s")
    img = out["frame"].cpu().numpy()
    for row in img[::4, ::4]:
        print("".join(SHADES[min(int(v) * len(SHADES) // (frame.max_iter + 1),
                                 len(SHADES) - 1)] for v in row))


if __name__ == "__main__":
    main()

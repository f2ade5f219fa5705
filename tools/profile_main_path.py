"""Where the time of the PyTorch port's main path goes on one CUDA card.

    python3 tools/profile_main_path.py

Runs each main-path phase of ``chip_smoke.py``, built by that script's own
phase builders at its shapes, once to warm up, then once
under ``torch.profiler`` and once more timed by the host clock (ending in
``torch.cuda.synchronize()``). For each phase it prints the wall time,
the device's busy time (the union of the intervals in which a kernel or a
copy ran on the card), its idle share, and the device operations that
took the most time. The last line is one JSON object with the same
numbers. Needs a CUDA card; exits with code 2 without one.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import chip_smoke as smoke  # noqa: E402  (puts src/ on the path)
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

TOP = 8


def _busy_us(events) -> float:
    """Length of the union of the device intervals among ``events``."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def _phase(name: str, fn) -> dict:
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    busy_ms = _busy_us(events) / 1e3
    by_name: dict = {}
    for e in events:
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    row = {"phase": name, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
           "top_device_ops_ms": [[n[:80], us / 1e3] for n, us in top]}
    print(f"{name}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, "
          f"idle share {row['idle_share']:.3f}", flush=True)
    for n, us in top:
        print(f"    {us / 1e3:9.3f} ms  {n[:100]}", flush=True)
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_main_path: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.core import ActorPool, ActorSystem
    from repro_torch.examples.mandelbrot_offload import (offload, scheduled,
                                                         spawn_workers)
    from repro_torch.indexing import build_wah_index, wah_index_pipeline_actors
    from repro_torch.kernels import KERNELS, build_all

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    build_all(KERNELS)
    rng = np.random.default_rng(0)
    rows = []
    with ActorSystem(name="profile") as system:
        dev = system.opencl_manager().find_device().torch_device
        n = smoke.MM_N
        for dt in (torch.float32, torch.bfloat16):
            worker, m1, m2 = smoke.spawn_m_mult(system, n, rng, dt)
            rows.append(_phase(f"m_mult {n}x{n} {dt}",
                               lambda: worker.ask(m1, m2)))

        values = torch.from_numpy(smoke.wah_values(rng)).to(dev)
        rows.append(_phase("build_wah_index n=2^24",
                           lambda: build_wah_index(values, smoke.WAH_CARD)))
        del values

        fills, lits = smoke.pipeline_inputs(rng)
        for mode in ("staged", "fused"):
            pipe = wah_index_pipeline_actors(system, smoke.PIPE_K, mode=mode)
            rows.append(_phase(f"wah pipeline {mode} k=2^23",
                               lambda: pipe.ask(fills, lits)))

        frame = smoke.offload_frame()
        cpu_worker, card_worker = spawn_workers(system, frame, dev)
        for share in smoke.OFFLOAD_SHARES:
            rows.append(_phase(
                f"mandelbrot offload {frame.width}x{frame.height} "
                f"it={frame.max_iter} device {share:.0%}",
                lambda: offload(frame, cpu_worker, card_worker, share, dev)))
        pool = ActorPool(system, [card_worker, cpu_worker])
        rows.append(_phase(
            f"mandelbrot ActorPool.map {smoke.OFFLOAD_CHUNKS} chunks",
            lambda: scheduled(frame, pool, smoke.OFFLOAD_CHUNKS, dev)))

        mapped, x_ref, _ = smoke.map_over_graph(system, rng, dev)
        rows.append(_phase(f"map_over matmul {smoke.MAP_ROWS}x{smoke.MAP_K}",
                           lambda: mapped.ask(x_ref)))
        x_ref.release()

    _, model, params, tokens = smoke.prefill_model(rng, dev)
    rows.append(_phase(
        f"qwen3-1.7b prefill {smoke.PREFILL_B}x{smoke.PREFILL_S} bf16",
        lambda: model.forward(params, {"tokens": tokens})))
    print(json.dumps({"card": card, "phases": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

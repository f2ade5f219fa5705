"""Where the time of the PyTorch port's main path goes on one CUDA card.

    python3 tools/profile_main_path.py

Runs each main-path phase of ``chip_smoke.py``, built by that script's own
phase builders at its shapes, once to warm up, then once under
``torch.profiler``, then three times more timed by the host clock (each
ending in ``torch.cuda.synchronize()``; the median is kept). For each
phase it prints the wall time, the device's busy time (the union of the
intervals in which a kernel or a copy ran on the card), its idle share,
and the device operations that took the most time. The serve phases run one batch
(``chip_smoke.SERVE_BATCH`` requests x ``chip_smoke.SERVE_PROFILE_STEPS``
tokens) at qwen3-1.7b's full width, with the prefill phase's random bf16
weights, through each layer that the engine adds to a decode step:

* ``serve step enqueue``: ``serve_step`` back to back, the card
  synchronised only at the end (the host's rate of issuing a step);
* ``serve sync loop``: the static-batch loop, the tokens read back after
  every step; with the host's side of the step (PyTorch calls and their
  CPU time); then the same loop on a new Python thread;
* ``serve decode worker``: the engine's decode behavior, called on this
  thread with the launcher's ``engine_fns``, caches carried as
  ``DeviceRef``\\ s;
* ``serve engine``: ``run_engine`` (actor hop, ``ChunkScheduler``, worker
  threads); then the paged engine at qwen3-1.7b's widths.

Then one full-width qwen3-1.7b train step (``chip_smoke.TRAIN_B`` x
``chip_smoke.TRAIN_S`` tokens, bf16 parameters, f32 AdamW state, remat
"full"), and its two halves alone: ``loss_and_grads`` (forward, the
recompute and the backward) and ``adamw.update``.

Then each family phase's bf16 prefill (``chip_smoke.FAMILY_PHASES``:
phi-3.5-moe at 16 layers, mamba2-130m, recurrentgemma-9b, whisper-tiny,
qwen2-vl-2b at their published widths, random weights from seed 0,
``attn_impl="kernel"``), built by ``chip_smoke.family_config`` and
``chip_smoke.family_batch``, each freed before the next.
``--only families`` runs those rows alone.

Then the distribution layer's rows (``--only dist`` runs them alone):
nemotron-4-340b's bf16 prefill at ``chip_smoke.NEMOTRON_LAYERS`` of its
96 layers (1 x ``chip_smoke.NEMOTRON_S``), and qwen3-1.7b's bf16 prefill
weights in ``chip_smoke.PIPE_STAGES`` stage actors, the
``chip_smoke.PIPE_MICROBATCHES`` microbatches of 1 x
``chip_smoke.PREFILL_S`` tokens through a ``PipelineRunner`` of depth
``chip_smoke.PIPE_DEPTH``, beside the same microbatches through the fused
forward one after another. The profiler sees the stage actors' device
work, not their threads' host calls.

Serve rows also give the wall a step (``ms_a_step``). The last line is
one JSON object with the same numbers. Needs a CUDA card; exits with
code 2 without one.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import chip_smoke as smoke  # noqa: E402  (puts src/ on the path)
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

TOP = 8
ROUNDS = 3          # timed calls a phase; the row gives their median


def _phase(name: str, fn, host: bool = False, steps: int = 0) -> dict:
    """Profile ``fn`` once (after a warm-up call), then time ``ROUNDS``
    more calls and keep their median wall.
    With ``steps`` the row also gets the timed wall over that many decode
    steps. With ``host`` it also gets the host's side: the PyTorch calls
    that took the most CPU time in themselves, with their counts, and
    the CPU time of all of them together (calls made on this thread
    only: the profiler does not see an actor's worker threads)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    walls = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = sorted(walls)[ROUNDS // 2]
    events = prof.events()
    busy_ms = smoke.device_busy_ms(events)
    by_name: dict = {}
    for e in events:
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    row = {"phase": name, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
           "top_device_ops_ms": [[n[:80], us / 1e3] for n, us in top]}
    if steps:
        row["ms_a_step"] = wall_ms / steps
    print(f"{name}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, "
          f"idle share {row['idle_share']:.3f}"
          + (f", {wall_ms / steps:.3f} ms a step" if steps else ""),
          flush=True)
    for n, us in top:
        print(f"    {us / 1e3:9.3f} ms  {n[:100]}", flush=True)
    if host:
        ops = [a for a in prof.key_averages() if a.key.startswith("aten::")
               or a.key.startswith("cuda")]
        ops.sort(key=lambda a: -a.self_cpu_time_total)
        total = sum(a.self_cpu_time_total for a in ops) / 1e3
        row["host_calls_self_ms"] = total
        row["top_host_ops_ms"] = [[a.key[:80], a.self_cpu_time_total / 1e3,
                                   a.count] for a in ops[:TOP]]
        print(f"    host: {total:.3f} ms of CPU time inside PyTorch and CUDA "
              "calls (profiled run)", flush=True)
        for key, ms, count in row["top_host_ops_ms"]:
            print(f"    {ms:9.3f} ms  {count:7d} x {key}", flush=True)
    return row


def family_rows(dev) -> list:
    """One row for each family phase's bf16 prefill."""
    from repro_torch.models import Model
    rows = []
    for phase, (arch, b, s, _) in smoke.FAMILY_PHASES.items():
        cfg = smoke.family_config(phase)
        model = Model(cfg, attn_impl="kernel", device=dev)
        params = model.init(0)
        batch = smoke.family_batch(cfg, b, s, dev)
        rows.append(_phase(f"{phase} {arch} ({cfg.n_layers} layers) prefill "
                           f"{b}x{s} bf16",
                           lambda: model.forward(params, batch)))
        del model, params, batch
        torch.cuda.empty_cache()
    return rows


def dist_rows(dev) -> list:
    """The nemotron-4-340b prefill row, then the staged and fused rows of
    the pipeline phase."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core import ActorSystem
    from repro_torch.dist.pipeline import (PipelineRunner,
                                           make_layer_stage_actors)
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_config("nemotron-4-340b"),
                              n_layers=smoke.NEMOTRON_LAYERS)
    model = Model(cfg, attn_impl="kernel", device=dev)
    params = model.init(0)
    batch = smoke.family_batch(cfg, 1, smoke.NEMOTRON_S, dev)
    rows = [_phase(f"nemotron-4-340b ({cfg.n_layers} of 96 layers) prefill "
                   f"1x{smoke.NEMOTRON_S} bf16",
                   lambda: model.forward(params, batch), host=True)]
    del model, params, batch
    torch.cuda.empty_cache()
    cfg = get_config("qwen3-1.7b")
    model = Model(cfg, attn_impl="kernel", device=dev)
    params = model.init(0)
    rng = np.random.default_rng(smoke.PIPE_SEED)
    mbs = [rng.integers(0, cfg.vocab_size, (1, smoke.PREFILL_S))
           for _ in range(smoke.PIPE_MICROBATCHES)]
    tag = f"{smoke.PIPE_MICROBATCHES} x 1x{smoke.PREFILL_S} bf16"
    with ActorSystem(name="profile_pipeline") as system:
        runner = PipelineRunner(system, make_layer_stage_actors(
            system, model, params, n_stages=smoke.PIPE_STAGES),
            depth=smoke.PIPE_DEPTH)
        rows.append(_phase(f"pipeline qwen3-1.7b {smoke.PIPE_STAGES} stages "
                           f"depth {smoke.PIPE_DEPTH}, {tag}",
                           lambda: runner.run(mbs)))
    rows.append(_phase(f"qwen3-1.7b fused forward, {tag} one after another",
                       lambda: [model.forward(params, {"tokens": mb})
                                for mb in mbs], host=True))
    del model, params
    torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--only", choices=["families", "dist"], default=None,
                    help="profile only these rows")
    args = ap.parse_args(argv)
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
    if args.only is not None:
        rows_of = {"families": family_rows, "dist": dist_rows}[args.only]
        rows = rows_of(torch.device("cuda", 0))
        print(json.dumps({"card": card, "phases": rows}), flush=True)
        return 0
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

    cfg, model, params, tokens = smoke.prefill_model(rng, dev)
    rows.append(_phase(
        f"qwen3-1.7b prefill {smoke.PREFILL_B}x{smoke.PREFILL_S} bf16",
        lambda: model.forward(params, {"tokens": tokens})))

    import torch.utils._pytree as pytree
    from repro_torch.core.memref import tree_wrap
    from repro_torch.dist.step import build_serve_step
    from repro_torch.launch.serve import (engine_fns, run_engine, run_paged,
                                          run_sync)
    from repro_torch.serve import make_decode_worker
    n, steps = smoke.SERVE_BATCH, smoke.SERVE_PROFILE_STEPS
    capacity = steps + 1
    kw = dict(batch=smoke.SERVE_BATCH, workers=smoke.SERVE_WORKERS)
    serve_step = build_serve_step(model)

    def enqueue():
        cache = model.init_cache(n, capacity)
        tok = torch.zeros((n, 1), dtype=torch.int32, device=dev)
        for _ in range(steps):
            tok, _, cache = serve_step(params, cache, tok)
    rows.append(_phase(f"serve step enqueue qwen3-1.7b bf16 {n}x{steps}",
                       enqueue, steps=steps))

    def sync_loop():
        run_sync(model, params, batch=n, steps=steps)
    rows.append(_phase(f"serve sync loop qwen3-1.7b bf16 {n}x{steps}",
                       sync_loop, host=True, steps=steps))

    def on_thread():
        t = threading.Thread(target=sync_loop)
        t.start()
        t.join()
    rows.append(_phase(f"serve sync loop on a new thread {n}x{steps}",
                       on_thread, steps=steps))

    step_fn, combine, split = engine_fns(model, params, capacity)
    decode = make_decode_worker(step_fn, combine=combine, split=split,
                                device=dev)

    def worker():
        rows_in = []
        for _ in range(n):
            leaves, treedef = pytree.tree_flatten(
                tree_wrap(model.init_cache(1, capacity), device=dev))
            rows_in.append(tuple(leaves))
        toks = (0,) * n
        for _ in range(steps):
            out, rows_out = decode("step", toks, tuple(rows_in), treedef)
            for ref in (r for row in rows_in for r in row):
                ref.release()
            rows_in, toks = rows_out, tuple(int(t) for t in out)
        for ref in (r for row in rows_in for r in row):
            ref.release()
    rows.append(_phase(f"serve decode worker {n}x{steps}", worker,
                       steps=steps))
    rows.append(_phase(
        f"serve engine qwen3-1.7b bf16 {n}x{steps} batch {n}",
        lambda: run_engine(model, params, requests=n, steps=steps, **kw),
        steps=steps))
    del model, params
    torch.cuda.empty_cache()

    def paged():
        run = run_paged(cfg, dev, requests=n, steps=steps,
                        prefill_workers=smoke.SERVE_PREFILL_WORKERS,
                        pages=smoke.SERVE_PAGES, **kw)
        run["pool"].evict_prefixes()
    rows.append(_phase(f"serve paged qwen3-1.7b widths {n}x{steps} batch {n}",
                       paged, steps=steps))
    torch.cuda.empty_cache()

    from repro_torch.data import SyntheticLM
    from repro_torch.dist.step import (build_train_step, init_train_state,
                                       loss_and_grads)
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig, adamw
    model = Model(cfg, device=dev)
    ocfg = AdamWConfig()
    state = init_train_state(model, 0, ocfg)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticLM(
        cfg, batch=smoke.TRAIN_B, seq=smoke.TRAIN_S, seed=1).batch_at(0).items()}
    train_step = build_train_step(model, ocfg)
    shape = f"{smoke.TRAIN_B}x{smoke.TRAIN_S}"
    rows.append(_phase(f"train step qwen3-1.7b bf16 {shape}",
                       lambda: train_step(state, batch), host=True))
    rows.append(_phase(f"train loss_and_grads qwen3-1.7b bf16 {shape}",
                       lambda: loss_and_grads(model, state["params"], batch)))
    _, _, grads = loss_and_grads(model, state["params"], batch)
    rows.append(_phase("train adamw.update qwen3-1.7b",
                       lambda: adamw.update(grads, state["opt"],
                                            state["params"], ocfg)))
    del model, state, batch, grads
    torch.cuda.empty_cache()
    rows.extend(family_rows(dev))
    rows.extend(dist_rows(dev))
    print(json.dumps({"card": card, "phases": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

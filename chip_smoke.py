"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written kernels of ``src/repro_torch/kernels/csrc`` with
``nvcc``, holds each against its plain PyTorch version on the card and
times it beside that plain version and one library call, then drives the
port's main path through the entry points a user calls:

* the ``m_mult`` kernel actor (paper Listings 1+2) at 4096x4096 f32, at
  the quickstart's 512x512 f32 and at 4096x4096 bf16 (B1's ``wgmma``
  kernel). B1 is also held at a ragged and a misaligned shape in both
  dtypes and timed in both beside ``torch.matmul`` (device time and host
  time a call);
* ``build_wah_index`` over 2**24 uint32 values of cardinality 64 (paper
  §4), bit-exact against ``impl="ref"`` on the card, decoded against
  ``np.flatnonzero`` and held against the sequential numpy builder at
  2**17;
* the Listing 5 ``wah_index_pipeline_actors`` at k = 2**23, staged and
  fused;
* the paper's §5.4 fractional offload of a 1920x1080 Mandelbrot frame
  (``repro_torch.examples.mandelbrot_offload``): a CPU worker and a card
  worker under ``split_offload`` at device shares 100/90/50 %, then
  ``ActorPool.map`` over 16 row chunks, every frame bit-exact against the
  all-card frame;
* ``Graph.map_over`` of a one-input matmul kernel over an 8192x4096 f32
  ``DeviceRef``, 4 chunks on 2 replicas, with no host transfer;
* the qwen3-1.7b prefill forward at full width (28 layers, random bf16
  weights from a seed, 2 x 2048 tokens) with the flash-attention kernel,
  against the same forward with the plain attention, and an f32 forward
  at 1 x 512 tokens (a phase of its own: 28 launches of B6's f32 kernel).
  B6's bf16 kernel is also timed against SDPA at the prefill's own launch
  shape, and its registers, spills and shared memory are printed. B6's f32
  kernel is timed against SDPA in f32 (device time and host time a call)
  at the layer shape and at the f32 prefill's own launch shape;
* serving at qwen3-1.7b's full width with the prefill phase's random
  bf16 weights (``repro_torch.launch.serve``): 32 requests x 64 greedy
  tokens through ``ServeEngine`` (batch 8, 2 workers), with tok/s,
  latency percentiles, TTFT, the device time of a decode step against
  its bound and the card's idle share; 1 x 256 tokens teacher-forced
  through ``decode_step`` against the prefill forward's logits; the
  engine's tokens against the static-batch loop's in f32; and the paged
  engine (disaggregated prefill and decode over a ``PagePool``, the
  ``--paged --full`` defaults) against the same step function over
  contiguous caches. No kernel of the port is on the decode path: the
  JAX package's decode attention is plain XLA, so it is plain PyTorch
  here;
* the network layer and the serve mesh (``repro_torch.net``,
  ``repro_torch.serve.mesh``): two nodes of this process on the card send
  a 2**22 f32 ``DeviceRef`` to a remote stage and back, raw and
  int8-compressed (one spill and one unspill per hop per side, the result
  bit for bit the same computation on the CPU through the CPU codec), and
  a bf16 leaf and ref; a ``MeshRouter`` over two qwen3-1.7b bf16
  replicas in this process serves 32 requests x 16 tokens, half under 4
  session keys (every request once, 16 routed by key, both replicas
  served, each session on one replica, no transfer or spill, each
  request's tokens those a prefill of its own prompt allows); then a
  driver and two worker processes (``launch.node.run_worker`` by
  ``spawn``, each on its own CUDA context) serve 16 requests x 8 tokens
  from an f32 replica of batch 1 each, offered the rate one such engine
  serves alone, one worker SIGKILLed while it holds a request in flight:
  none lost, none twice, every request's tokens those of one f32 engine
  of batch 1 in this process, the rate after the failure window at least
  0.8 of the rate before it.

Every B1, B3 and B6 kernel's registers and spill bytes are printed (none
may spill), and ``cuobjdump -sass`` of the B1 and B6 libraries shows which
kernels run on the tensor cores (``HGMMA``, fed by ``UTMALDG``) and which
only on the FMA pipes. B3's library has three entries: ``radix_pass`` (the
TPU kernel's contract, checked at 2**24 but off the main path), and the
sort's ``radix_histogram`` and ``radix_onesweep``, held against their
plain versions at 2**24 on random keys at every shift, on the WAH input's
keys and on equal keys, and timed with ``ops.radix_sort`` beside
``torch.sort(stable=True)`` of the keys as int64 and as int32.

Each main-path phase sets every kernel's launch counts to 0 before it and
reads them after it; a kernel of the phase that was not launched fails
the run, and so does a ``build_wah_index`` that is not one
``radix_histogram`` and four ``radix_onesweep`` launches. Any failure
exits non-zero. The last two lines are a JSON object with one entry per
kernel and the JSON result line.

Without a CUDA device it exits with code 2 and prints no result.
"""
from __future__ import annotations

import collections
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import torch  # noqa: E402

#: H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, f32 FLOP/s
#: outside the tensor cores, bf16 FLOP/s in the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
#: the f32 peak counts an FMA as two operations; a kernel that issues no
#: FMA (B2) gets one operation per FMA slot
F32_NON_FMA_OPS = F32_FLOPS / 2
#: device cycles of torch.cuda._sleep that hold the card while a timed
#: loop is enqueued: about 50 ms at the H100's clocks, longer than the
#: host needs to enqueue any loop of one launch a call
HOLD_CYCLES = 100_000_000
#: SASS opcodes counted in each B1 and B6 kernel: tensor-core products,
#: TMA tile loads, f32 FMAs and the pre-Hopper mma.sync
SASS_OPS = ("HGMMA", "UTMALDG", "FFMA", "HMMA")

MM_N = 4096
QUICKSTART_N = 512
#: B1's edge shapes: tiles ragged in M, N and K; and 4096^3 with A one
#: element into its allocation (off 16 bytes: 4-byte copies in f32, a
#: pitched copy before TMA in bf16)
MM_RAGGED = (4095, 4097, 4093)
#: B1 against its plain version: f32 is IEEE f32 on both sides and differs
#: in summation order only; bf16 rounds an f32 result to bf16 on both
#: sides (tests/test_kernels.py's 2e-5 and 2e-2, rel + abs)
MM_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
WAH_N = 1 << 24
WAH_CARD = 64
WAH_CHECK_N = 1 << 17
#: the all-equal keys of B3's check: every pass sees one digit
SORT_EQUAL_KEY = 0x9E3779B9
PIPE_K = 1 << 23
#: benchmarks/bench_offload.py's view, at a 1080p frame
MANDEL_W, MANDEL_H, MANDEL_IT = 1920, 1080, 500
MANDEL_VIEW = dict(re_min=-0.5, re_max=0.1, im_min=-0.7375, im_max=-0.1375)
#: f32 operations per Mandelbrot iteration: 4 products, 4 sums, 1 compare
MANDEL_OPS = 9
#: the offload phase caps iterations at 100 (bench_offload.py's cap): the
#: CPU worker's half frame then takes seconds, not tens of seconds
OFFLOAD_IT = 100
OFFLOAD_SHARES = (1.0, 0.9, 0.5)
OFFLOAD_CHUNKS = 16
#: the qwen3-1.7b layer's attention at 4096 tokens
FA_B, FA_H, FA_HKV, FA_S, FA_D = 1, 16, 8, 4096, 128
#: B6 against its plain version. f32: both are IEEE f32 and differ in
#: summation order (tests/test_kernels.py's 2e-4). bf16 at the layer shape
#: (inputs from seed 0): the H100 read a max_abs_err of 0.00195 (one bf16
#: step at |x| in [0.25, 0.5)) from the SIMT kernel and 0.0039 (one step
#: in [0.5, 1)) from the wgmma kernel, whose P enters P.V as two bf16
#: halves, against a plain output of RMS 0.068; the limit is four times
#: the first reading, 12 % of the RMS, a quarter of the 3e-2 the
#: small-shape tests allow
FA_F32_TOL = 2e-4
FA_BF16_ATOL = 8e-3
#: An absolute limit on bf16 outputs depends on where a rounding
#: difference lands: one step is 0.0039 for |x| in [0.5, 1) but 0.0156 in
#: [2, 4), and the plain output reaches 3.7. Kernel and plain version both
#: round an f32 result to bf16, and their f32 results differ far less than
#: a step, so a correct kernel is at most FA_BF16_STEPS bf16 steps from the
#: plain output at every element, whatever the seed. A step is that of
#: bf16 at |plain| (2^(e - 7) for |x| in [2^e, 2^(e+1))); below
#: FA_BF16_STEP_FLOOR it is the step at the floor (2^-10). Held at both
#: bf16 shapes over the seeds FA_BF16_SEEDS
FA_BF16_STEPS = 1.0
FA_BF16_STEP_FLOOR = 2.0 ** -3
FA_BF16_SEEDS = (0, 1, 2)
MAP_ROWS, MAP_K = 8192, 4096
MAP_CHUNKS, MAP_REPLICAS = 4, 2
PREFILL_B, PREFILL_S, PREFILL_F32_S = 2, 2048, 512
#: B6's two bf16 shapes: the qwen3-1.7b layer at 4096 tokens, and the
#: prefill phase's own launch (PREFILL_B x PREFILL_S)
FA_LAYER = (FA_B, FA_H, FA_HKV, FA_S, FA_S, FA_D)
FA_PREFILL = (PREFILL_B, FA_H, FA_HKV, PREFILL_S, PREFILL_S, FA_D)
#: B6's f32 shape at the f32 prefill's own launch (1 x PREFILL_F32_S)
FA_PREFILL_F32 = (1, FA_H, FA_HKV, PREFILL_F32_S, PREFILL_F32_S, FA_D)
#: kernel vs plain attention through 28 bf16 layers: the plain path rounds
#: the probabilities to bf16 before P.V and the kernel does not, so the
#: residual streams drift apart by bf16 rounding compounded over the
#: layers. Limits at about twice what the H100 read: last-position
#: max_abs_err 0.078 of max |logit| 4.375 (0.018), RMS of the difference
#: over all positions 0.019 of the logits' RMS, top-1 agreement 0.957
PREFILL_BF16_TOL = 0.04
PREFILL_BF16_RMS_TOL = 0.04
PREFILL_TOP1 = 0.9
#: in f32 both paths are IEEE f32 and differ only in summation order: the
#: logits are held to 1e-3 of the largest |logit|
PREFILL_F32_TOL = 1e-3
#: the serve phases: the launcher's defaults (``--requests 32 --batch 8
#: --steps 64 --workers 2``; paged: ``--prefill-workers 2 --pages 512``)
SERVE_REQUESTS, SERVE_BATCH, SERVE_STEPS, SERVE_WORKERS = 32, 8, 64, 2
SERVE_PREFILL_WORKERS, SERVE_PAGES = 2, 512
#: the card's idle share is read from one profiled batch of the engine
#: (SERVE_BATCH requests x SERVE_PROFILE_STEPS steps) against the wall of
#: the same run unprofiled; the profiler's trace grows with every launch
SERVE_PROFILE_STEPS = 16
#: engine against the static-batch loop in f32: two batches of
#: SERVE_BATCH requests with distinct first tokens; the steps are cut
#: from 64 to 24, enough to carry the cache through the engine's
#: combine/split 24 times
SERVE_F32_REQUESTS, SERVE_F32_STEPS = 2 * SERVE_BATCH, 24
#: decode against prefill: 1 x 256 tokens teacher-forced one at a time,
#: each step's logits held to the bf16 prefill check's limits against
#: the prefill forward's at that position
DECODE_S = 256
#: the wire phase: a DeviceRef of 2^22 f32 values (16 MiB) to a remote
#: stage and back between two nodes of this process
WIRE_N = 1 << 22
#: the mesh in one process: 2 bf16 replicas of batch 8 serve 32 requests x
#: 16 greedy tokens, half of them under 4 session keys
MESH_REPLICAS, MESH_BATCH = 2, 8
MESH_REQUESTS, MESH_STEPS, MESH_SESSIONS = 32, 16, 4
#: each of those requests' tokens is held to its own prompt: its prompt
#: and tokens go through one bf16 prefill forward, and each emitted token's
#: logit must lie within MESH_MARGIN x max |logit| of its position's
#: largest. The decode check holds a decode step's logits within
#: PREFILL_BF16_TOL x max |logit| of the prefill's, so a decode step's
#: argmax lies within twice that of the prefill's largest logit; a token
#: of another request's sequence lies several logit spreads below it
MESH_MARGIN = 2 * PREFILL_BF16_TOL
#: the mesh across processes: 2 worker processes of one f32 replica each
#: at batch 1 serve 16 requests x 8 tokens; a worker is killed once a
#: quarter of them have completed and it holds one. The requests are
#: offered at MESH_KILL_LOAD times the rate one f32 engine of batch 1
#: serves them alone in this process (timed on the reference pass), so
#: the survivor runs at full load after the kill. Above 1 a lone
#: survivor could not keep up: its rate after the kill would fall to
#: 1 / MESH_KILL_LOAD of the rate before it, under the 0.8 that run_demo
#: asserts, as the JAX demo does. The failure window after the kill spans
#: MESH_KILL_RECOVER request intervals (the replay and the backlog it
#: leaves), so the window after it holds about half the requests
MESH_WORKERS, MESH_KILL_STEPS, MESH_KILL_LOAD = 2, 8, 1.0
MESH_KILL_REQUESTS, MESH_KILL_RECOVER = 16, 3


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def attention_inputs(shape, dtype, generator, dev):
    """q ``[B,H,Sq,D]``, k and v ``[B,Hkv,Skv,D]`` for ``shape`` (B, H,
    Hkv, Sq, Skv, D), standard normal from ``generator``, in ``dtype``."""
    b, h, hkv, sq, skv, d = shape
    return tuple(torch.randn(*s, generator=generator, device=dev).to(dtype)
                 for s in ((b, h, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))


def bf16_steps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """|got - want| of two bf16 tensors, per element, in bf16 steps at
    |want| (|want| floored at FA_BF16_STEP_FLOOR)."""
    mag = want.float().abs().clamp_min(FA_BF16_STEP_FLOOR)
    step = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return (got.float() - want.float()).abs() / step


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events.

    The device is held busy (``torch.cuda._sleep``) while the calls are
    enqueued, so they run back to back: a call whose host work outlasts
    its kernel (B6 at the prefill shape) is timed on the device, not at
    the host's enqueue rate."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, reps: int, rounds: int = 5) -> float:
    """Host time to enqueue one call of ``fn``, in µs, with the device held
    busy so that no call waits for it: the median over ``rounds`` of the
    mean over ``reps`` calls (the host's CPU is shared and its speed
    varies between rounds)."""
    fn()
    means = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        torch.cuda._sleep(HOLD_CYCLES)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        means.append((time.perf_counter() - t0) / reps * 1e6)
    torch.cuda.synchronize()
    return sorted(means)[rounds // 2]


def device_busy_ms(events) -> float:
    """Length of the union of the device intervals among profiler
    ``events``, in ms."""
    from torch.autograd import DeviceType
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
    return busy / 1e3


def profiled_busy_ms(fn) -> float:
    """The card's busy time, in ms, while ``fn`` runs under
    ``torch.profiler`` (device activity only)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return device_busy_ms(prof.events())


def bytes_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def ops_ms(ops: float, peak: float) -> float:
    return ops / peak * 1e3


def words_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit-exact equality of two 32-bit word tensors (any 32-bit dtype)."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.dtype in (torch.uint32, torch.int32):
        a, b = a.view(torch.int32).long(), b.view(torch.int32).long()
    return float((a.double() - b.double()).abs().max().item()) if a.numel() else 0.0


# -- the main path's phases, shared with tools/profile_main_path.py -------------
def spawn_m_mult(system, n: int, rng, dtype=torch.float32):
    """The ``m_mult`` kernel actor (paper Listings 1+2) at n x n in
    ``dtype``, and two host matrices for it: f32 numpy arrays, or CPU
    tensors for bf16, which numpy lacks."""
    from repro_torch.core import In, NDRange, Out, dim_vec, kernel
    from repro_torch.kernels import ops
    m_mult = kernel(In(dtype), In(dtype), Out(dtype, shape=(n, n)),
                    nd_range=NDRange(dim_vec(n, n)),
                    name="m_mult")(lambda x, y: ops.matmul(x, y))
    m1, m2 = (rng.random((n, n), np.float32) for _ in range(2))
    if dtype != torch.float32:
        m1, m2 = (torch.from_numpy(m).to(dtype) for m in (m1, m2))
    return system.spawn(m_mult), m1, m2


def wah_values(rng) -> np.ndarray:
    """``build_wah_index``'s input: WAH_N values of cardinality WAH_CARD."""
    return rng.integers(0, WAH_CARD, WAH_N).astype(np.uint32)


def pipeline_inputs(rng):
    """Listing 5's fill and literal words, PIPE_K of each."""
    fills = (rng.integers(0, 2, PIPE_K) *
             ((1 << 31) | rng.integers(1, 99, PIPE_K))).astype(np.uint32)
    return fills, rng.integers(1, 2 ** 31, PIPE_K).astype(np.uint32)


def offload_frame():
    """The offload phase's 1080p frame at OFFLOAD_IT iterations."""
    from repro_torch.examples.mandelbrot_offload import Frame
    return Frame(width=MANDEL_W, height=MANDEL_H, max_iter=OFFLOAD_IT,
                 **MANDEL_VIEW)


def map_over_graph(system, rng, dev):
    """``Graph.map_over`` of a one-input matmul kernel, its MAP_ROWS x MAP_K
    ``DeviceRef`` input and the weight: ``(graph, x_ref, w)``."""
    from repro_torch.core import DeviceRef, Graph, In, Out, kernel
    from repro_torch.kernels import ops
    w = torch.from_numpy(rng.random((MAP_K, MAP_K), np.float32)).to(dev)
    mm = kernel(In(torch.float32), Out(torch.float32), name="mm_w")(
        lambda x: ops.matmul(x, w))
    g = Graph(system, name="map_over_mm")
    g.output(g.map_over(mm, g.source("x", torch.float32), chunks=MAP_CHUNKS,
                        replicas=MAP_REPLICAS))
    x_ref = DeviceRef.put(rng.random((MAP_ROWS, MAP_K), np.float32),
                          device=dev)
    return g.build(), x_ref, w


def prefill_model(rng, dev):
    """qwen3-1.7b at full width with the flash-attention kernel, random
    weights from seed 0, and PREFILL_B x PREFILL_S tokens:
    ``(cfg, model, params, tokens)``."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = get_config("qwen3-1.7b")
    model = Model(cfg, attn_impl="kernel", device=dev)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (PREFILL_B, PREFILL_S))).to(dev)
    return cfg, model, model.init(0), tokens


# -- the serve phases -----------------------------------------------------------
def param_bytes(params) -> int:
    return sum(p.numel() * p.element_size() for p in params.parameters())


def latency_line(name: str, run: dict) -> dict:
    """Log and return an engine run's throughput, latency and TTFT."""
    stats, results = run["stats"], run["results"]
    toks = sum(len(r.tokens) for r in results)
    lat, ttft = stats["latency"], stats["ttft"]
    row = dict(requests=len(results), tokens=toks, wall_s=run["wall_s"],
               tok_per_s=toks / run["wall_s"], steps=stats["steps"],
               requeues=stats["requeues"],
               p50_ms=lat["p50_ms"], p95_ms=lat["p95_ms"],
               p99_ms=lat["p99_ms"], ttft_p50_ms=ttft["p50_ms"],
               ttft_p95_ms=ttft["p95_ms"], ttft_p99_ms=ttft["p99_ms"])
    log(f"{name}: {len(results)} requests, {toks} tokens in "
        f"{run['wall_s']:.3f} s: {row['tok_per_s']:.1f} tok/s")
    log(f"{name}: latency p50 {lat['p50_ms']:.1f} ms, p95 "
        f"{lat['p95_ms']:.1f} ms, p99 {lat['p99_ms']:.1f} ms")
    log(f"{name}: TTFT p50 {ttft['p50_ms']:.1f} ms, p95 {ttft['p95_ms']:.1f}"
        f" ms, p99 {ttft['p99_ms']:.1f} ms")
    log(f"{name}: engine steps {stats['steps']}, requeues "
        f"{stats['requeues']}")
    return row


def check_engine_run(name: str, run: dict, requests: int, steps: int,
                     vocab: int) -> None:
    stats = run["stats"]
    check(stats["completed"] == requests and stats["failed"] == 0,
          f"{name}: {stats['completed']} of {requests} requests completed, "
          f"{stats['failed']} failed")
    for r in run["results"]:
        check(len(r.tokens) == steps and
              all(0 <= int(t) < vocab for t in r.tokens),
              f"{name}: request {r.request_id} gave {len(r.tokens)} tokens "
              "or one out of the vocabulary")
    for key in ("transfers", "spills"):
        check(run["memref_after"][key] == run["memref_before"][key],
              f"{name}: the registry's {key} grew during the run")


def serve_engine_phase(run_phase, model, params, dev) -> dict:
    """32 requests x 64 greedy tokens at full width in bf16 through
    ``ServeEngine``; the device time of a decode step (profiled) against
    its bound, and the card's idle share."""
    from repro_torch.dist.step import build_serve_step
    from repro_torch.launch.serve import run_engine
    cfg = model.cfg
    kw = dict(batch=SERVE_BATCH, workers=SERVE_WORKERS)
    run_engine(model, params, requests=SERVE_BATCH, steps=2, **kw)  # warm up
    name = (f"serve engine qwen3-1.7b bf16 {SERVE_REQUESTS}x{SERVE_STEPS} "
            f"batch {SERVE_BATCH}")
    run = run_phase(name, [], lambda: run_engine(
        model, params, requests=SERVE_REQUESTS, steps=SERVE_STEPS, **kw))
    check_engine_run(name, run, SERVE_REQUESTS, SERVE_STEPS, cfg.vocab_size)
    check(run["stats"]["requeues"] == 0, f"{name}: a step was requeued")
    row = latency_line(name, run)
    # device time of one decode step at batch 8, mid-sequence: the step
    # alone (profiled, so host gaps do not count) and one engine step
    # (the worker's cache combine and split included)
    capacity = SERVE_STEPS + 1
    serve_step = build_serve_step(model)
    cache = model.init_cache(SERVE_BATCH, capacity)
    tok = torch.zeros((SERVE_BATCH, 1), dtype=torch.int32, device=dev)
    for _ in range(SERVE_STEPS // 2):
        tok, _, cache = serve_step(params, cache, tok)
    reps = 8

    def steps():
        for _ in range(reps):
            serve_step(params, cache, tok)
    step_busy = profiled_busy_ms(steps) / reps
    t0 = time.perf_counter()
    steps()
    torch.cuda.synchronize()
    step_wall = (time.perf_counter() - t0) * 1e3 / reps
    cache_bytes = sum(t.numel() * t.element_size()
                      for g in cache["groups"] for c in g for t in c.values())
    logit_bytes = SERVE_BATCH * cfg.vocab_size * 2
    weights = param_bytes(params)
    bound = max(bytes_ms(weights + cache_bytes + logit_bytes),
                ops_ms(2.0 * weights / 2 * SERVE_BATCH, BF16_FLOPS))
    prof_kw = dict(requests=SERVE_BATCH, steps=SERVE_PROFILE_STEPS, **kw)
    busy = profiled_busy_ms(lambda: run_engine(model, params, **prof_kw))
    again = run_engine(model, params, **prof_kw)
    idle = max(0.0, 1.0 - busy / (again["wall_s"] * 1e3))
    engine_step_busy = busy / again["stats"]["steps"]
    main_idle = max(0.0, 1.0 - run["stats"]["steps"] * engine_step_busy /
                    (run["wall_s"] * 1e3))
    row.update(step_device_ms=step_busy, step_wall_ms=step_wall,
               engine_step_device_ms=engine_step_busy,
               engine_step_wall_ms=run["wall_s"] * 1e3 / run["stats"]["steps"],
               step_bound_ms=bound, weight_bytes=weights,
               idle_share=idle, idle_share_main_run=main_idle,
               profiled_run=f"{SERVE_BATCH}x{SERVE_PROFILE_STEPS}")
    log(f"{name}: decode step at batch {SERVE_BATCH}: device {step_busy:.4f} "
        f"ms (profiled), host wall {step_wall:.3f} ms; an engine step "
        f"{engine_step_busy:.4f} ms of device time, "
        f"{row['engine_step_wall_ms']:.3f} ms of wall; bound {bound:.4f} ms "
        f"({weights / 1e9:.3f} GB of weights, {cache_bytes / 1e6:.2f} MB of "
        f"cache at {HBM_BYTES_PER_S / 1e12:.2f} TB/s)")
    log(f"{name}: device idle share {idle:.4f} (profiled engine run "
        f"{SERVE_BATCH}x{SERVE_PROFILE_STEPS}: busy {busy:.3f} ms, wall "
        f"{again['wall_s'] * 1e3:.3f} ms unprofiled); the "
        f"{SERVE_REQUESTS}x{SERVE_STEPS} run at that device time a step: "
        f"{main_idle:.4f}")
    return row


def decode_prefill_phase(run_phase, model, params, tokens) -> dict:
    """1 x DECODE_S tokens teacher-forced through ``decode_step``, each
    step's logits against the prefill forward's at that position, to the
    bf16 prefill check's limits."""
    name = f"decode against prefill qwen3-1.7b bf16 1x{DECODE_S}"
    tokens = tokens[:1, :DECODE_S]

    def body():
        cache = model.init_cache(1, DECODE_S)
        out = []
        for t in range(DECODE_S):
            logits, cache = model.decode_step(params, tokens[:, t:t + 1],
                                              cache)
            out.append(logits[0, 0])
        return torch.stack(out), cache

    got, cache = run_phase(name, [], body)
    want = model.forward(params, {"tokens": tokens})[0][0].float()
    got = got.float()
    check(int(cache["len"]) == DECODE_S and bool(torch.isfinite(got).all()),
          f"{name}: cache length or logits wrong")
    err = (got - want).abs().amax(-1)
    scale = want.abs().amax(-1)
    ratio = float((err / scale).max())
    rms = float((got - want).square().mean().sqrt() /
                want.square().mean().sqrt())
    top1 = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    log(f"{name}: worst step max_abs_err / max |logit| {ratio} (limit "
        f"{PREFILL_BF16_TOL}), relative RMS {rms} (limit "
        f"{PREFILL_BF16_RMS_TOL}), top-1 agreement {top1} (limit "
        f"{PREFILL_TOP1})")
    check(ratio <= PREFILL_BF16_TOL, f"{name}: a step's logits differ by "
          f"{ratio} of max |logit| > {PREFILL_BF16_TOL}")
    check(rms <= PREFILL_BF16_RMS_TOL, f"{name}: relative RMS {rms}")
    check(top1 >= PREFILL_TOP1, f"{name}: top-1 agreement {top1}")
    return dict(max_err_ratio=ratio, rms_rel=rms, top1=top1)


def serve_f32_phase(run_phase, model32, params32, rng) -> dict:
    """The engine's tokens against the static-batch loop's at the same
    requests, in f32 with TF32 off."""
    from repro_torch.launch.serve import run_engine, run_sync
    cfg = model32.cfg
    prompts = [int(t) for t in rng.integers(0, cfg.vocab_size,
                                            SERVE_F32_REQUESTS)]
    name = (f"serve engine against sync qwen3-1.7b f32 "
            f"{SERVE_F32_REQUESTS}x{SERVE_F32_STEPS}")
    run = run_phase(name, [], lambda: run_engine(
        model32, params32, requests=SERVE_F32_REQUESTS, batch=SERVE_BATCH,
        steps=SERVE_F32_STEPS, workers=SERVE_WORKERS, prompts=prompts))
    check_engine_run(name, run, SERVE_F32_REQUESTS, SERVE_F32_STEPS,
                     cfg.vocab_size)
    got = [[int(t) for t in r.tokens] for r in run["results"]]
    want = []
    for i in range(0, SERVE_F32_REQUESTS, SERVE_BATCH):
        want += run_sync(model32, params32, batch=SERVE_BATCH,
                         steps=SERVE_F32_STEPS,
                         prompts=prompts[i:i + SERVE_BATCH])["tokens"].tolist()
    same = sum(g == w for g, w in zip(got, want))
    log(f"{name}: {same} of {SERVE_F32_REQUESTS} requests give the sync "
        f"loop's tokens; {run['wall_s']:.3f} s")
    check(same == SERVE_F32_REQUESTS,
          f"{name}: the engine's tokens differ from the sync loop's")
    return dict(requests=SERVE_F32_REQUESTS, steps=SERVE_F32_STEPS,
                equal=same, wall_s=run["wall_s"])


def serve_paged_phase(run_phase, cfg, dev) -> dict:
    """The ``--paged --full`` defaults: prefill and decode workers over a
    PagePool at qwen3-1.7b's widths, against the same step function over
    contiguous caches."""
    from repro_torch.core.memref import registry
    from repro_torch.launch.serve import (contiguous_tokens, paged_model,
                                          run_paged)
    kw = dict(batch=SERVE_BATCH, workers=SERVE_WORKERS,
              prefill_workers=SERVE_PREFILL_WORKERS, pages=SERVE_PAGES)
    warm = run_paged(cfg, dev, requests=4, steps=2, **kw)   # warm up
    warm["pool"].evict_prefixes()
    del warm
    name = (f"serve paged qwen3-1.7b widths {SERVE_REQUESTS}x{SERVE_STEPS} "
            f"batch {SERVE_BATCH}")
    run = run_phase(name, [], lambda: run_paged(
        cfg, dev, requests=SERVE_REQUESTS, steps=SERVE_STEPS, **kw))
    check_engine_run(name, run, SERVE_REQUESTS, SERVE_STEPS, cfg.vocab_size)
    row = latency_line(name, run)
    stats, pool = run["stats"], run["pool"]
    ps = stats["pool"]
    log(f"{name}: occupancy {stats['occupancy']:.2f}, prefills "
        f"{stats['prefills']}, prefix_hits {stats['prefix_hits']}; pool: "
        f"{ps['pages_live']}/{ps['pages_total']} pages live (peak "
        f"{ps['peak_pages']}), shared={ps['pages_shared']}, cow={ps['cow']},"
        f" fragmentation={ps['fragmentation']:.2f}")
    check(stats["prefix_hits"] > 0, f"{name}: no prefix hit")
    prefill_fn, step_fn = paged_model(run["weights"])
    reference = {}
    for p in run["prompts"]:
        key = tuple(p)
        if key not in reference:
            reference[key] = contiguous_tokens(prefill_fn, step_fn, p,
                                               SERVE_STEPS)
    same = sum([int(t) for t in r.tokens] == reference[tuple(p)]
               for p, r in zip(run["prompts"], run["results"]))
    log(f"{name}: {same} of {SERVE_REQUESTS} requests give the tokens of "
        "the same step function over contiguous caches")
    check(same == SERVE_REQUESTS, f"{name}: paged tokens differ from the "
          "contiguous run's")
    pool.evict_prefixes()
    live = pool.stats()["pages_live"]
    log(f"{name}: after stop and evict_prefixes: pages_live {live}; "
        f"registry transfers {run['memref_after']['transfers']} (before "
        f"{run['memref_before']['transfers']}), spills "
        f"{run['memref_after']['spills']} (before "
        f"{run['memref_before']['spills']})")
    check(live == 0, f"{name}: {live} pages live after evict_prefixes")
    check(registry.page_stats(dev)["pages_live"] == 0,
          f"{name}: the registry still sees live pages")
    row.update(prefix_hits=stats["prefix_hits"], cow=ps["cow"],
               occupancy=stats["occupancy"], peak_pages=ps["peak_pages"],
               equal_to_contiguous=same)
    return row


# -- the network layer and the serve mesh -----------------------------------------
def wire_phase(run_phase, dev) -> dict:
    """Two nodes of this process on ``dev``: a DeviceRef of WIRE_N f32
    values to a remote ``stage_square`` and back, raw and int8-compressed
    (spills and unspills counted on the process's one registry: one of
    each per hop per side), the int8 codec on the card against the same
    codec on the CPU, and a bf16 leaf and ref through the wire."""
    from repro_torch.core import (ActorSystem, DeviceRef, memory_stats,
                                  reset_transfer_stats)
    from repro_torch.dist.collectives import dequantize_ref, quantize_ref
    from repro_torch.net import NodeRuntime, wire
    from repro_torch.net.demo import stage_square

    def codec_cpu(x):
        q, s = quantize_ref(x)
        return dequantize_ref(q, s).array

    out = {}
    sa, sb = ActorSystem("wire-a", device=dev), ActorSystem("wire-b",
                                                            device=dev)
    na = NodeRuntime(sa, name="a", listen=("127.0.0.1", 0))
    nb = NodeRuntime(sb, name="b")
    try:
        nb.connect(na.address)
        check(na.wait_for_peer("b", 60), "wire: node b never connected")
        check(na.unspill_device == dev == nb.unspill_device,
              f"wire: nodes land refs on {na.unspill_device}, not {dev}")
        nb.publish("sq", sb.spawn(stage_square))
        nb.publish("echo", sb.spawn(lambda v: v))
        remote = na.remote_actor("b", "sq", timeout=60)
        gen = torch.Generator(device=dev).manual_seed(7)
        x = torch.randn(WIRE_N, generator=gen, device=dev)
        for compress in (False, True):
            na.compress = nb.compress = compress
            tag = "int8" if compress else "raw"
            remote.ask(DeviceRef(x.clone()), timeout=60)     # warm up
            ref = DeviceRef(x.clone())
            reset_transfer_stats()
            got = run_phase(f"wire hop {tag} f32 2^22", [],
                            lambda: remote.ask(ref, timeout=60))
            stats = memory_stats()
            check(stats["spills"] == 2 and stats["unspills"] == 2,
                  f"wire {tag}: {stats['spills']} spills, "
                  f"{stats['unspills']} unspills in one round trip, not 2")
            t0 = time.perf_counter()
            for _ in range(5):
                remote.ask(ref, timeout=60).block_until_ready()
            hop_ms = (time.perf_counter() - t0) / 5 * 1e3
            check(got.device == dev and not ref.is_spilled,
                  f"wire {tag}: the reply landed on {got.device}")
            if compress:
                # the codec on the card, bit for bit the codec on the CPU:
                # the request hop's codec, the stage, the reply hop's codec
                want = codec_cpu(codec_cpu(x.cpu()).square())
                q_gpu, s_gpu = quantize_ref(x)
                q_cpu, s_cpu = quantize_ref(x.cpu())
                check(s_gpu == s_cpu and torch.equal(q_gpu.array.cpu(),
                                                     q_cpu.array),
                      "wire: the int8 codec on the card differs from the CPU")
            else:
                want = (x * x).cpu()
            same = torch.equal(got.array.cpu(), want)
            check(same, f"wire {tag}: the round trip differs from "
                  "the same computation on the CPU")
            nbytes = wire.encoded_size((DeviceRef(x),), compress=compress)
            out[tag] = dict(round_trip_ms=hop_ms, request_wire_bytes=nbytes,
                            spills=stats["spills"],
                            unspills=stats["unspills"], bit_exact=same)
            log(f"wire {tag}: a round trip of {WIRE_N} f32 values to a "
                f"remote stage_square {hop_ms:.3f} ms (mean of 5), "
                f"{nbytes} wire bytes a request, spills/unspills "
                f"{stats['spills']}/{stats['unspills']}, bit-exact against "
                "the CPU")
        na.compress = nb.compress = False
        echo = na.remote_actor("b", "echo", timeout=60)
        xb = x[:4096].bfloat16()
        leaf, bref = echo.ask((xb, DeviceRef(xb.clone())), timeout=60)
        check(leaf.dtype == torch.bfloat16 and torch.equal(leaf, xb.cpu()),
              "wire: a bf16 tensor leaf did not come back as the same bf16")
        check(bref.dtype == torch.bfloat16 and bref.device == dev and
              torch.equal(bref.array, xb),
              "wire: a bf16 DeviceRef did not come back as bf16 on the card")
        log("wire: a bf16 leaf comes back a CPU bf16 tensor, a bf16 ref a "
            "bf16 ref on the card, bit for bit")
    finally:
        na.shutdown()
        nb.shutdown()
        sa.shutdown()
        sb.shutdown()
    return out


def percentile(sorted_ms, q):
    return sorted_ms[min(len(sorted_ms) - 1,
                         int(round(q / 100 * (len(sorted_ms) - 1))))]


def mesh_local_phase(run_phase, cfg, dev) -> dict:
    """A MeshRouter over MESH_REPLICAS EngineReplicas of qwen3-1.7b in bf16
    (all 28 layers, random weights from seed 0, as the serve phases) in
    this process: MESH_REQUESTS x MESH_STEPS greedy tokens, half of them
    under MESH_SESSIONS session keys. Each request's tokens are held to
    its own prompt by one prefill forward of the same weights (see
    MESH_MARGIN)."""
    from repro_torch.core import ActorSystem
    from repro_torch.core.memref import registry
    from repro_torch.launch.serve_mesh import model_engine
    from repro_torch.models import Model
    from repro_torch.serve import MeshRouter, ReplicaSpec

    vocab = cfg.vocab_size

    spec = ReplicaSpec(model_engine, arch="qwen3-1.7b", dtype="bfloat16",
                       seed=0, max_batch=MESH_BATCH, steps=MESH_STEPS)
    rng = np.random.default_rng(11)
    prompts = [int(t) for t in rng.integers(0, vocab, MESH_REQUESTS)]
    sessions = [f"session-{i // 2 % MESH_SESSIONS}" if i % 2 else None
                for i in range(MESH_REQUESTS)]
    name = (f"mesh qwen3-1.7b bf16 {MESH_REPLICAS} replicas "
            f"{MESH_REQUESTS}x{MESH_STEPS}")
    with ActorSystem("mesh", device=dev) as system:
        router = MeshRouter(system, None, spec=spec,
                            min_replicas=MESH_REPLICAS,
                            max_replicas=MESH_REPLICAS)
        reps = [router.spawn_replica() for _ in range(MESH_REPLICAS)]
        with router:
            for rep in reps:        # build each engine, pay its first step
                rep.ref.ask("serve", 0, 2, 0, None, timeout=600)

            def engine_steps():
                return {rep.key: rep.ref.ask("stats", timeout=60)["steps"]
                        for rep in reps}

            before, steps0 = registry.stats(), engine_steps()

            def body():
                t0 = time.perf_counter()
                futs = [router.submit(p, max_new_tokens=MESH_STEPS,
                                      session=sess)
                        for p, sess in zip(prompts, sessions)]
                results = [f.result(600) for f in futs]
                return futs, results, time.perf_counter() - t0

            futs, results, wall = run_phase(name, [], body)
            after, s = registry.stats(), router.stats()
            steps = {k: v - steps0[k] for k, v in engine_steps().items()}
        router.shutdown(drain=True)
    check(all(f.done() and not f.cancelled() for f in futs),
          f"{name}: a future is unresolved")
    for i, r in enumerate(results):
        check(len(r.tokens) == MESH_STEPS and
              all(0 <= int(t) < vocab for t in r.tokens),
              f"{name}: request {i} gave {len(r.tokens)} tokens or one out "
              "of the vocabulary")
    check(s["completed"] == MESH_REQUESTS and s["failed"] == 0 and
          s["shed"] == 0 and s["submitted"] == MESH_REQUESTS,
          f"{name}: router counters {s}")
    keyed = sum(sess is not None for sess in sessions)
    check(s["prefix_routed"] == keyed,
          f"{name}: prefix_routed {s['prefix_routed']}, not {keyed}")
    served = collections.Counter(f.replica for f in futs)
    check(len(served) == MESH_REPLICAS, f"{name}: replicas served {served}")
    by_session = collections.defaultdict(set)
    for f, sess in zip(futs, sessions):
        if sess is not None:
            by_session[sess].add(f.replica)
    check(all(len(v) == 1 for v in by_session.values()),
          f"{name}: a session spread over replicas: {dict(by_session)}")
    for key in ("transfers", "spills"):
        check(after[key] == before[key],
              f"{name}: the registry's {key} grew during the run")
    # the replicas' weights, rebuilt from the seed: each request's prompt
    # and its tokens but the last, teacher-forced in one forward
    model = Model(cfg, attn_impl="kernel", device=dev)
    params = model.init(0)
    emitted = torch.tensor([[int(t) for t in r.tokens] for r in results],
                           device=dev)
    seq = torch.cat([torch.tensor(prompts, device=dev)[:, None],
                     emitted[:, :-1]], 1)
    logits = model.forward(params, {"tokens": seq})[0].float()
    margin = ((logits.amax(-1) - logits.gather(-1, emitted[..., None])[..., 0])
              / logits.abs().amax(-1))
    worst, top1 = float(margin.max()), float((margin == 0).float().mean())
    del model, params, logits
    log(f"{name}: each request's tokens against a prefill of its own "
        f"prompt: worst margin below the largest logit {worst} of max "
        f"|logit| (limit {MESH_MARGIN}), top-1 agreement {top1}")
    check(worst <= MESH_MARGIN, f"{name}: a request's token lies {worst} of "
          f"max |logit| below its prefill's largest logit (limit "
          f"{MESH_MARGIN}): tokens of another prompt")
    lat = sorted(r.latency_s * 1e3 for r in results)
    toks = MESH_REQUESTS * MESH_STEPS
    row = dict(requests=MESH_REQUESTS, tokens=toks, wall_s=wall,
               tok_per_s=toks / wall, p50_ms=percentile(lat, 50),
               p99_ms=percentile(lat, 99), served=dict(served),
               engine_steps=steps,
               step_wall_ms=wall * 1e3 / max(steps.values()),
               prefix_routed=s["prefix_routed"], worst_margin=worst,
               top1=top1,
               sessions={k: sorted(v) for k, v in by_session.items()})
    log(f"{name}: {toks} tokens in {wall:.3f} s: {row['tok_per_s']:.1f} "
        f"tok/s; latency p50 {row['p50_ms']:.1f} ms, p99 "
        f"{row['p99_ms']:.1f} ms; requests a replica {dict(served)}, "
        f"engine steps a replica {steps} ({row['step_wall_ms']:.1f} ms of "
        f"wall a step), prefix_routed {s['prefix_routed']}, each session "
        "on one replica")
    return row


def mesh_procs_phase(run_phase, dev) -> dict:
    """A driver and MESH_WORKERS worker processes (``run_worker``, started
    by ``spawn``, each binding its own cuda:0), one f32 qwen3-1.7b replica
    of batch 1 on each, offered MESH_KILL_LOAD times one engine's rate;
    one worker SIGKILLed while it holds a request in flight. Every
    request's tokens against one f32 engine of batch 1 in this process,
    which also times that rate; ``run_demo`` asserts the rate after the
    failure window reaches 0.8 of the rate before it."""
    from repro_torch.core import ActorSystem
    from repro_torch.launch.serve_mesh import model_engine, run_demo
    from repro_torch.serve import ReplicaSpec

    kw = dict(arch="qwen3-1.7b", dtype="float32", seed=0, max_batch=1,
              steps=MESH_KILL_STEPS)
    with ActorSystem("mesh-reference", device=dev) as system:
        with model_engine(system, **kw) as engine:
            engine.submit(0, max_new_tokens=MESH_KILL_STEPS).result(600)
            t0 = time.perf_counter()
            futs = [engine.submit(i, max_new_tokens=MESH_KILL_STEPS)
                    for i in range(MESH_KILL_REQUESTS)]
            reference = [[int(t) for t in f.result(600).tokens]
                         for f in futs]
            alone_rps = MESH_KILL_REQUESTS / (time.perf_counter() - t0)
        del engine
    torch.cuda.empty_cache()
    rps = MESH_KILL_LOAD * alone_rps
    log(f"mesh reference: one f32 engine of batch 1 served "
        f"{MESH_KILL_REQUESTS}x{MESH_KILL_STEPS} at {alone_rps:.3f} "
        f"requests/s; offering {rps:.3f} rps to the mesh")
    name = (f"mesh qwen3-1.7b f32 {MESH_WORKERS} worker processes "
            f"{MESH_KILL_REQUESTS}x{MESH_KILL_STEPS}, SIGKILL")
    summary = run_phase(name, [], lambda: run_demo(
        MESH_WORKERS, rps=rps, duration_s=MESH_KILL_REQUESTS / rps,
        recover_window_s=MESH_KILL_RECOVER / rps,
        max_new_tokens=MESH_KILL_STEPS, spec=ReplicaSpec(model_engine, **kw),
        expected=lambda i, n: reference[i], timeout=600.0, device=str(dev)))
    summary["alone_rps"] = alone_rps
    check(summary["lost"] == 0 and summary["replicas_lost"] == 1 and
          summary["completed"] == summary["submitted"] == MESH_KILL_REQUESTS,
          f"{name}: {summary}")
    check(set(summary["worker_devices"].values()) == {str(dev)},
          f"{name}: workers bound {summary['worker_devices']}")
    for w in summary["windows"]:
        log(f"{name}: window {w['window']} [{w['start_s']:.3f}, "
            f"{w['end_s']:.3f}) s: {w['completed']} completed, "
            f"{w['achieved_rps']:.3f} rps, p99 {w['p99_ms']:.1f} ms")
    log(f"{name}: killed at {summary['kill_at_s']:.3f} s, replayed "
        f"{summary['replayed']}, lost {summary['lost']}; every request "
        "gave the single f32 engine's tokens")
    return summary


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2

    import dataclasses

    from repro_torch.core import ActorSystem
    from repro_torch.core.memref import registry
    from repro_torch.examples.mandelbrot_offload import run as run_offload
    from repro_torch.indexing import (build_wah_index, build_wah_index_numpy,
                                      decode_wah_bitmap,
                                      wah_index_pipeline_actors)
    from repro_torch.kernels import (FLASH_ATTENTION, KERNELS, LOCAL_COMPACT,
                                     MANDELBROT, MATMUL, RADIX_PASS,
                                     WAH_INTERLEAVE, build_all, ops, ref)
    from repro_torch.kernels.build import device_sm_count
    from repro_torch.kernels.flash_attention import (F32_QUERY_TILES,
                                                     HEAD_DIMS,
                                                     f32_query_tile,
                                                     flash_attention,
                                                     kernel_info)
    from repro_torch.kernels.mandelbrot import mandelbrot as mandelbrot_kernel
    from repro_torch.kernels.matmul import kernel_info as matmul_kernel_info
    from repro_torch.kernels.matmul import matmul as matmul_kernel
    from repro_torch.models import Model
    from repro_torch.kernels.radix_sort import (OnesweepScratch,
                                                radix_histogram,
                                                radix_onesweep, radix_pass)
    from repro_torch.kernels.radix_sort import kernel_info as radix_kernel_info
    from repro_torch.kernels.stream_compact import local_compact
    from repro_torch.kernels.wah import wah_interleave

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    log(f"built {len(KERNELS)} kernels in {build_all(KERNELS):.2f} s")
    fa_info = []
    for d in HEAD_DIMS:
        info = kernel_info(d)
        log(f"flash_attention bf16 kernel, head dim {d}: {info['registers']} "
            f"registers a thread at launch, {info['spill_bytes']} spill "
            f"bytes, {info['smem_bytes']} bytes of shared memory a block; "
            f"P.V: {info['pv']}")
        fa_info.append(info)
        for tile in F32_QUERY_TILES:
            info = kernel_info(d, torch.float32, tile)
            log(f"flash_attention f32 kernel, head dim {d}, {tile}-row query "
                f"tile: {info['registers']} registers a thread, "
                f"{info['spill_bytes']} spill bytes, {info['smem_bytes']} "
                "bytes of shared memory a block")
            fa_info.append(info)
    for info in fa_info:
        check(info["spill_bytes"] == 0, f"flash_attention kernel {info} spills")
    mm_info = matmul_kernel_info()
    for info in mm_info:
        log(f"matmul kernel {info['kernel']}: {info['registers']} registers "
            f"a thread, {info['spill_bytes']} spill bytes, "
            f"{info['smem_bytes']} bytes of shared memory a block")
        check(info["spill_bytes"] == 0, f"matmul kernel {info['kernel']} "
              "spills")
    sass = {}
    for kern in (MATMUL, FLASH_ATTENTION):
        sass[kern.name] = {}
        for fn, counts in kern.sass_opcodes().items():
            sass[kern.name][fn] = {op: counts[op] for op in SASS_OPS}
            log(f"sass {kern.name} {fn}: {sass[kern.name][fn]}")
            tensor = counts["HGMMA"] > 0 and counts["UTMALDG"] > 0
            if "hgemm" in fn or "flash_attention_tc" in fn:
                check(tensor, f"{fn} has no HGMMA fed by UTMALDG")
            else:
                check(counts["FFMA"] > 0 and not (counts["HGMMA"] or
                                                  counts["HMMA"]),
                      f"{fn} is not FFMA-only math")

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    rows = {}

    # -- per-kernel phase: each kernel against its plain version ---------------
    a = torch.from_numpy(rng.random((MM_N, MM_N), np.float32)).to(dev)
    b = torch.from_numpy(rng.random((MM_N, MM_N), np.float32)).to(dev)
    mm = {}
    for x, y in ((a, b), (a.bfloat16(), b.bfloat16())):
        dt, tol = x.dtype, MM_TOL[x.dtype]
        got, want = matmul_kernel(x, y), ref.matmul(x, y)
        check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
              f"matmul {dt} kernel disagrees with the plain version beyond "
              f"{tol}")
        peak = F32_FLOPS if dt == torch.float32 else BF16_FLOPS
        mm[dt] = dict(
            max_abs_err=max_abs_err(got.float(), want.float()),
            ms=cuda_ms(lambda: matmul_kernel(x, y), 10),
            plain_ms=cuda_ms(lambda: ref.matmul(x, y), 10),
            bound_ms=max(bytes_ms(3 * MM_N * MM_N * x.element_size()),
                         ops_ms(2.0 * MM_N ** 3, peak)),
            library_ms=cuda_ms(lambda: torch.matmul(x, y), 10),
            host_us=host_us(lambda: matmul_kernel(x, y), 20),
            library_host_us=host_us(lambda: torch.matmul(x, y), 20))
        r = mm[dt]
        log(f"matmul {dt} {MM_N}^3: kernel {r['ms']:.4f} ms, torch.matmul "
            f"{r['library_ms']:.4f} ms ({r['ms'] / r['library_ms']:.2f}x), "
            f"bound {r['bound_ms']:.4f} ms; host {r['host_us']:.1f} us a "
            f"call, torch.matmul {r['library_host_us']:.1f} us; max_abs_err "
            f"{r['max_abs_err']} (tol {tol} rel+abs)")
        del got, want
    # ragged tiles in M, N and K; an operand 4 (2) bytes off 16
    edges = []
    gen = torch.Generator(device=dev).manual_seed(1)
    m_r, k_r, n_r = MM_RAGGED
    for dt in (torch.float32, torch.bfloat16):
        tol = MM_TOL[dt]
        flat = torch.rand(MM_N * MM_N + 1, generator=gen, device=dev).to(dt)
        for tag, x, y in (
                (f"{m_r}x{k_r}x{n_r}",
                 torch.rand(m_r, k_r, generator=gen, device=dev).to(dt),
                 torch.rand(k_r, n_r, generator=gen, device=dev).to(dt)),
                (f"{MM_N}^3, A one element off its allocation",
                 flat[1:].view(MM_N, MM_N), b.to(dt))):
            before = MATMUL.launches
            got, want = matmul_kernel(x, y), ref.matmul(x, y)
            torch.cuda.synchronize()
            check(MATMUL.launches == before + 1,
                  f"matmul {dt} {tag}: not one launch")
            check(torch.allclose(got.float(), want.float(), rtol=tol,
                                 atol=tol),
                  f"matmul {dt} {tag} disagrees beyond {tol}")
            edges.append(dict(dtype=str(dt), shape=tag,
                              max_abs_err=max_abs_err(got.float(),
                                                      want.float())))
            log(f"matmul {dt} {tag}: max_abs_err {edges[-1]['max_abs_err']} "
                f"(tol {tol} rel+abs)")
            del got, want
        del flat
    f32 = mm[torch.float32]
    rows["matmul"] = dict(
        kernel=MATMUL, max_abs_err=f32["max_abs_err"], ms=f32["ms"],
        plain_ms=f32["plain_ms"], bound_ms=f32["bound_ms"],
        bound_by="operations", library_ms=f32["library_ms"],
        library="torch.matmul f32 (TF32 off)", host_us=f32["host_us"],
        library_host_us=f32["library_host_us"],
        bf16=dict(mm[torch.bfloat16], bound_by="operations",
                  library="torch.matmul bf16"),
        edges=edges, instantiations=mm_info)
    del a, b, x, y

    # B3: radix_pass (the TPU kernel's contract, off the main path), then
    # the sort's radix_histogram and radix_onesweep
    keys = torch.from_numpy(
        rng.integers(0, WAH_CARD, WAH_N).astype(np.uint32)).to(dev)
    hist, rank = radix_pass(keys)
    hist_p, rank_p = ref.radix_pass(keys)
    check(torch.equal(hist, hist_p) and torch.equal(rank, rank_p),
          "radix_pass kernel disagrees with the plain version")
    rand_keys = ref.i64_to_u32(torch.from_numpy(
        rng.integers(0, 2 ** 32, WAH_N, dtype=np.int64)).to(dev))
    for shift in (0, 8, 16, 24):
        h1, r1 = radix_pass(rand_keys, shift=shift)
        h2, r2 = ref.radix_pass(rand_keys, shift=shift)
        check(torch.equal(h1, h2) and torch.equal(r1, r2),
              f"radix_pass kernel disagrees at shift {shift}")
    radix_pass_ms = cuda_ms(lambda: radix_pass(keys), 20)
    del hist, rank, hist_p, rank_p, h1, r1, h2, r2
    radix_info = radix_kernel_info()
    for info in radix_info:
        log(f"radix kernel {info['kernel']}: {info['registers']} registers a "
            f"thread, {info['spill_bytes']} spill bytes, {info['smem_bytes']} "
            "bytes of shared memory a block")
        check(info["spill_bytes"] == 0, f"{info['kernel']} spills")
    pos = torch.arange(WAH_N, dtype=torch.int32, device=dev)
    equal_keys = torch.full((WAH_N,), SORT_EQUAL_KEY, dtype=torch.int64,
                            device=dev)
    sort_err = 0.0
    for tag, k_in in (("random", rand_keys), (f"cardinality {WAH_CARD}", keys),
                      ("all equal", ref.i64_to_u32(equal_keys))):
        h = radix_histogram(k_in)
        h_p = ref.radix_histogram(k_in, 8)
        sort_err = max(sort_err, max_abs_err(h, h_p))
        check(torch.equal(h, h_p),
              f"radix_histogram disagrees with the plain version ({tag})")
        for p in range(4):
            got = radix_onesweep(k_in, pos, h[p], 8, 8 * p)
            want = ref.radix_onesweep(k_in, pos, h[p], 8, 8 * p)
            sort_err = max(sort_err, max_abs_err(got[0], want[0]),
                           max_abs_err(got[1], want[1]))
            check(words_equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                  f"radix_onesweep disagrees with the plain version ({tag}, "
                  f"shift {8 * p})")
        log(f"radix_histogram and radix_onesweep n=2^24 {tag} keys: bit-exact "
            "at shifts 0, 8, 16, 24")
        del got, want
    sorted_k, perm = ops.radix_sort(rand_keys, pos)
    wide_keys = ref.u32_to_i64(rand_keys)
    narrow_keys = rand_keys.view(torch.int32)
    lib_k, lib_perm = torch.sort(wide_keys, stable=True)
    check(torch.equal(ref.u32_to_i64(sorted_k), lib_k)
          and torch.equal(perm.long(), lib_perm),
          "ops.radix_sort disagrees with torch.sort(stable=True)")
    del sorted_k, perm, lib_k, lib_perm
    hist = radix_histogram(rand_keys)
    wah_hist = radix_histogram(keys)

    def onesweep_ms(k_in, counts, shift, reps):
        """One onesweep pass, each call on scratch zeroed beforehand."""
        scratch = OnesweepScratch(WAH_N, 8, dev, passes=reps + 2)
        return cuda_ms(lambda: radix_onesweep(k_in, pos, counts, 8, shift,
                                              scratch=scratch), reps)

    rows["radix_pass"] = dict(
        kernel=RADIX_PASS, max_abs_err=sort_err,
        ms=onesweep_ms(rand_keys, hist[0], 0, 20),
        plain_ms=cuda_ms(lambda: ref.radix_onesweep(rand_keys, pos, hist[0],
                                                    8, 0), 3),
        bound_ms=bytes_ms(WAH_N * 16), bound_by="bytes",
        library_ms=cuda_ms(lambda: torch.sort(wide_keys, stable=True), 10),
        library="torch.sort(stable=True) of the keys as int64 (values and "
                "permutation), against radix_sort_ms",
        onesweep_one_digit_ms=onesweep_ms(keys, wah_hist[1], 8, 20),
        histogram_ms=cuda_ms(lambda: radix_histogram(rand_keys), 20),
        histogram_plain_ms=cuda_ms(lambda: ref.radix_histogram(rand_keys, 8),
                                   3),
        histogram_bound_ms=bytes_ms(WAH_N * 4),
        radix_sort_ms=cuda_ms(lambda: ops.radix_sort(rand_keys, pos), 10),
        radix_sort_plain_ms=cuda_ms(lambda: ops.radix_sort(
            rand_keys, pos, impl="ref"), 3),
        # the sort's own bytes (keys and payload in and out), and the bytes
        # of this design: the histogram's read and 4 passes of 16 B a key
        # (the int32 payload rides through the passes)
        radix_sort_bound_ms=bytes_ms(WAH_N * 16),
        radix_sort_design_bound_ms=bytes_ms(WAH_N * (4 + 4 * 16)),
        library_int32_ms=cuda_ms(lambda: torch.sort(narrow_keys, stable=True),
                                 10),
        host_us=host_us(lambda: ops.radix_sort(rand_keys, pos), 10),
        library_host_us=host_us(lambda: torch.sort(wide_keys, stable=True),
                                10),
        radix_pass_ms=radix_pass_ms, instantiations=radix_info)
    r = rows["radix_pass"]
    r["onesweep_ms"] = r["ms"]
    log(f"radix sort n=2^24: onesweep pass {r['ms']:.4f} ms (one-digit pass "
        f"{r['onesweep_one_digit_ms']:.4f}; bound {r['bound_ms']:.4f}), "
        f"histogram {r['histogram_ms']:.4f} ms (bound "
        f"{r['histogram_bound_ms']:.4f}), ops.radix_sort "
        f"{r['radix_sort_ms']:.4f} ms (bound {r['radix_sort_bound_ms']:.4f}, "
        f"this design's {r['radix_sort_design_bound_ms']:.4f}); torch.sort "
        f"int64 {r['library_ms']:.4f} ms, int32 {r['library_int32_ms']:.4f} "
        f"ms; host {r['host_us']:.1f} us a sort, torch.sort "
        f"{r['library_host_us']:.1f} us; radix_pass {radix_pass_ms:.4f} ms")
    del wide_keys, narrow_keys, equal_keys, hist, wah_hist, h, h_p

    words = torch.where(torch.from_numpy(rng.random(2 * WAH_N) < 0.5).to(dev),
                        torch.cat([rand_keys, rand_keys]).view(torch.int32),
                        0).view(torch.uint32)
    for drop in (0, 7):
        bl, cn = local_compact(words, drop_value=drop)
        bl_p, cn_p = ref.local_compact(words, drop_value=drop)
        check(words_equal(bl, bl_p) and torch.equal(cn, cn_p),
              f"local_compact kernel disagrees (drop_value={drop})")
    comp, total = ops.stream_compact(words)
    comp_p, total_p = ref.stream_compact(words)
    check(words_equal(comp, comp_p) and int(total) == int(total_p),
          "ops.stream_compact disagrees with the plain compaction")
    n2 = 2 * WAH_N
    rows["local_compact"] = dict(
        kernel=LOCAL_COMPACT, max_abs_err=max_abs_err(bl, bl_p),
        ms=cuda_ms(lambda: local_compact(words), 20),
        plain_ms=cuda_ms(lambda: ref.local_compact(words), 3),
        bound_ms=bytes_ms(n2 * 4 + n2 * 4 + (n2 // 256) * 4),
        bound_by="bytes",
        library_ms=cuda_ms(lambda: words.view(torch.int32)[words.view(torch.int32) != 0], 10),
        library="x[x != 0]")
    log(f"local_compact n=2^25: bit-exact for drop_value 0 and 7")
    del bl, cn, bl_p, cn_p, comp, comp_p

    lits = torch.cat([rand_keys[1:], rand_keys[:1]])
    out_i = wah_interleave(rand_keys, lits)
    out_p = ref.wah_interleave(rand_keys, lits)
    check(words_equal(out_i, out_p), "wah_interleave kernel disagrees")
    f32v, l32v = rand_keys.view(torch.int32), lits.view(torch.int32)
    rows["wah_interleave"] = dict(
        kernel=WAH_INTERLEAVE, max_abs_err=max_abs_err(out_i, out_p),
        ms=cuda_ms(lambda: wah_interleave(rand_keys, lits), 20),
        plain_ms=cuda_ms(lambda: ref.wah_interleave(rand_keys, lits), 20),
        bound_ms=bytes_ms(WAH_N * 4 * 2 + WAH_N * 8),
        bound_by="bytes",
        library_ms=cuda_ms(lambda: torch.stack((f32v, l32v), 1).reshape(-1), 20),
        library="torch.stack((f, l), 1).reshape(-1)")
    log("wah_interleave n=2^24: bit-exact")
    del words, out_i, out_p, lits, rand_keys, keys, pos
    torch.cuda.empty_cache()

    view = ref.mandelbrot_view(MANDEL_W, MANDEL_H, **MANDEL_VIEW)
    frame_kw = dict(width=MANDEL_W, max_iter=MANDEL_IT, view=view, device=dev)
    counts = mandelbrot_kernel(height=MANDEL_H, **frame_kw)
    counts_p = ops.mandelbrot(height=MANDEL_H, width=MANDEL_W,
                              max_iter=MANDEL_IT, device=dev, impl="ref",
                              **MANDEL_VIEW)
    check(torch.equal(counts, counts_p),
          "mandelbrot kernel differs from the plain version at 1920x1080")
    half = MANDEL_H // 2
    halves = torch.cat([mandelbrot_kernel(height=half, row_offset=0,
                                          **frame_kw),
                        mandelbrot_kernel(height=MANDEL_H - half,
                                          row_offset=half, **frame_kw)])
    check(torch.equal(halves, counts_p),
          "mandelbrot top and bottom halves do not stack to the frame")
    # the work this frame needs: every pixel's alive iterations plus the
    # final escape test of the pixels that escape
    iters = int(counts.sum()) + int((counts < MANDEL_IT).sum())
    rows["mandelbrot"] = dict(
        kernel=MANDELBROT, max_abs_err=max_abs_err(counts, counts_p),
        ms=cuda_ms(lambda: mandelbrot_kernel(height=MANDEL_H, **frame_kw), 20),
        plain_ms=cuda_ms(lambda: ops.mandelbrot(
            height=MANDEL_H, width=MANDEL_W, max_iter=MANDEL_IT, device=dev,
            impl="ref", **MANDEL_VIEW), 2, warmup=1),
        bound_ms=max(bytes_ms(MANDEL_W * MANDEL_H * 4),
                     ops_ms(MANDEL_OPS * iters, F32_NON_FMA_OPS)),
        bound_by="operations", library_ms=None,
        library="none: no one PyTorch call computes escape counts")
    log(f"mandelbrot {MANDEL_W}x{MANDEL_H} max_iter {MANDEL_IT}: bit-exact, "
        f"halves stack; {iters} iterations ({iters / counts.numel():.1f} a "
        "pixel)")
    del counts, counts_p, halves

    fa_rng = torch.Generator(device=dev).manual_seed(0)

    def qkv(*shape_dtype):
        return attention_inputs(shape_dtype[:6], shape_dtype[6], fa_rng, dev)

    fa_err = {}
    for tag, shape, dtype, window, rtol, atol in (
            (f"bf16 causal S={FA_S}", FA_LAYER,
             torch.bfloat16, None, 0.0, FA_BF16_ATOL),
            (f"f32 causal S={FA_S}", FA_LAYER,
             torch.float32, None, FA_F32_TOL, FA_F32_TOL),
            ("f32 window 256 S=1024", (FA_B, FA_H, FA_HKV, 1024, 1024, FA_D),
             torch.float32, 256, FA_F32_TOL, FA_F32_TOL)):
        q, k, v = qkv(*shape, dtype)
        got = flash_attention(q, k, v, causal=True, window=window).float()
        want = ref.flash_attention(q, k, v, causal=True, window=window).float()
        fa_err[tag] = max_abs_err(got, want)
        rms = float(want.square().mean().sqrt())
        check(torch.allclose(got, want, rtol=rtol, atol=atol),
              f"flash_attention {tag} disagrees with the plain version "
              f"beyond rtol {rtol}, atol {atol}")
        log(f"flash_attention {tag}: max_abs_err {fa_err[tag]} (rtol {rtol}, "
            f"atol {atol}); RMS of the plain output {rms}, max |plain| "
            f"{float(want.abs().max())}")
        del got, want

    def fa_bound_ms(q, k, v):
        """Causal attention's least time: 4·B·H·Sq·Skv·D / 2 operations at
        the peak of q's dtype (bf16: the tensor cores; f32: the SIMT FMA
        pipes) against each input read and the output written once."""
        b, h, s, d = q.shape
        peak = F32_FLOPS if q.dtype == torch.float32 else BF16_FLOPS
        return max(bytes_ms(q.element_size() * (2 * q.numel() + k.numel() +
                                                v.numel())),
                   ops_ms(4.0 * b * h * s * s * d / 2, peak))

    def sdpa(q, k, v):
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)

    q, k, v = qkv(*FA_LAYER, torch.bfloat16)
    rows["flash_attention"] = dict(
        kernel=FLASH_ATTENTION, max_abs_err=fa_err[f"bf16 causal S={FA_S}"],
        ms=cuda_ms(lambda: flash_attention(q, k, v, causal=True), 10),
        plain_ms=cuda_ms(lambda: ref.flash_attention(q, k, v, causal=True),
                         3),
        bound_ms=fa_bound_ms(q, k, v), bound_by="operations",
        library_ms=cuda_ms(lambda: sdpa(q, k, v), 10),
        library="F.scaled_dot_product_attention(is_causal=True, "
                "enable_gqa=True), bf16", instantiations=fa_info)
    # bf16 at both shapes over several seeds, in bf16 steps: the layer
    # shape and the prefill's own launch, PREFILL_B x 16 (8 KV) heads x
    # PREFILL_S^2 x 128, causal
    sweep = []
    for shape in (FA_LAYER, FA_PREFILL):
        for seed in FA_BF16_SEEDS:
            q, k, v = attention_inputs(
                shape, torch.bfloat16,
                torch.Generator(device=dev).manual_seed(seed), dev)
            got = flash_attention(q, k, v, causal=True)
            want = ref.flash_attention(q, k, v, causal=True)
            steps = bf16_steps(got, want)
            reading = dict(shape=list(shape), seed=seed,
                           max_abs_err=max_abs_err(got.float(), want.float()),
                           max_steps=float(steps.max()),
                           share_differ=float((steps > 0).float().mean()),
                           share_over_limit=float(
                               (steps > FA_BF16_STEPS).float().mean()),
                           max_abs_plain=float(want.float().abs().max()))
            sweep.append(reading)
            log(f"flash_attention bf16 causal {shape} seed {seed}: "
                f"max_abs_err {reading['max_abs_err']}, "
                f"{reading['max_steps']} bf16 steps at most (limit "
                f"{FA_BF16_STEPS}), share of elements that differ "
                f"{reading['share_differ']}, beyond the limit "
                f"{reading['share_over_limit']}; max |plain| "
                f"{reading['max_abs_plain']}")
            check(reading["max_steps"] <= FA_BF16_STEPS,
                  f"flash_attention bf16 {shape} seed {seed}: "
                  f"{reading['max_steps']} bf16 steps from the plain "
                  f"version > {FA_BF16_STEPS}")
            del q, k, v, got, want, steps
    rows["flash_attention"]["bf16_sweep"] = sweep
    torch.cuda.empty_cache()

    q, k, v = attention_inputs(
        FA_PREFILL, torch.bfloat16, torch.Generator(device=dev).manual_seed(0),
        dev)
    prefill_shape = dict(
        shape=list(FA_PREFILL),
        max_abs_err=sweep[len(FA_BF16_SEEDS)]["max_abs_err"],
        ms=cuda_ms(lambda: flash_attention(q, k, v, causal=True), 20),
        plain_ms=cuda_ms(lambda: ref.flash_attention(q, k, v, causal=True),
                         3),
        bound_ms=fa_bound_ms(q, k, v),
        library_ms=cuda_ms(lambda: sdpa(q, k, v), 20),
        host_us=host_us(lambda: flash_attention(q, k, v, causal=True), 20),
        library_host_us=host_us(lambda: sdpa(q, k, v), 20))
    rows["flash_attention"]["prefill_shape"] = prefill_shape
    for tag, r in ((f"{FA_B}x{FA_H}({FA_HKV})x{FA_S}^2x{FA_D}",
                    rows["flash_attention"]),
                   (f"{PREFILL_B}x{FA_H}({FA_HKV})x{PREFILL_S}^2x{FA_D}",
                    prefill_shape)):
        log(f"flash_attention bf16 causal {tag}: kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms "
            f"({r['ms'] / r['library_ms']:.2f}x), bound {r['bound_ms']:.4f} "
            "ms")
    log(f"flash_attention bf16: {prefill_shape['host_us']:.1f} us of host "
        "work a call (wrapper, custom op, tensor maps, launch); SDPA "
        f"{prefill_shape['library_host_us']:.1f} us")
    # the f32 (SIMT) kernel at the layer shape and at the f32 prefill's own
    # launch, against SDPA in f32 with TF32 off; its bound is the f32 SIMT
    # peak
    for key, shape, reps in (("f32", FA_LAYER, 5),
                             ("f32_prefill_shape", FA_PREFILL_F32, 20)):
        q, k, v = attention_inputs(
            shape, torch.float32, torch.Generator(device=dev).manual_seed(0),
            dev)
        got = flash_attention(q, k, v, causal=True)
        want = ref.flash_attention(q, k, v, causal=True)
        check(torch.allclose(got, want, rtol=FA_F32_TOL, atol=FA_F32_TOL),
              f"flash_attention f32 {shape} disagrees beyond {FA_F32_TOL}")
        r = dict(
            shape=list(shape), max_abs_err=max_abs_err(got, want),
            query_tile=f32_query_tile(shape[0], shape[1], shape[3],
                                      device_sm_count(dev.index)),
            ms=cuda_ms(lambda: flash_attention(q, k, v, causal=True), reps),
            plain_ms=cuda_ms(lambda: ref.flash_attention(q, k, v,
                                                         causal=True), 3),
            bound_ms=fa_bound_ms(q, k, v),
            library_ms=cuda_ms(lambda: sdpa(q, k, v), reps),
            library="F.scaled_dot_product_attention, f32 (TF32 off)",
            host_us=host_us(lambda: flash_attention(q, k, v, causal=True),
                            20),
            library_host_us=host_us(lambda: sdpa(q, k, v), 20))
        rows["flash_attention"][key] = r
        b_, h_, hkv_, s_, _, d_ = shape
        log(f"flash_attention f32 causal {b_}x{h_}({hkv_})x{s_}^2x{d_} "
            f"({r['query_tile']}-row tiles): kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms (f32 SIMT peak; "
            f"{r['bound_ms'] / r['ms']:.3f} of it reached); host "
            f"{r['host_us']:.1f} us a call, SDPA {r['library_host_us']:.1f};"
            f" max_abs_err {r['max_abs_err']} (tol {FA_F32_TOL})")
        del q, k, v, got, want
    torch.cuda.empty_cache()

    # -- main path --------------------------------------------------------------
    launches = {k.name: 0 for k in KERNELS}
    function_launches = {k.name: collections.Counter() for k in KERNELS}

    def run_phase(name, needs, body, functions=None):
        """Run ``body`` as one main-path phase: every kernel in ``needs``
        must launch, and each ``functions`` entry (exported function ->
        count) must launch exactly that often."""
        for k in KERNELS:
            k.reset_launches()
        t0 = time.perf_counter()
        result = body()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k.name: k.launches for k in KERNELS}
        by_fn = collections.Counter()
        for k in KERNELS:
            launches[k.name] += k.launches
            function_launches[k.name].update(k.function_launches)
            by_fn.update(k.function_launches)
        for kname in needs:
            check(counts[kname] > 0,
                  f"phase {name}: kernel {kname} was not launched")
        for fn, want in (functions or {}).items():
            check(by_fn[fn] == want, f"phase {name}: {fn} launched "
                  f"{by_fn[fn]} times, not {want}")
        log(f"phase {name}: wall {wall * 1e3:.3f} ms, launches {counts}")
        return result

    with ActorSystem(name="chip_smoke") as system:
        check(system.opencl_manager().find_device().torch_device == dev,
              "the default device is not cuda:0")
        for n, dt in ((QUICKSTART_N, torch.float32), (MM_N, torch.float32),
                      (MM_N, torch.bfloat16)):
            worker, m1, m2 = spawn_m_mult(system, n, rng, dt)
            worker.ask(m1, m2)      # first call: build and warm up
            result = run_phase(f"m_mult {n}x{n} {dt}", ["matmul"],
                               lambda: worker.ask(m1, m2))
            # bf16 results come back as f32 numpy arrays (numpy has no bf16)
            want = ref.matmul(torch.as_tensor(m1).to(dev),
                              torch.as_tensor(m2).to(dev)).float().cpu().numpy()
            check(result.shape == (n, n) and np.isfinite(result).all(),
                  "m_mult result is not finite or has the wrong shape")
            np.testing.assert_allclose(result, want, rtol=MM_TOL[dt],
                                       atol=MM_TOL[dt])
            log(f"m_mult {n}x{n} {dt} ok: |result|_F = "
                f"{np.linalg.norm(result):.1f}")

        values_np = wah_values(rng)
        values = torch.from_numpy(values_np).to(dev)
        build_wah_index(values, WAH_CARD)       # warm up
        idx = run_phase("build_wah_index n=2^24",
                        ["radix_pass", "wah_interleave", "local_compact"],
                        lambda: build_wah_index(values, WAH_CARD),
                        {"radix_histogram": 1, "radix_onesweep": 4,
                         "radix_pass": 0})
        idx_ref = build_wah_index(values, WAH_CARD, impl="ref")
        for got_t, want_t, what in zip(idx, idx_ref,
                                       ("words", "n_words", "starts", "counts")):
            check(words_equal(got_t, want_t),
                  f"build_wah_index {what} differs from impl='ref'")
        n_words = int(idx[1])
        words_np = idx[0][:n_words].cpu().numpy()
        starts_np, counts_np = idx[2].cpu().numpy(), idx[3].cpu().numpy()
        for v in (0, WAH_CARD // 2, WAH_CARD - 1):
            got_pos = decode_wah_bitmap(words_np, int(starts_np[v]),
                                        int(counts_np[v]))
            np.testing.assert_array_equal(got_pos, np.flatnonzero(values_np == v))
        log(f"build_wah_index n=2^24: {n_words} words, bit-exact against "
            "impl='ref', 3 bitmaps round-trip")
        small = values_np[:WAH_CHECK_N]
        s_words, s_n, s_starts, s_counts = build_wah_index(
            torch.from_numpy(small).to(dev), WAH_CARD)
        r_words, r_n, r_starts, r_counts = build_wah_index_numpy(small, WAH_CARD)
        check(int(s_n) == r_n, "n_words differs from the numpy builder")
        np.testing.assert_array_equal(s_counts.cpu().numpy(), r_counts)
        np.testing.assert_array_equal(s_starts.cpu().numpy(), r_starts)
        np.testing.assert_array_equal(s_words[:r_n].cpu().numpy(), r_words)
        log("build_wah_index n=2^17: word streams equal the numpy builder")
        del idx, idx_ref, values
        torch.cuda.empty_cache()

        fills, lits_np = pipeline_inputs(rng)
        f_t, l_t = torch.from_numpy(fills).to(dev), torch.from_numpy(lits_np).to(dev)
        plain_out, plain_n = ref.stream_compact(ref.wah_interleave(f_t, l_t))
        plain_out = plain_out.cpu().numpy()
        outs = {}
        for mode in ("staged", "fused"):
            pipe = wah_index_pipeline_actors(system, PIPE_K, mode=mode)
            pipe.ask(fills, lits_np)            # warm up
            before = registry.stats()
            out, total = run_phase(f"wah pipeline {mode} k=2^23",
                                   ["wah_interleave", "local_compact"],
                                   lambda: pipe.ask(fills, lits_np))
            after = registry.stats()
            check(after["readbacks"] - before["readbacks"] == 2,
                  f"{mode}: expected 2 read-backs (final outputs only), got "
                  f"{after['readbacks'] - before['readbacks']}")
            check(after["transfers"] == before["transfers"],
                  f"{mode}: a stage read its data back to the host")
            check(int(total) == int(plain_n), f"{mode}: survivor count differs")
            np.testing.assert_array_equal(out, plain_out)
            outs[mode] = out
            log(f"wah pipeline {mode}: {int(total)} words, equal to the plain "
                "compaction, no read-back between stages")
        np.testing.assert_array_equal(outs["staged"], outs["fused"])
        del outs, plain_out, f_t, l_t
        torch.cuda.empty_cache()

        frame = offload_frame()
        offload = run_phase(
            f"mandelbrot offload {MANDEL_W}x{MANDEL_H} max_iter {OFFLOAD_IT}",
            ["mandelbrot"],
            lambda: run_offload(system, frame, shares=OFFLOAD_SHARES,
                                chunks=OFFLOAD_CHUNKS))
        log("mandelbrot offload: every frame equals the all-card frame; "
            "wall s " + ", ".join(f"{k} {v:.3f}"
                                  for k, v in offload["walls"].items()))

        mapped, x_ref, w_map = map_over_graph(system, rng, dev)
        mapped.ask(x_ref)                     # warm up
        before = registry.stats()
        out = run_phase(f"map_over matmul {MAP_ROWS}x{MAP_K}", ["matmul"],
                        lambda: mapped.ask(x_ref))
        check(registry.stats()["transfers"] == before["transfers"],
              "map_over moved a chunk through the host")
        want = ops.matmul(x_ref.array, w_map).cpu().numpy()
        np.testing.assert_allclose(out, want, rtol=2e-5, atol=2e-5)
        log(f"map_over: equal to one ops.matmul within 2e-5 (max_abs_err "
            f"{float(np.abs(out - want).max())}), no host transfer")
        x_ref.release()
        del out, want, w_map
        torch.cuda.empty_cache()

    cfg, model, params, tokens = prefill_model(rng, dev)
    model.forward(params, {"tokens": tokens})          # warm up
    logits, _ = run_phase(
        f"qwen3-1.7b prefill {PREFILL_B}x{PREFILL_S} bf16", ["flash_attention"],
        lambda: model.forward(params, {"tokens": tokens}))
    check(FLASH_ATTENTION.launches == cfg.n_layers,
          f"prefill launched flash_attention {FLASH_ATTENTION.launches} "
          f"times, not once per layer ({cfg.n_layers})")
    forward_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        model.forward(params, {"tokens": tokens})
        torch.cuda.synchronize()
        forward_ms.append((time.perf_counter() - t0) * 1e3)
    forward_ms.sort()
    plain, _ = Model(cfg, attn_impl="ref", device=dev).forward(
        params, {"tokens": tokens})
    check(logits.shape == (PREFILL_B, PREFILL_S, cfg.vocab_size) and
          bool(torch.isfinite(logits).all()), "prefill logits not finite")
    last_err = max_abs_err(logits[:, -1].float(), plain[:, -1].float())
    top1_last = float((logits[:, -1].argmax(-1) ==
                       plain[:, -1].argmax(-1)).float().mean())
    top1_all = float((logits.argmax(-1) == plain.argmax(-1)).float().mean())
    scale = float(plain[:, -1].float().abs().max())
    # RMS of the difference over all positions, relative to the logits' RMS
    rms_rel = float((logits.float() - plain.float()).square().mean().sqrt() /
                    plain.float().square().mean().sqrt())
    log(f"qwen3-1.7b prefill bf16: warm forward median of 5 "
        f"{forward_ms[2]:.3f} ms (min {forward_ms[0]:.3f}, max "
        f"{forward_ms[-1]:.3f}); "
        f"last-position logits max_abs_err {last_err} (max |logit| "
        f"{scale}, ratio {last_err / scale}), relative RMS error over all "
        f"positions {rms_rel}, top-1 agreement last position {top1_last}, "
        f"all positions {top1_all}")
    check(top1_all >= PREFILL_TOP1, f"bf16 prefill: top-1 agreement "
          f"{top1_all} < {PREFILL_TOP1}")
    check(last_err <= PREFILL_BF16_TOL * scale, f"bf16 prefill: last-position "
          f"error {last_err} > {PREFILL_BF16_TOL} x {scale}")
    check(rms_rel <= PREFILL_BF16_RMS_TOL, f"bf16 prefill: relative RMS "
          f"error {rms_rel} > {PREFILL_BF16_RMS_TOL}")
    del logits, plain
    torch.cuda.empty_cache()

    # -- serving with the prefill's model and weights ----------------------------
    serve = {"card": card}
    serve["engine"] = serve_engine_phase(run_phase, model, params, dev)
    serve["decode_vs_prefill"] = decode_prefill_phase(run_phase, model,
                                                      params, tokens)
    del params, model
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    model32 = Model(cfg32, attn_impl="kernel", device=dev)
    params32 = model32.init(0)
    tokens32 = tokens[:1, :PREFILL_F32_S]
    model32.forward(params32, {"tokens": tokens32})    # warm up
    got32, _ = run_phase(
        f"qwen3-1.7b prefill 1x{PREFILL_F32_S} f32", ["flash_attention"],
        lambda: model32.forward(params32, {"tokens": tokens32}),
        {"flash_attention_f32": cfg.n_layers})
    want32, _ = Model(cfg32, attn_impl="ref", device=dev).forward(
        params32, {"tokens": tokens32})
    err32 = max_abs_err(got32, want32)
    scale32 = float(want32.abs().max())
    log(f"qwen3-1.7b prefill f32 1x{PREFILL_F32_S}: logits max_abs_err "
        f"{err32} (max |logit| {scale32}, tol {PREFILL_F32_TOL} x max)")
    check(err32 <= PREFILL_F32_TOL * scale32,
          "f32 prefill: kernel and plain attention disagree beyond "
          f"{PREFILL_F32_TOL} x max |logit|")
    del got32, want32
    serve["engine_vs_sync_f32"] = serve_f32_phase(run_phase, model32,
                                                  params32, rng)
    del params32, model32
    torch.cuda.empty_cache()
    serve["paged"] = serve_paged_phase(run_phase, cfg, dev)
    print(json.dumps({"serve": serve}), flush=True)

    # -- the network layer and the serve mesh -----------------------------------
    mesh = {"card": card, "wire": wire_phase(run_phase, dev)}
    mesh["local"] = mesh_local_phase(run_phase, cfg, dev)
    torch.cuda.empty_cache()
    mesh["processes"] = mesh_procs_phase(run_phase, dev)
    print(json.dumps({"mesh": mesh}, default=str), flush=True)

    entries = []
    for kname, row in rows.items():
        k = row.pop("kernel")
        check(launches[kname] > 0, f"kernel {kname} not launched on the main path")
        entry = {"name": kname, "route": "cuda",
                 "source": f"src/repro_torch/kernels/csrc/{k.source}",
                 "replaces": k.replaces, "launches": launches[kname],
                 "function_launches": dict(function_launches[kname]),
                 "card": card, **row}
        if kname in sass:
            entry["sass"] = sass[kname]
        entries.append(entry)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

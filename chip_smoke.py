"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written kernels of ``src/repro_torch/kernels/csrc`` with
``nvcc``, holds each against its plain PyTorch version on the card and
times it beside that plain version and one library call, then drives the
port's main path through the entry points a user calls:

* the ``m_mult`` kernel actor (paper Listings 1+2) at 4096x4096 f32 and
  at 4096x4096 bf16 (B1's ``wgmma`` kernel; the quickstart example drives
  it at 512x512 f32). B1 is also held at a ragged and a misaligned shape in both
  dtypes and timed in both beside ``torch.matmul`` (device time and host
  time a call);
* ``build_wah_index`` over 2**24 uint32 values of cardinality 64 (paper
  §4), bit-exact against ``impl="ref"`` on the card and decoded against
  ``np.flatnonzero`` (the wah_indexing example holds its 2**17 build to
  the CPU's);
* the Listing 5 ``wah_index_pipeline_actors`` at k = 2**23, staged and
  fused;
* the paper's §5.4 fractional offload of a 1920x1080 Mandelbrot frame
  (``repro_torch.examples.mandelbrot_offload``): a CPU worker and a card
  worker under ``split_offload`` at device shares 100/90/50 %, then
  ``ActorPool.map`` over 16 row chunks, every frame bit-exact against the
  all-card frame;
* ``Graph.map_over`` of a one-input matmul kernel over an 8192x4096 f32
  ``DeviceRef``, 4 chunks on 2 replicas, with no host transfer;
* the AdamW kernel (``kernels/adamw.py``) over qwen3-1.7b's full
  parameter tree (310 leaves, 1.72 B parameters, bf16 with f32 state):
  its leaf sums of squares within 1e-6 of ``torch.sum``, its update equal
  to the loop's bit for bit at the same scalars, three launches an
  ``adamw.update``, timed beside its bound, the loop and
  ``torch._fused_adamw_``;
* training at qwen3-1.7b's widths (``repro_torch.launch.train``,
  ``dist.step``, ``dist.fault``): a 2-layer f32 train step on the card
  against the same step on the CPU, and ``grad_accum`` 4 against the full
  batch; 12 steps of ``launch.train.run --full`` (all 28 layers, bf16
  parameters, f32 AdamW state, remat "full") at 8 x 512 tokens, then 10
  steps on one batch that must lower the loss, one of them profiled for
  the device time against the step's bound (every step one launch of
  each AdamW entry); ``RecoverableTrainer`` (a
  fault at step 3, the final state equal leaf for leaf to an unfaulted
  run's) and ``ElasticDPDriver`` (4 workers, one dying) in a child
  process under deterministic algorithms, at 1 layer with the
  vocabulary cut to 8192; and the llama3-8b prefill at full width (32
  layers, random bf16 weights from a seed, 1 x 2048 tokens) with the
  flash-attention kernel against the plain attention. No kernel runs in
  a gradient: B6 is forward only;
* the qwen3-1.7b prefill forward at full width (28 layers, random bf16
  weights from a seed, 2 x 2048 tokens) with the flash-attention kernel,
  against the same forward with the plain attention, and an f32 forward
  at 1 x 512 tokens (a phase of its own: 28 launches of B6's f32 kernel).
  B6's bf16 kernel is also timed against SDPA at the qwen3 and llama3-8b
  prefills' own launch shapes, and its registers, spills and shared memory are printed. B6's f32
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

* the five other model families at their published widths, random bf16
  weights from seed 0, each model freed before the next: phi-3.5-moe
  (moe, 16 of its 32 layers: all 32 take 83.7 GB), 1 x 2048 tokens;
  mamba2-130m (ssm), 4 x 2048 in bf16, 1 x 512 in f32 on the card against
  the CPU, 256 f32 decode steps against that prefill and 12 steps of
  ``launch.train.run --full`` at 8 x 2048; recurrentgemma-9b (hybrid),
  1 x 4096, past its 2048-token window; whisper-tiny (encdec), 8 x 1500
  frames and 448 decoder tokens, then ``launch.serve --arch whisper-tiny
  --full`` through the sync loop, 64 steps; qwen2-vl-2b (vlm), 2 x 2048
  with 256 vision embeddings at M-RoPE positions whose three streams
  differ. Each bf16 prefill goes through B6 (none for mamba2) and is held
  against the plain attention under the qwen3 prefill's gates, with its
  wall, profiled device time and idle share; 64 decode steps from an empty
  cache are held to the prefill's logits under the same gates. B6 is also
  checked and timed at head dim 256 (recurrentgemma-9b's layer launch,
  window 2048, bf16 and f32) against SDPA with the window as a mask, and
  at the families' other launch shapes.

* B6 at every head dim from 1 to 256, where the TPU kernel takes any:
  each launched once in bf16 and f32 at a small ragged GQA shape and held
  to the plain version (bf16 head dims off 8 elements through the copy to
  a 16-byte row pitch), and timed against SDPA at phi-2's layer launch
  (D = 80), phi-3-mini's (D = 96) and at D = 72 and 100, on the kernels
  built for the widths 96 and 128 they run on.

* the rest of the distribution layer: B6 at head dim 192
  (nemotron-4-340b's 1 x 96 (8 KV) x 2048^2 x 192 causal launch, bf16
  over seeds 0-2 and f32, against SDPA); nemotron-4-340b's prefill at 4 of
  its 96 layers at published widths (1 x 2048 bf16, 46.5 GB of weights),
  B6 at D = 192 against the plain attention, with its wall, profiled busy
  time, idle share and peak memory (under 80 GB); qwen3-1.7b's prefill
  split over 2 stage actors (``dist.pipeline``), 4 microbatches of 1 x
  2048 through a ``PipelineRunner`` of depth 2, each staged output held
  to ``model.forward`` of the same microbatch, 112 B6 launches, the
  activation crossing as a ``DeviceRef`` with no host transfer or spill,
  ``emit="ref"`` results on the card, and the staged wall beside four
  fused forwards; and ``compressed_psum`` of 2^24 f32 values over a
  one-rank nccl group, bit for bit its own dequantized payload (one card:
  a smoke only).

* the roofline (``repro_torch.roofline``, ``launch.dryrun_lib``):
  qwen3-1.7b at its published widths in bf16, the prefill at 2 x 2048 and
  the train step at 8 x 512, counted by ``lower_cell`` on a 1 x 1 mesh of
  ``meta`` DTensors in a spawned child and by the same counter over the
  same step on the card's tensors (plain attention): FLOPs, bytes and
  argument bytes must be equal. Each step's wall, profiled busy time,
  MFU against 989 TFLOP/s and peak memory are read beside the roofline's
  compute and memory times and its predicted peak of live bytes (the
  prefill timed with B6, the train step with the plain attention).

* the user examples (``repro_torch.examples``), each through its ``run``
  on the card: ``quickstart`` (Listings 1+2, B1 f32 at 512^3),
  ``wah_indexing`` at its 2**17 values (B3-B5; bit for bit its run on the
  CPU), ``graph_diamond`` (the typed diamond, one read-back, the build
  error's node path), ``serve_lm`` at qwen3-1.7b's published widths (bf16,
  8 requests x 32 greedy steps, tok/s; the example's step replayed
  outside the actor picks the same tokens: a check of the actor's
  wiring, as the decode step runs no hand-written kernel),
  ``train_lm`` at qwen3-1.7b's widths cut to 2 of its 28 layers (20 steps
  of 8 x 512, a fault at step 15, a checkpoint every 10: one recovery,
  the loss at batch 0 lower after), and ``dist_pipeline`` (two processes
  on the card: one spill pair a hop, exactly-once after the worker's
  death). B1 on the quickstart's matrices and B3-B5 at the 2**17 build's
  shapes are also held against their plain versions and timed beside
  them, by the helpers that time the kernels' main rows.

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
exits non-zero. The serve, mesh, train, family and distribution-layer
(``{"dist": ...}``), roofline and examples phases each print a JSON line
of their readings; the
run's total seconds follow, and the last two lines are a JSON object with
one entry per kernel and the JSON result line.

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

#: H100 SXM peaks (NVIDIA data sheet, dense), from the port's roofline:
#: HBM3 bytes/s, f32 FLOP/s outside the tensor cores, bf16 FLOP/s in the
#: tensor cores, device memory
from repro_torch.roofline.analysis import (  # noqa: E402
    CARD_BYTES, F32_FLOPS, HBM_BW as HBM_BYTES_PER_S,
    PEAK_FLOPS as BF16_FLOPS)
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
#: B6's bf16 shape at the llama3-8b prefill's own launch (LLAMA_B x 32 (8
#: KV) heads x LLAMA_S^2 x 128: a GQA group of 4, where qwen3-1.7b has 2)
LLAMA_B, LLAMA_S = 1, 2048
FA_LLAMA = (LLAMA_B, 32, 8, LLAMA_S, LLAMA_S, FA_D)
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
#: the train phases, at qwen3-1.7b's widths. Parity: 2 layers in f32
#: (TF32 off), batch TRAIN_PARITY_B x TRAIN_PARITY_S, one step on the card
#: against the same step on the CPU; grad_accum TRAIN_ACCUM against the
#: full batch on the card, at TRAIN_ACCUM rows (one a microbatch). Both are
#: IEEE f32 and differ in summation order: the loss within 1e-5, grad_norm
#: 1e-4, every gradient leaf rtol 1e-3 / atol 1e-5 (tests/test_training.py's
#: limits for accumulated against full-batch gradients)
TRAIN_PARITY_LAYERS, TRAIN_PARITY_B, TRAIN_PARITY_S = 2, 2, 64
TRAIN_ACCUM = 4
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL = 1e-5, 1e-4
TRAIN_GRAD_RTOL, TRAIN_GRAD_ATOL = 1e-3, 1e-5
#: full-width training through launch.train.run --full (bf16 parameters,
#: f32 AdamW state, remat "full"): TRAIN_STEPS steps of TRAIN_B x TRAIN_S;
#: the first loss within TRAIN_FIRST_LOSS_TOL of ln(vocab) (random
#: weights: the logits' spread adds about half their variance); then
#: TRAIN_REPEAT_STEPS steps on one batch at AdamWConfig's default lr must
#: lower the loss
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_REPEAT_STEPS = 8, 512, 12, 10
TRAIN_FIRST_LOSS_TOL = 0.15
#: the AdamW kernel at qwen3-1.7b's full parameter tree (bf16 parameters
#: and gradients, f32 state): its update equals the loop's to the bit for
#: the same scalars; its leaf sums of squares are torch.sum's within
#: ADAMW_SUM_RTOL (f64 sums against f32 ones, in another order)
ADAMW_SUM_RTOL = 1e-6
#: bytes a parameter: the update reads g, m, v, p (2 + 4 + 4 + 2) and
#: writes p, m, v (2 + 4 + 4); the norm reads g (2); 24 for the call
ADAMW_UPDATE_BYTES, ADAMW_NORM_BYTES = 22, 2
#: the AdamW kernel's launches in one train step, whatever the leaves
ADAMW_A_STEP = {"adamw_norm_chunks": 1, "adamw_norm_leaves": 1,
                "adamw_update": 1}
#: recovery and elastic DP, in a spawned child under deterministic
#: algorithms: qwen3-1.7b widths at 1 layer with the vocabulary cut to
#: RECOVERY_VOCAB (at 151936 a checkpoint of params, m and v writes about
#: 3.6 GB; at 8192 about 0.7 GB). RecoverableTrainer: RECOVERY_STEPS steps
#: of RECOVERY_B x RECOVERY_S in bf16, a checkpoint every 2, a fault at
#: step 3; ElasticDPDriver: ELASTIC_WORKERS workers on the card in f32,
#: worker 1 dies at step 1, ELASTIC_B rows, held as tests/test_fault.py
#: holds the JAX ElasticDPDriver (loss 1e-5, gradients 1e-4 / 1e-5)
RECOVERY_VOCAB, RECOVERY_B, RECOVERY_S = 8192, 4, 64
RECOVERY_STEPS, RECOVERY_FAIL_AT = 4, 3
ELASTIC_WORKERS, ELASTIC_B = 4, 8
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
#: the family phases, one published config each at its published widths,
#: random bf16 weights from seed 0, each freed before the next: phase ->
#: (arch, prefill batch, prefill tokens, B6 launches a forward). phi-3.5-moe
#: keeps FAMILY_MOE_LAYERS of its 32 layers: all 32 are 41.9 B parameters,
#: 83.7 GB in bf16, more than the card's 80 GB; 16 are about 42 GB.
#: recurrentgemma-9b's 4096 tokens make its 2048-token window bite;
#: whisper-tiny's batch is 8 x 1500 frames and its 448 decoder tokens
#: (B6: 4 encoder, 4 decoder self, 4 cross launches); qwen2-vl-2b's first
#: n_vision_tokens (256) inputs are vision embeddings at M-RoPE positions
#: whose three streams differ (time 0, the row and the column of a 16 x 16
#: grid), the text after them at 16, 17, ...
FAMILY_PHASES = {
    "moe": ("phi3.5-moe-42b-a6.6b", 1, 2048, 16),
    "ssm": ("mamba2-130m", 4, 2048, 0),
    "hybrid": ("recurrentgemma-9b", 1, 4096, 12),
    "encdec": ("whisper-tiny", 8, 448, 12),
    "vlm": ("qwen2-vl-2b", 2, 2048, 28),
}
FAMILY_MOE_LAYERS = 16
#: the MoE's unpinned check: kernel against plain attention in f32 at
#: FAMILY_MOE_F32_LAYERS layers (21 GB), where no token may pick another
#: expert and the logits must agree within PREFILL_F32_TOL of max |logit|
FAMILY_MOE_F32_LAYERS = 4
#: decode steps from an empty cache, teacher-forced with the prefill's own
#: inputs and held to its logits under the bf16 prefill gates
FAMILY_DECODE_STEPS = 64
#: mamba2-130m in f32: 1 x SSM_F32_S on the card against the CPU within
#: PREFILL_F32_TOL of max |logit|; SSM_DECODE_STEPS f32 decode steps
#: against that prefill, to the same limit; SSM_TRAIN_STEPS steps of
#: launch.train.run --full at SSM_TRAIN_B x SSM_TRAIN_S, the first loss
#: within TRAIN_FIRST_LOSS_TOL of ln(vocab)
SSM_F32_S, SSM_DECODE_STEPS = 512, 256
#: recurrentgemma-9b is chaotic in bf16 with random weights: its plain
#: prefill of one batch row against the same row in a batch of 2 (cuBLAS
#: tiles the products otherwise) differs by 0.056 of max |logit| at worst,
#: RMS 0.036, top-1 0.919 on the H100, at the prefill gates before any
#: kernel; a decode step's GEMVs and f32 softmax round otherwise again. So
#: its bf16 decode is a reading, and decode is held in f32 over all 38
#: layers (37.6 GB) to a 1 x HYBRID_F32_S prefill through B6's f32 kernel
#: at D = 256, within PREFILL_F32_TOL
HYBRID_F32_S = 512
SSM_TRAIN_STEPS, SSM_TRAIN_B, SSM_TRAIN_S = 12, 8, 2048
#: B6 at head dim 256: recurrentgemma-9b's layer launch, 1 x 16 (1 KV)
#: heads x 4096^2 x 256, causal, window 2048 (bf16; f32 on 64-row tiles)
FA_D256 = (1, 16, 1, 4096, 4096, 256)
FA_D256_WINDOW = 2048
#: B6 at head dim 192: nemotron-4-340b's layer launch, 1 x 96 (8 KV) heads
#: x 2048^2 x 192, causal (bf16 on key tiles of 64; f32 on 64-row tiles)
FA_D192 = (1, 96, 8, 2048, 2048, 192)
#: B6 at head dims that run on the widths 32, 96 and 160 or past a built
#: width: phi-2's layer launch (1 x 32 (32 KV) heads x 2048^2 x 80) and
#: phi-3-mini's (1 x 32 (32) x 4096^2 x 96), and 1 x 32 (8) x 2048^2 at
#: D = 72 (on width 96; rows of 144 bytes, read in place) and D = 100 (on
#: 128; bf16 rows of 200 bytes, off TMA's 16: copied to a 208-byte pitch);
#: causal, bf16 over FA_BF16_SEEDS and f32, each timed beside SDPA
FA_WIDTH_SHAPES = (("phi-2", (1, 32, 32, 2048, 2048, 80)),
                   ("phi-3-mini", (1, 32, 32, 4096, 4096, 96)),
                   ("D=72", (1, 32, 8, 2048, 2048, 72)),
                   ("D=100", (1, 32, 8, 2048, 2048, 100)))
#: every head dim from 1 to flash_attention.MAX_KERNEL_WIDTH, and each of
#: FA_ABOVE_D, launches B6 once in each dtype at this (B, H, Hkv, Sq,
#: Skv), causal, and is held to the plain version (f32 FA_F32_TOL, bf16
#: FA_BF16_STEPS)
FA_EVERY_D = (1, 4, 2, 67, 131)
#: head dims above the widest kernel, run in slabs (kernel_slabs): 257,
#: 272, 300, 320, 448, 640 on slabs of 160, 384 on 192, 500, 512 and
#: 1024 on 256, 896 on 128; above 512 bf16 streams Q through its ring
FA_ABOVE_D = (257, 272, 300, 320, 384, 448, 500, 512, 640, 896, 1024)
#: B6 in slabs at two causal launch shapes, each timed beside SDPA: 1 x 16
#: (4 KV) heads x 2048^2 x 512 (2 slabs of 256) and 1 x 32 (8) x 2048^2 x
#: 320 (2 of 160)
FA_SLAB_SHAPES = (("D=512", (1, 16, 4, 2048, 2048, 512)),
                  ("D=320", (1, 32, 8, 2048, 2048, 320)))
#: a head dim in slabs on the main path: qwen3-1.7b's published widths
#: with head_dim SLAB_PREFILL_D at SLAB_PREFILL_LAYERS of its 28 layers, a
#: 1 x PREFILL_S bf16 prefill (numpy seed 23), B6 once a layer
SLAB_PREFILL_LAYERS, SLAB_PREFILL_D = 2, 512
#: nemotron-4-340b's prefill at its published widths: NEMOTRON_LAYERS of its
#: 96 layers (3.45 B parameters a layer, 9.44 B of embedding and head: 23.2 B,
#: 46.5 GB in bf16; all 96 layers take 681 GB), 1 x NEMOTRON_S tokens, B6 at
#: D = 192 once a layer. Its peak must stay under the card's 80 GB
NEMOTRON_LAYERS, NEMOTRON_S = 4, 2048
CARD_GB = CARD_BYTES / 1e9
#: the pipeline phase: qwen3-1.7b's prefill weights in PIPE_STAGES stage
#: actors, PIPE_MICROBATCHES microbatches of 1 x PREFILL_S tokens (numpy
#: seed PIPE_SEED) through a PipelineRunner of depth PIPE_DEPTH, each held
#: to model.forward of the same microbatch
PIPE_STAGES, PIPE_DEPTH, PIPE_MICROBATCHES, PIPE_SEED = 2, 2, 4, 21
#: the collectives smoke: compressed_psum over a world of one (nccl) of
#: 2^COLL_LOG2 f32 values
COLL_LOG2 = 24
#: the families' other B6 launches: (tag, shape, causal)
FA_FAMILY_SHAPES = (
    ("phi-3.5-moe prefill", (1, 32, 8, 2048, 2048, 128), True),
    ("qwen2-vl-2b prefill", (2, 12, 2, 2048, 2048, 128), True),
    ("whisper-tiny encoder", (8, 6, 6, 1500, 1500, 64), False),
    ("whisper-tiny decoder self", (8, 6, 6, 448, 448, 64), True),
    ("whisper-tiny cross", (8, 6, 6, 448, 1500, 64), False),
)
#: the roofline phase: qwen3-1.7b at its published widths in bf16, the
#: prefill at PREFILL_B x PREFILL_S and the train step at TRAIN_B x TRAIN_S
#: (configs.SHAPES entries: seq, global batch, kind), counted by
#: launch.dryrun_lib.lower_cell on a 1 x 1 mesh of meta DTensors in a child
#: process and by the same counter over the same step on the card's
#: tensors, both with the plain attention the counter sees; the counts and
#: the argument bytes must be equal, exactly. ROOF_REPS timed steps a kind
ROOF_SHAPES = {"card_prefill": (PREFILL_S, PREFILL_B, "prefill"),
               "card_train": (TRAIN_S, TRAIN_B, "train")}
ROOF_PLAN = {"attn_impl": "ref"}
ROOF_REPS = 5
#: the examples phase (repro_torch.examples), each through its run() on
#: cuda:0: quickstart (B1 f32 at EXAMPLE_MM_N^3, held to the plain
#: product), wah_indexing at its default EXAMPLE_WAH_N values (B3-B5)
#: against run(device="cpu") bit for bit, graph_diamond, serve_lm at
#: qwen3-1.7b's published widths (bf16, the example's batch of 8 and 32
#: greedy steps from token 0; its step replayed outside the actor picks
#: the same tokens), train_lm at qwen3-1.7b's published widths cut to
#: EXAMPLE_TRAIN_LAYERS of its 28 layers (EXAMPLE_TRAIN_STEPS steps of
#: EXAMPLE_TRAIN_B x EXAMPLE_TRAIN_S, a fault at EXAMPLE_TRAIN_FAIL_AT; the
#: example checkpoints every 10 steps, so the restore replays steps 10-14;
#: at 151936 words a checkpoint of 2 layers' params, m and v is about 4
#: GB), and dist_pipeline (two processes on the card)
EXAMPLE_MM_N = 512
EXAMPLE_WAH_N = 1 << 17
EXAMPLE_TRAIN_LAYERS, EXAMPLE_TRAIN_B, EXAMPLE_TRAIN_S = 2, 8, 512
EXAMPLE_TRAIN_STEPS, EXAMPLE_TRAIN_FAIL_AT = 20, 15


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


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit-exact equality of two tensors of one 2- or 4-byte dtype."""
    word = torch.int16 if a.element_size() == 2 else torch.int32
    return (a.dtype == b.dtype and a.shape == b.shape and
            torch.equal(a.view(word), b.view(word)))


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


def attention_pairs(sq: int, skv: int, causal: bool,
                    window=None) -> int:
    """The (query, key) pairs that the masks leave, with right-aligned
    query positions: what attention's work counts."""
    pos = np.arange(sq, dtype=np.int64) + (skv - sq)
    hi = np.minimum(pos, skv - 1) if causal else np.full(sq, skv - 1)
    lo = np.maximum(pos - window + 1, 0) if window else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def attention_bound_ms(q, k, v, causal: bool, window=None) -> float:
    """Attention's least time: 4·D operations a (query, key) pair the
    masks leave, for every batch and head, at the peak of q's dtype
    (bf16: the tensor cores; f32: the SIMT FMA pipes), against each input
    read and the output written once."""
    b, h, sq, d = q.shape
    peak = F32_FLOPS if q.dtype == torch.float32 else BF16_FLOPS
    ops = 4.0 * b * h * d * attention_pairs(sq, k.shape[2], causal, window)
    return max(bytes_ms(q.element_size() * (2 * q.numel() + k.numel() +
                                            v.numel())),
               ops_ms(ops, peak))


def window_mask(sq: int, skv: int, causal: bool, window, dev):
    """[Sq, Skv] bool, true where a query may see a key (SDPA's
    ``attn_mask``)."""
    qpos = torch.arange(sq, device=dev)[:, None] + (skv - sq)
    kpos = torch.arange(skv, device=dev)[None, :]
    keep = torch.ones((sq, skv), dtype=torch.bool, device=dev)
    if causal:
        keep &= kpos <= qpos
    if window:
        keep &= kpos > qpos - window
    return keep


def prefill_gates(name: str, logits: torch.Tensor, plain: torch.Tensor
                  ) -> dict:
    """A bf16 prefill's logits with the flash-attention kernel against the
    same forward with the plain attention: finite, last-position
    max_abs_err within PREFILL_BF16_TOL of max |logit|, relative RMS within
    PREFILL_BF16_RMS_TOL, top-1 agreement at least PREFILL_TOP1."""
    check(logits.shape == plain.shape and bool(torch.isfinite(logits).all()),
          f"{name}: logits not finite or of the wrong shape")
    last_err = max_abs_err(logits[:, -1].float(), plain[:, -1].float())
    top1_last = float((logits[:, -1].argmax(-1) ==
                       plain[:, -1].argmax(-1)).float().mean())
    top1_all = float((logits.argmax(-1) == plain.argmax(-1)).float().mean())
    scale = float(plain[:, -1].float().abs().max())
    # RMS of the difference over all positions, relative to the logits' RMS
    rms_rel = float((logits.float() - plain.float()).square().mean().sqrt() /
                    plain.float().square().mean().sqrt())
    log(f"{name}: last-position logits max_abs_err {last_err} (max |logit| "
        f"{scale}, ratio {last_err / scale}), relative RMS error over all "
        f"positions {rms_rel}, top-1 agreement last position {top1_last}, "
        f"all positions {top1_all}")
    check(top1_all >= PREFILL_TOP1, f"{name}: top-1 agreement "
          f"{top1_all} < {PREFILL_TOP1}")
    check(last_err <= PREFILL_BF16_TOL * scale, f"{name}: last-position "
          f"error {last_err} > {PREFILL_BF16_TOL} x {scale}")
    check(rms_rel <= PREFILL_BF16_RMS_TOL, f"{name}: relative RMS "
          f"error {rms_rel} > {PREFILL_BF16_RMS_TOL}")
    return dict(max_err_ratio=last_err / scale, rms_rel=rms_rel,
                top1_last=top1_last, top1_all=top1_all)


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
    want = model.forward(params, {"tokens": tokens})[0][0]
    check(int(cache["len"]) == DECODE_S, f"{name}: cache length wrong")
    return step_gates(name, got, want)


def step_gates(name: str, got: torch.Tensor, want: torch.Tensor,
               tol: float = PREFILL_BF16_TOL, gate: bool = True) -> dict:
    """Decode steps' logits ``got`` against a prefill's at the same
    positions ``want`` (``[..., V]``): finite, every position's max_abs_err
    within ``tol`` of its max |logit|, relative RMS within
    PREFILL_BF16_RMS_TOL, top-1 agreement at least PREFILL_TOP1. With
    ``gate=False`` the readings are only logged and returned."""
    got, want = got.float(), want.float()
    check(got.shape == want.shape and bool(torch.isfinite(got).all()),
          f"{name}: logits not finite or of the wrong shape")
    err = (got - want).abs().amax(-1)
    scale = want.abs().amax(-1)
    ratio = float((err / scale).max())
    rms = float((got - want).square().mean().sqrt() /
                want.square().mean().sqrt())
    top1 = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    log(f"{name}: worst step max_abs_err / max |logit| {ratio} (limit "
        f"{tol}), relative RMS {rms} (limit {PREFILL_BF16_RMS_TOL}), top-1 "
        f"agreement {top1} (limit {PREFILL_TOP1})"
        + ("" if gate else "; a reading, not a gate"))
    if not gate:
        return dict(max_err_ratio=ratio, rms_rel=rms, top1=top1)
    check(ratio <= tol, f"{name}: a step's logits differ by {ratio} of max "
          f"|logit| > {tol}")
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


# -- the train phases ----------------------------------------------------------
def worst_ratio(got, want, rtol: float, atol: float) -> float:
    """max |got - want| / (atol + rtol |want|) over the leaves of two trees
    of tensors (on any devices): at most 1 within the limits."""
    import torch.utils._pytree as pytree
    worst = 0.0
    for a, b in zip(pytree.tree_leaves(got), pytree.tree_leaves(want)):
        a, b = a.detach().double().cpu(), b.detach().double().cpu()
        worst = max(worst, float(((a - b).abs() /
                                  (atol + rtol * b.abs())).max()))
    return worst


def rel_err(got, want) -> float:
    return abs(float(got) - float(want)) / abs(float(want))


def train_parity_phase(run_phase, dev) -> dict:
    """One ``build_train_step`` step at qwen3-1.7b's widths (2 layers, f32)
    on the card against the same step on the CPU, parameters from
    ``Model.init(0)`` on the card copied to the CPU; then ``grad_accum``
    TRAIN_ACCUM against the full batch on the card."""
    import dataclasses

    import torch.utils._pytree as pytree

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.dist.step import (build_train_step, init_train_state,
                                       loss_and_grads)
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig
    cfg = dataclasses.replace(get_config("qwen3-1.7b"),
                              n_layers=TRAIN_PARITY_LAYERS,
                              param_dtype="float32", compute_dtype="float32")
    card, cpu = Model(cfg, device=dev), Model(cfg, device="cpu")
    ocfg = AdamWConfig()
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(card, 0, ocfg)
    state_cpu = pytree.tree_map(lambda t: t.cpu(), state)
    batch = SyntheticLM(cfg, batch=TRAIN_PARITY_B, seq=TRAIN_PARITY_S,
                        seed=0).batch_at(0)
    name = (f"train step qwen3-1.7b widths {TRAIN_PARITY_LAYERS} layers f32 "
            f"{TRAIN_PARITY_B}x{TRAIN_PARITY_S}")
    new, m = run_phase(name, ["adamw"], lambda: build_train_step(card, ocfg)(
        state, batch), ADAMW_A_STEP)
    check(all(t.device == dev for t in pytree.tree_leaves(new)),
          f"{name}: the new state left the card")
    del new
    _, m_cpu = build_train_step(cpu, ocfg)(state_cpu, batch)
    _, _, g = loss_and_grads(card, state["params"], batch)
    _, _, g_cpu = loss_and_grads(cpu, state_cpu["params"], batch)
    out = dict(loss=float(m["loss"]), loss_cpu=float(m_cpu["loss"]),
               loss_rel=rel_err(m["loss"], m_cpu["loss"]),
               grad_norm_rel=rel_err(m["grad_norm"], m_cpu["grad_norm"]),
               grad_worst=worst_ratio(g, g_cpu, TRAIN_GRAD_RTOL,
                                      TRAIN_GRAD_ATOL))
    del g, g_cpu, state_cpu
    # grad_accum against the full batch, on the card
    batch4 = SyntheticLM(cfg, batch=TRAIN_ACCUM, seq=TRAIN_PARITY_S,
                         seed=0).batch_at(1)
    _, m_full = build_train_step(card, ocfg)(state, batch4)
    _, m_acc = build_train_step(card, ocfg, grad_accum=TRAIN_ACCUM)(
        state, batch4)
    _, _, g_full = loss_and_grads(card, state["params"], batch4)
    _, _, g_acc = loss_and_grads(card, state["params"], batch4,
                                 grad_accum=TRAIN_ACCUM)
    out.update(accum_loss_rel=rel_err(m_acc["loss"], m_full["loss"]),
               accum_grad_norm_rel=rel_err(m_acc["grad_norm"],
                                           m_full["grad_norm"]),
               accum_grad_worst=worst_ratio(g_acc, g_full, TRAIN_GRAD_RTOL,
                                            TRAIN_GRAD_ATOL),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"{name}: card against CPU: loss {out['loss']} ({out['loss_cpu']} "
        f"on the CPU, rel {out['loss_rel']}, limit {TRAIN_LOSS_RTOL}), "
        f"grad_norm rel {out['grad_norm_rel']} (limit {TRAIN_GNORM_RTOL}), "
        f"worst gradient leaf {out['grad_worst']} of rtol {TRAIN_GRAD_RTOL} "
        f"+ atol {TRAIN_GRAD_ATOL}; grad_accum {TRAIN_ACCUM} against the "
        f"full batch: loss rel {out['accum_loss_rel']}, grad_norm rel "
        f"{out['accum_grad_norm_rel']}, worst leaf "
        f"{out['accum_grad_worst']}; peak {out['peak_gb']:.2f} GB")
    for tag in ("", "accum_"):
        check(out[f"{tag}loss_rel"] <= TRAIN_LOSS_RTOL,
              f"{name}: {tag}loss differs by {out[f'{tag}loss_rel']}")
        check(out[f"{tag}grad_norm_rel"] <= TRAIN_GNORM_RTOL,
              f"{name}: {tag}grad_norm differs by "
              f"{out[f'{tag}grad_norm_rel']}")
        check(out[f"{tag}grad_worst"] <= 1.0,
              f"{name}: a {tag}gradient leaf differs beyond its limits "
              f"({out[f'{tag}grad_worst']})")
    return out


def train_bound_ms(cfg, tokens: int, batch: int, seq: int) -> tuple:
    """The least time of one train step: 6·N·T products (forward and
    backward, no recompute) plus causal attention's 6·B·H·S²·Dh·L (forward
    QK and PV at 4·B·H·S²·Dh, halved by the mask, times three) at the bf16
    peak, against reading the state (bf16 parameters, f32 m and v) and
    writing the new one once. → (bound ms, what bounds it)."""
    ops = (6.0 * cfg.param_count() * tokens + 6.0 * batch * cfg.n_heads *
           seq * seq * cfg.resolved_head_dim * cfg.n_layers)
    state_bytes = cfg.param_count() * (2 + 4 + 4)
    by_ops, by_bytes = ops_ms(ops, BF16_FLOPS), bytes_ms(2 * state_bytes)
    return max(by_ops, by_bytes), ("operations" if by_ops >= by_bytes
                                   else "bytes")


def train_full_phase(run_phase, dev) -> dict:
    """``launch.train.run`` on qwen3-1.7b ``--full``: TRAIN_STEPS steps of
    TRAIN_B x TRAIN_S; then TRAIN_REPEAT_STEPS ``build_train_step`` steps
    on one batch, one of them profiled for the device's busy time."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.dist.step import build_train_step, init_train_state
    from repro_torch.launch import train as launch_train
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig
    cfg = get_config("qwen3-1.7b")
    args = launch_train.parse_args(
        ["--arch", "qwen3-1.7b", "--full", "--steps", str(TRAIN_STEPS),
         "--batch", str(TRAIN_B), "--seq", str(TRAIN_S), "--log-every", "4",
         "--device", str(dev)])
    name = (f"train qwen3-1.7b --full {TRAIN_STEPS} steps of "
            f"{TRAIN_B}x{TRAIN_S}")
    torch.cuda.reset_peak_memory_stats()
    rows = run_phase(name, ["adamw"], lambda: launch_train.run(args, log=log),
                     {fn: TRAIN_STEPS for fn in ADAMW_A_STEP})
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(len(rows) == TRAIN_STEPS and
          all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
              for r in rows), f"{name}: a loss or grad_norm is not finite")
    ln_v = float(np.log(cfg.vocab_size))
    first = rows[0]["loss"]
    check(abs(first - ln_v) <= TRAIN_FIRST_LOSS_TOL * ln_v,
          f"{name}: first loss {first} is not within "
          f"{TRAIN_FIRST_LOSS_TOL} of ln {cfg.vocab_size} = {ln_v}")
    walls = sorted(r["wall_s"] * 1e3 for r in rows[1:])
    step_ms = walls[len(walls) // 2]

    # one repeated batch: the loss must fall
    model = Model(cfg, device=dev)
    ocfg = AdamWConfig()
    step = build_train_step(model, ocfg)
    state = init_train_state(model, 0, ocfg)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticLM(
        cfg, batch=TRAIN_B, seq=TRAIN_S, seed=1).batch_at(0).items()}
    losses, repeat_ms = [], []

    def repeat():
        nonlocal state
        for _ in range(TRAIN_REPEAT_STEPS):
            t0 = time.perf_counter()
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            repeat_ms.append((time.perf_counter() - t0) * 1e3)
    run_phase(f"train qwen3-1.7b --full {TRAIN_REPEAT_STEPS} steps on one "
              "batch", ["adamw"], repeat,
              {fn: TRAIN_REPEAT_STEPS for fn in ADAMW_A_STEP})
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"{name}: {TRAIN_REPEAT_STEPS} steps on one batch did not lower "
          f"the loss: {losses}")
    # the device's busy time in one profiled step, against the median wall
    # of the unprofiled steps on the same batch
    busy = profiled_busy_ms(lambda: step(state, batch))
    wall = sorted(repeat_ms[1:])[(len(repeat_ms) - 1) // 2]
    del state, batch, model
    tokens = TRAIN_B * TRAIN_S
    bound, bound_by = train_bound_ms(cfg, tokens, TRAIN_B, TRAIN_S)
    out = dict(steps=TRAIN_STEPS, batch=TRAIN_B, seq=TRAIN_S,
               losses=[r["loss"] for r in rows],
               grad_norms=[r["grad_norm"] for r in rows],
               first_loss=first, ln_vocab=ln_v, step_wall_ms_median=step_ms,
               step_wall_ms_first=rows[0]["wall_s"] * 1e3,
               tok_per_s=tokens / step_ms * 1e3, peak_gb=peak,
               repeat_losses=losses, step_device_ms=busy,
               repeat_step_wall_ms_median=wall,
               idle_share=max(0.0, 1.0 - busy / wall), bound_ms=bound,
               bound_by=bound_by, params=cfg.param_count())
    log(f"{name}: losses {[round(x, 4) for x in out['losses']]}; first "
        f"{first} against ln {cfg.vocab_size} = {ln_v}; grad_norms "
        f"{[round(x, 3) for x in out['grad_norms']]}")
    log(f"{name}: step wall median {step_ms:.3f} ms (first step "
        f"{out['step_wall_ms_first']:.3f}), {out['tok_per_s']:.1f} tok/s; "
        f"peak {peak:.2f} GB allocated")
    log(f"{name}: on one batch the loss went {losses[0]} -> {losses[-1]}; a "
        f"step's device time {busy:.3f} ms (profiled) against a bound of "
        f"{bound:.3f} ms ({bound_by}; {bound / busy:.3f} of it reached), "
        f"the steps' median wall {wall:.3f} ms, idle share "
        f"{out['idle_share']:.4f}")
    return out


def recovery_run(dev) -> dict:
    """RecoverableTrainer (bit-exact after a fault) and ElasticDPDriver
    (re-split after a worker's death) on ``dev``; the readings, which the
    parent holds to their gates."""
    import dataclasses
    import tempfile

    import torch.utils._pytree as pytree

    from repro_torch.configs import get_config
    from repro_torch.core import ActorSystem
    from repro_torch.data import SyntheticLM
    from repro_torch.dist import fault
    from repro_torch.dist.step import (build_train_step, init_train_state,
                                       loss_and_grads)
    from repro_torch.models import Model
    from repro_torch.models.layers import plain_tree
    from repro_torch.optim import AdamWConfig
    cfg = dataclasses.replace(get_config("qwen3-1.7b"), n_layers=1,
                              vocab_size=RECOVERY_VOCAB)
    model = Model(cfg, device=dev)
    ocfg = AdamWConfig()
    data = SyntheticLM(cfg, batch=RECOVERY_B, seq=RECOVERY_S, seed=9)
    tstep = build_train_step(model, ocfg)
    out = {}
    with tempfile.TemporaryDirectory() as d:
        finals, walls = [], []
        for tag, fail_at in (("plain", None), ("faulted", RECOVERY_FAIL_AT)):
            with ActorSystem(f"recovery-{tag}", device=dev) as system:
                t0 = time.perf_counter()
                trainer = fault.RecoverableTrainer(
                    system, tstep, init_train_state(model, 0, ocfg), data,
                    os.path.join(d, tag), ckpt_every=2)
                finals.append(trainer.run(RECOVERY_STEPS, fail_at=fail_at))
                walls.append(time.perf_counter() - t0)
                out[f"recoveries_{tag}"] = trainer.recoveries
        leaves = [pytree.tree_leaves(f) for f in finals]
        out.update(
            leaves=len(leaves[0]),
            equal_leaves=sum(a.dtype == b.dtype and torch.equal(a, b)
                             for a, b in zip(*leaves)),
            on_card=all(t.device == dev for t in leaves[1]),
            steps=[int(f["step"]) for f in finals], wall_s=walls,
            checkpoint_bytes=sum(t.numel() * t.element_size()
                                 for t in leaves[0]))
        del finals, leaves
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    model32 = Model(cfg32, device=dev)
    params = plain_tree(model32.init(1))
    data32 = SyntheticLM(cfg32, batch=ELASTIC_B, seq=RECOVERY_S, seed=9)

    def grad_fn(p, batch):
        loss, _, grads = loss_and_grads(model32, p, batch)
        return loss, grads

    with ActorSystem("elastic", device=dev) as system:
        driver = fault.ElasticDPDriver(system, grad_fn,
                                       n_workers=ELASTIC_WORKERS,
                                       fail_at={1: 1})
        _, _, used0 = driver.step(params, 0, data32.batch_at(0))
        loss1, grads1, used1 = driver.step(params, 1, data32.batch_at(1))
    l_ref, g_ref = grad_fn(params, data32.batch_at(1))
    out.update(used=[used0, used1], elastic_loss_rel=rel_err(loss1, l_ref),
               elastic_grad_worst=worst_ratio(grads1, g_ref, 1e-4, 1e-5),
               deterministic=torch.are_deterministic_algorithms_enabled())
    return out


def recovery_child(queue) -> None:
    """The recovery phase's process: deterministic algorithms (the
    embedding's backward accumulates with atomics otherwise), cuBLAS's
    fixed workspace set before CUDA starts."""
    import traceback
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        queue.put(("ok", recovery_run(torch.device("cuda", 0))))
    except BaseException:
        queue.put(("error", traceback.format_exc()))
        raise


def recovery_phase(run_phase) -> dict:
    """``recovery_run`` in a child process started by ``spawn``, so this
    process keeps its nondeterministic algorithms and its times."""
    import multiprocessing as mp
    import queue as queue_mod
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    name = (f"recovery and elastic DP qwen3-1.7b widths, 1 layer, vocab cut "
            f"to {RECOVERY_VOCAB} (a checkpoint of the full vocabulary "
            "writes about 3.6 GB)")

    def body():
        child = ctx.Process(target=recovery_child, args=(results,))
        child.start()
        try:
            status, payload = results.get(timeout=600)
        except queue_mod.Empty:
            payload, status = None, "timeout"
        child.join(timeout=60)
        if child.is_alive():
            child.kill()
            child.join(timeout=30)
        check(status == "ok" and child.exitcode == 0,
              f"recovery child: {status}, exit code {child.exitcode}\n"
              f"{payload}")
        return payload

    out = run_phase(name, [], body)
    log(f"{name}: RecoverableTrainer {RECOVERY_STEPS} steps of "
        f"{RECOVERY_B}x{RECOVERY_S}, fault at step {RECOVERY_FAIL_AT}: "
        f"recoveries {out['recoveries_plain']} / {out['recoveries_faulted']}"
        f", {out['equal_leaves']} of {out['leaves']} leaves torch.equal to "
        f"the unfaulted run's, steps {out['steps']}, walls "
        f"{[round(w, 3) for w in out['wall_s']]} s, "
        f"{out['checkpoint_bytes'] / 1e9:.3f} GB a checkpoint; "
        f"ElasticDPDriver {ELASTIC_WORKERS} workers: used {out['used']}, "
        f"loss rel {out['elastic_loss_rel']} (limit 1e-5), worst gradient "
        f"leaf {out['elastic_grad_worst']} of rtol 1e-4 + atol 1e-5; "
        f"deterministic {out['deterministic']}")
    check(out["deterministic"], f"{name}: not under deterministic algorithms")
    check(out["recoveries_plain"] == 0 and out["recoveries_faulted"] == 1,
          f"{name}: recoveries {out['recoveries_plain']}, "
          f"{out['recoveries_faulted']}")
    check(out["steps"] == [RECOVERY_STEPS] * 2 and out["on_card"],
          f"{name}: steps {out['steps']}, on the card {out['on_card']}")
    check(out["equal_leaves"] == out["leaves"],
          f"{name}: {out['leaves'] - out['equal_leaves']} leaves of the "
          "faulted run differ from the unfaulted run's")
    check(out["used"] == [ELASTIC_WORKERS, ELASTIC_WORKERS - 1],
          f"{name}: the elastic driver used {out['used']} workers")
    check(out["elastic_loss_rel"] <= 1e-5 and out["elastic_grad_worst"] <= 1,
          f"{name}: the elastic result differs from one worker's")
    return out


def llama_prefill_phase(run_phase, dev) -> dict:
    """The llama3-8b prefill at full width (32 layers, random bf16 weights
    from seed 0), LLAMA_B x LLAMA_S tokens: B6's bf16 kernel at a GQA group
    of 4, against the plain attention under the qwen3 prefill's gates."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = get_config("llama3-8b")
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, attn_impl="kernel", device=dev)
    params = model.init(0)
    tokens = torch.from_numpy(np.random.default_rng(19).integers(
        0, cfg.vocab_size, (LLAMA_B, LLAMA_S))).to(dev)
    model.forward(params, {"tokens": tokens})          # warm up
    name = f"llama3-8b prefill {LLAMA_B}x{LLAMA_S} bf16"
    t0 = time.perf_counter()
    logits, _ = run_phase(name, ["flash_attention"],
                          lambda: model.forward(params, {"tokens": tokens}),
                          {"flash_attention_bf16": cfg.n_layers})
    wall = (time.perf_counter() - t0) * 1e3
    plain, _ = Model(cfg, attn_impl="ref", device=dev).forward(
        params, {"tokens": tokens})
    out = prefill_gates(name, logits, plain)
    out.update(wall_ms=wall, weight_gb=param_bytes(params) / 1e9,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"{name}: {out['weight_gb']:.2f} GB of weights, forward wall "
        f"{wall:.3f} ms, peak {out['peak_gb']:.2f} GB")
    return out


# -- the family phases -----------------------------------------------------------
def family_config(phase: str):
    """The published config of a family phase, phi-3.5-moe cut to
    FAMILY_MOE_LAYERS layers."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(FAMILY_PHASES[phase][0])
    if phase == "moe":
        cfg = dataclasses.replace(cfg, n_layers=FAMILY_MOE_LAYERS)
    return cfg


def family_batch(cfg, b: int, s: int, dev, seed: int = 20) -> dict:
    """A prefill's inputs: tokens [B,S] from numpy ``seed``, and the
    family's extras: frames [B,1500,D] (encdec); vision embeddings for the
    first n_vision_tokens and [3,B,S] M-RoPE positions whose streams differ
    over them (vlm)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (b, s))).to(dev)}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.encdec.n_frames, cfg.d_model), np.float32)).to(dev)
    if cfg.family == "vlm":
        n = cfg.n_vision_tokens
        side = int(round(n ** 0.5))
        batch["vision_embeds"] = torch.from_numpy(rng.standard_normal(
            (b, n, cfg.d_model), np.float32)).to(dev)
        pos = np.empty((3, s), np.int64)
        grid = np.arange(n)
        pos[:, :n] = (np.zeros(n), grid // side, grid % side)
        pos[:, n:] = side + np.arange(s - n)
        batch["positions"] = torch.from_numpy(
            np.ascontiguousarray(np.broadcast_to(pos[:, None], (3, b, s)))
        ).to(dev)
    return batch


def family_prefill(run_phase, phase: str, dev):
    """A family's bf16 prefill through ``attn_impl="kernel"``: B6 launched
    the phase's count a forward, held against ``attn_impl="ref"`` under the
    prefill gates; its wall and profiled device time. → (cfg, model,
    params, batch, the plain logits, readings)."""
    from repro_torch.models import Model
    arch, b, s, fa = FAMILY_PHASES[phase]
    cfg = family_config(phase)
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, attn_impl="kernel", device=dev)
    params = model.init(0)
    batch = family_batch(cfg, b, s, dev)
    name = f"{phase} {arch} ({cfg.n_layers} layers) prefill {b}x{s} bf16"
    model.forward(params, batch)                       # warm up
    t0 = time.perf_counter()
    logits, aux = run_phase(name, ["flash_attention"] if fa else [],
                            lambda: model.forward(params, batch),
                            {"flash_attention_bf16": fa})
    wall = (time.perf_counter() - t0) * 1e3
    busy = profiled_busy_ms(lambda: model.forward(params, batch))
    plain, plain_aux = Model(cfg, attn_impl="ref", device=dev).forward(
        params, batch)
    check(logits.shape == (b, s, cfg.vocab_size),
          f"{name}: logits of shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(aux)) and bool(torch.isfinite(plain_aux)),
          f"{name}: aux loss not finite")
    out = prefill_gates(name, logits, plain)
    out.update(arch=arch, layers=cfg.n_layers, batch=b, tokens=s,
               flash_attention_launches=fa, wall_ms=wall,
               device_busy_ms=busy, idle_share=max(0.0, 1.0 - busy / wall),
               aux=float(aux), weight_gb=param_bytes(params) / 1e9,
               params=sum(p.numel() for p in params.parameters()),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"{name}: {out['params']} parameters ({out['weight_gb']:.2f} GB), "
        f"forward wall {wall:.3f} ms, device busy {busy:.3f} ms (profiled), "
        f"idle share {out['idle_share']:.4f}, aux loss {out['aux']}, peak "
        f"{out['peak_gb']:.2f} GB")
    return cfg, model, params, batch, plain, out


def family_decode(run_phase, phase: str, cfg, model, params, batch, want,
                  steps=None, tol: float = PREFILL_BF16_TOL,
                  gate: bool = True) -> dict:
    """``steps`` (FAMILY_DECODE_STEPS) decode steps from an empty cache,
    teacher-forced with the prefill's inputs (for vlm its vision embeddings
    and [3,B,1] positions, through ``transformer.decode_step``), held to
    the prefill's logits ``want`` at those positions. The MoE prefill's
    expert queues take tokens in order, so the first positions are never
    dropped and decode routes them as the prefill did."""
    from repro_torch.models import transformer
    steps = steps or FAMILY_DECODE_STEPS
    tokens = batch["tokens"]
    b = tokens.shape[0]
    name = (f"{phase} {FAMILY_PHASES[phase][0]} decode {b}x{steps} "
            f"{cfg.compute_dtype} against the prefill")

    def body():
        if cfg.family == "encdec":
            cache = model.init_cache(b, steps, params=params,
                                     frames=batch["frames"])
        else:
            cache = model.init_cache(b, steps)
        out = []
        for t in range(steps):
            tok = tokens[:, t:t + 1]
            if cfg.family == "vlm":
                with torch.no_grad():
                    logits, cache = transformer.decode_step(
                        params, cfg, tok, cache,
                        positions=batch["positions"][:, :, t:t + 1],
                        vision_embeds=batch["vision_embeds"][:, t:t + 1])
            else:
                logits, cache = model.decode_step(params, tok, cache)
            out.append(logits[:, 0])
        return torch.stack(out, dim=1), cache

    t0 = time.perf_counter()
    # an encdec cache is the encoder's prefill: B6 once an encoder layer
    enc = cfg.encdec.n_enc_layers if cfg.family == "encdec" else 0
    got, cache = run_phase(name, ["flash_attention"] if enc else [], body,
                           {"flash_attention_bf16": enc})
    wall = (time.perf_counter() - t0) * 1e3
    check(int(cache["len"]) == steps, f"{name}: cache length wrong")
    out = step_gates(name, got, want[:, :steps], tol, gate)
    out.update(steps=steps, step_wall_ms=wall / steps)
    log(f"{name}: {wall / steps:.3f} ms of wall a step")
    return out


class PinnedRouting:
    """Records the expert choices of each MoE layer in one forward
    (``record``), then makes later forwards and decode steps route their
    tokens to those experts (``replay``): a token keeps the recorded
    top-k experts, weighted by its own router probabilities there. Routing
    is discontinuous: in bf16 a token whose second and third experts lie
    within a rounding of each other picks either, and the plain attention
    (P rounded to bf16 before P·V, as in the JAX package) and the kernel
    (P in two bf16 halves) round differently. With the choices pinned, the
    two paths compute the same function of continuous numbers, which the
    prefill gates can hold. Patches ``models.moe.route``, which
    ``apply_moe`` calls once a layer."""

    def __init__(self):
        from repro_torch.models import moe as moe_mod
        self._mod, self._route = moe_mod, moe_mod.route
        self.choices, self._calls, self._mode = [], 0, None

    def _patched(self, p, cfg, x):
        probs, topv, topi = self._route(p, cfg, x)
        if self._mode == "record":
            self.choices.append(topi)
            return probs, topv, topi
        layer = self._calls % len(self.choices)
        rec = self.choices[layer]
        if x.shape[1] == 1:          # a decode step: its position's choice
            pos = self._calls // len(self.choices)
            rec = rec.reshape(-1, rec.shape[-1])[pos][None, None]
        self._calls += 1
        topi = rec.expand(x.shape[0], *rec.shape[1:])
        topv = probs.gather(-1, topi)
        return probs, topv / topv.sum(-1, keepdim=True), topi

    def record(self):
        self.choices, self._mode = [], "record"
        self._mod.route = self._patched
        return self

    def replay(self):
        self._calls, self._mode = 0, "replay"
        self._mod.route = self._patched
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._mod.route = self._route


def routing_flips(a: list, b: list) -> list:
    """Tokens a layer whose top-k experts differ between two records."""
    return [int((x.sort(-1).values != y.sort(-1).values).any(-1).sum())
            for x, y in zip(a, b)]


def moe_phase(run_phase, dev) -> dict:
    """phi-3.5-moe at FAMILY_MOE_LAYERS layers: the bf16 prefill through B6
    with its expert choices recorded; the plain attention's prefill, once
    routed on its own (the tokens that pick another expert are counted and
    the unpinned readings logged) and once routed to the kernel pass's
    experts, held to the prefill gates; decode steps routed to the same
    experts against it. Then, unpinned, kernel against plain attention in
    f32 at FAMILY_MOE_F32_LAYERS layers: the same experts and logits within
    PREFILL_F32_TOL."""
    import dataclasses
    from repro_torch.models import Model
    arch, b, s, fa = FAMILY_PHASES["moe"]
    cfg = family_config("moe")
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, attn_impl="kernel", device=dev)
    params = model.init(0)
    batch = family_batch(cfg, b, s, dev)
    name = f"moe {arch} ({cfg.n_layers} layers) prefill {b}x{s} bf16"
    plain_model = Model(cfg, attn_impl="ref", device=dev)
    model.forward(params, batch)                       # warm up
    with PinnedRouting() as pins:
        pins.record()
        t0 = time.perf_counter()
        logits, aux = run_phase(name, ["flash_attention"],
                                lambda: model.forward(params, batch),
                                {"flash_attention_bf16": fa})
        wall = (time.perf_counter() - t0) * 1e3
        kernel_choices = pins.choices
        pins.record()
        unpinned, _ = plain_model.forward(params, batch)
        flips = routing_flips(kernel_choices, pins.choices)
        pins.choices = kernel_choices
        unpinned_top1 = float((logits.argmax(-1) == unpinned.argmax(-1))
                              .float().mean())
        del unpinned
        log(f"{name}: unpinned, the plain attention's prefill routes "
            f"{flips} tokens a layer to other experts than the kernel's "
            f"(of {s}); top-1 agreement {unpinned_top1}")
        pins.replay()
        plain, plain_aux = plain_model.forward(params, batch)
        busy = profiled_busy_ms(lambda: model.forward(params, batch))
        check(bool(torch.isfinite(aux)) and bool(torch.isfinite(plain_aux)),
              f"{name}: aux loss not finite")
        out = prefill_gates(f"{name}, experts pinned", logits, plain)
        out.update(arch=arch, layers=cfg.n_layers, batch=b, tokens=s,
                   flash_attention_launches=fa, wall_ms=wall,
                   device_busy_ms=busy,
                   idle_share=max(0.0, 1.0 - busy / wall), aux=float(aux),
                   weight_gb=param_bytes(params) / 1e9,
                   params=sum(p.numel() for p in params.parameters()),
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   unpinned_flips=flips, unpinned_top1=unpinned_top1)
        log(f"{name}: {out['params']} parameters ({out['weight_gb']:.2f} "
            f"GB), forward wall {wall:.3f} ms, device busy {busy:.3f} ms "
            f"(profiled), idle share {out['idle_share']:.4f}, aux loss "
            f"{out['aux']}, peak {out['peak_gb']:.2f} GB")
        pins.replay()
        out["decode"] = family_decode(run_phase, "moe", cfg, model, params,
                                      batch, plain)
    del model, params, plain, plain_model, logits
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, n_layers=FAMILY_MOE_F32_LAYERS,
                                param_dtype="float32",
                                compute_dtype="float32")
    params32 = Model(cfg32, device=dev).init(0)
    name = f"moe {arch} ({FAMILY_MOE_F32_LAYERS} layers) prefill {b}x{s} f32"
    with PinnedRouting() as pins:
        pins.record()
        got = run_phase(name, ["flash_attention"], lambda: Model(
            cfg32, attn_impl="kernel", device=dev).forward(params32, batch)[0],
            {"flash_attention_f32": FAMILY_MOE_F32_LAYERS})
        kernel_choices = pins.choices
        pins.record()
        want = Model(cfg32, attn_impl="ref", device=dev).forward(
            params32, batch)[0]
        flips = routing_flips(kernel_choices, pins.choices)
    err, scale = max_abs_err(got, want), float(want.abs().max())
    log(f"{name}: kernel against plain attention, unpinned: {flips} tokens a "
        f"layer on other experts; logits max_abs_err {err} (max |logit| "
        f"{scale}, limit {PREFILL_F32_TOL} x max)")
    check(sum(flips) == 0, f"{name}: tokens routed apart in f32: {flips}")
    check(err <= PREFILL_F32_TOL * scale, f"{name}: kernel and plain "
          f"attention disagree beyond {PREFILL_F32_TOL} x max |logit|")
    out["f32_unpinned"] = dict(layers=FAMILY_MOE_F32_LAYERS, flips=flips,
                               max_abs_err=err, max_logit=scale)
    return out


def hybrid_phase(run_phase, dev) -> dict:
    """recurrentgemma-9b: the bf16 prefill under the gates; the model's own
    bf16 noise (its plain prefill of the same tokens as row 0 of a batch of
    2, where cuBLAS tiles the products otherwise) and the bf16 decode
    against the prefill, both logged as readings; then the same 38 layers
    in f32, 1 x HYBRID_F32_S through B6's f32 kernel at D = 256, and decode
    held to that prefill within PREFILL_F32_TOL."""
    import dataclasses
    from repro_torch.models import Model
    cfg, model, params, batch, plain, out = family_prefill(run_phase,
                                                           "hybrid", dev)
    out["window"] = cfg.hybrid.window
    two = {"tokens": batch["tokens"].expand(2, -1).contiguous()}
    floor = Model(cfg, attn_impl="ref", device=dev).forward(params, two)[0]
    out["bf16_noise_floor"] = step_gates(
        "hybrid recurrentgemma-9b plain prefill, row 0 of a batch of 2 "
        "against batch 1 (the model's own bf16 noise)", floor[:1], plain,
        gate=False)
    del floor
    out["decode_bf16"] = family_decode(run_phase, "hybrid", cfg, model,
                                       params, batch, plain, gate=False)
    del model, params, plain
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    model32 = Model(cfg32, attn_impl="kernel", device=dev)
    params32 = model32.init(0)
    tokens = {"tokens": batch["tokens"][:, :HYBRID_F32_S]}
    name = f"hybrid recurrentgemma-9b prefill 1x{HYBRID_F32_S} f32"
    got = run_phase(name, ["flash_attention"],
                    lambda: model32.forward(params32, tokens)[0],
                    {"flash_attention_f32": FAMILY_PHASES["hybrid"][3]})
    want = Model(cfg32, attn_impl="ref", device=dev).forward(params32,
                                                             tokens)[0]
    err, scale = max_abs_err(got, want), float(want.abs().max())
    log(f"{name}: kernel against plain attention, logits max_abs_err {err} "
        f"(max |logit| {scale}, limit {PREFILL_F32_TOL} x max)")
    check(err <= PREFILL_F32_TOL * scale, f"{name}: kernel and plain "
          f"attention disagree beyond {PREFILL_F32_TOL} x max |logit|")
    out["f32_prefill"] = dict(tokens=HYBRID_F32_S, max_abs_err=err,
                              max_logit=scale)
    out["decode"] = family_decode(run_phase, "hybrid", cfg32, model32,
                                  params32, tokens, got, tol=PREFILL_F32_TOL)
    return out


def vlm_phase(run_phase, dev) -> dict:
    cfg, model, params, batch, plain, out = family_prefill(run_phase, "vlm",
                                                           dev)
    pos = batch["positions"][:, 0, :cfg.n_vision_tokens]
    check(not torch.equal(pos[0], pos[1]) and not torch.equal(pos[1], pos[2]),
          "vlm: the M-RoPE streams do not differ over the vision block")
    out["decode"] = family_decode(run_phase, "vlm", cfg, model, params, batch,
                                  plain)
    return out


def encdec_phase(run_phase, dev) -> dict:
    from repro_torch.launch import serve as launch_serve
    cfg, model, params, batch, plain, out = family_prefill(run_phase,
                                                           "encdec", dev)
    out["decode"] = family_decode(run_phase, "encdec", cfg, model, params,
                                  batch, plain)
    del model, params
    name = f"encdec launch.serve --arch whisper-tiny --full --sync 8x64"
    rc = run_phase(name, [], lambda: launch_serve.main(
        ["--arch", "whisper-tiny", "--full", "--sync", "--batch", "8",
         "--steps", str(FAMILY_DECODE_STEPS), "--device", str(dev)]),
        {"flash_attention_bf16": 0})
    check(rc == 0, f"{name}: exit code {rc}")
    return out


def ssm_phase(run_phase, dev) -> dict:
    """mamba2-130m: the bf16 prefill (no attention, so no B6 launch); an f32
    1 x SSM_F32_S prefill on the card against the CPU; SSM_DECODE_STEPS f32
    decode steps against that prefill; SSM_TRAIN_STEPS steps of
    ``launch.train.run --full``."""
    import dataclasses
    import torch.utils._pytree as pytree
    from repro_torch.launch import train as launch_train
    from repro_torch.models import Model
    from repro_torch.models.layers import ParamTree, plain_tree
    cfg, model, params, batch, plain, out = family_prefill(run_phase, "ssm",
                                                           dev)
    del model, params, plain
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    model32 = Model(cfg32, device=dev)
    params32 = model32.init(0)
    tokens = batch["tokens"][:1, :SSM_F32_S]
    name = f"ssm mamba2-130m prefill 1x{SSM_F32_S} f32"
    got = run_phase(name, [], lambda: model32.forward(
        params32, {"tokens": tokens})[0], {"flash_attention_bf16": 0,
                                           "flash_attention_f32": 0})
    cpu = Model(cfg32, device="cpu")
    cpu_params = ParamTree(pytree.tree_map(lambda t: t.cpu(),
                                           plain_tree(params32)))
    want = cpu.forward(cpu_params, {"tokens": tokens.cpu()})[0]
    err = max_abs_err(got.cpu(), want)
    scale = float(want.abs().max())
    log(f"{name}: card against the CPU, logits max_abs_err {err} (max "
        f"|logit| {scale}, limit {PREFILL_F32_TOL} x max)")
    check(err <= PREFILL_F32_TOL * scale, f"{name}: the card and the CPU "
          f"disagree beyond {PREFILL_F32_TOL} x max |logit|")
    out["f32_card_vs_cpu"] = dict(max_abs_err=err, max_logit=scale)
    out["f32_decode"] = family_decode(
        run_phase, "ssm", cfg32, model32, params32, {"tokens": tokens},
        got, steps=SSM_DECODE_STEPS, tol=PREFILL_F32_TOL)
    del model32, params32, got
    torch.cuda.empty_cache()
    args = launch_train.parse_args(
        ["--arch", "mamba2-130m", "--full", "--steps", str(SSM_TRAIN_STEPS),
         "--batch", str(SSM_TRAIN_B), "--seq", str(SSM_TRAIN_S),
         "--log-every", "4", "--device", str(dev)])
    name = (f"ssm train mamba2-130m --full {SSM_TRAIN_STEPS} steps of "
            f"{SSM_TRAIN_B}x{SSM_TRAIN_S}")
    torch.cuda.reset_peak_memory_stats()
    rows = run_phase(name, ["adamw"], lambda: launch_train.run(args, log=log),
                     {fn: SSM_TRAIN_STEPS for fn in ADAMW_A_STEP})
    ln_v = float(np.log(cfg.vocab_size))
    losses = [r["loss"] for r in rows]
    check(len(rows) == SSM_TRAIN_STEPS and all(
        np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in rows),
        f"{name}: a loss or grad_norm is not finite")
    check(abs(losses[0] - ln_v) <= TRAIN_FIRST_LOSS_TOL * ln_v,
          f"{name}: first loss {losses[0]} is not within "
          f"{TRAIN_FIRST_LOSS_TOL} of ln {cfg.vocab_size} = {ln_v}")
    walls = sorted(r["wall_s"] * 1e3 for r in rows[1:])
    out["train"] = dict(losses=losses, ln_vocab=ln_v,
                        step_wall_ms_median=walls[len(walls) // 2],
                        peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"{name}: losses {[round(x, 4) for x in losses]} (ln V {ln_v}); "
        f"step wall median {out['train']['step_wall_ms_median']:.3f} ms, "
        f"peak {out['train']['peak_gb']:.2f} GB")
    return out


# -- B6 at head dim 192, at the added widths, and the distribution layer ------
def fa_shape_rows(tag: str, shape, dev) -> dict:
    """B6 at one causal launch ``shape`` (B, H, Hkv, Sq, Skv, D): bf16
    within FA_BF16_STEPS of the plain version at every element over the
    seeds FA_BF16_SEEDS, f32 within FA_F32_TOL; each timed beside the
    plain version and SDPA (``is_causal``, ``enable_gqa``; f32 with TF32
    off), against its bound, which counts the head dim D and not the
    width the kernel runs it on."""
    from repro_torch.kernels import FLASH_ATTENTION, ref
    from repro_torch.kernels.build import device_sm_count
    from repro_torch.kernels.flash_attention import (f32_query_tile,
                                                     flash_attention,
                                                     kernel_width)
    b_, h_, hkv_, s_, _, d_ = shape
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        r = dict(shape=list(shape), dtype=str(dtype),
                 kernel_width=kernel_width(d_), seeds=[])
        for seed in FA_BF16_SEEDS if dtype == torch.bfloat16 else (0,):
            q, k, v = attention_inputs(
                shape, dtype, torch.Generator(device=dev).manual_seed(seed),
                dev)
            before = FLASH_ATTENTION.launches
            got = flash_attention(q, k, v, causal=True)
            torch.cuda.synchronize()
            check(FLASH_ATTENTION.launches == before + 1,
                  f"flash_attention {dtype} {tag}: not one launch")
            want = ref.flash_attention(q, k, v, causal=True)
            reading = dict(seed=seed, max_abs_err=max_abs_err(
                got.float(), want.float()))
            if dtype == torch.bfloat16:
                reading["max_steps"] = float(bf16_steps(got, want).max())
                check(reading["max_steps"] <= FA_BF16_STEPS,
                      f"flash_attention bf16 {tag} seed {seed}: "
                      f"{reading['max_steps']} bf16 steps from the plain "
                      f"version > {FA_BF16_STEPS}")
            else:
                check(torch.allclose(got, want, rtol=FA_F32_TOL,
                                     atol=FA_F32_TOL),
                      f"flash_attention f32 {tag} disagrees beyond "
                      f"{FA_F32_TOL}")
            r["seeds"].append(reading)
            del q, k, v, got, want
        q, k, v = attention_inputs(
            shape, dtype, torch.Generator(device=dev).manual_seed(0), dev)
        r.update(
            max_abs_err=max(x["max_abs_err"] for x in r["seeds"]),
            ms=cuda_ms(lambda: flash_attention(q, k, v, causal=True), 10),
            plain_ms=cuda_ms(lambda: ref.flash_attention(q, k, v,
                                                         causal=True), 3),
            bound_ms=attention_bound_ms(q, k, v, True),
            bound_by="operations",
            library_ms=cuda_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True), 10),
            library="F.scaled_dot_product_attention(is_causal=True, "
                    "enable_gqa=True)" + (", f32 (TF32 off)"
                                         if dtype == torch.float32 else ""),
            library_backend=sdpa_backend(q, k, v, True))
        if dtype == torch.float32:
            r["query_tile"] = f32_query_tile(b_, h_, s_,
                                             device_sm_count(dev.index), d_)
        out["bf16" if dtype == torch.bfloat16 else "f32"] = r
        log(f"flash_attention {dtype} causal {tag} {b_}x{h_}({hkv_})x{s_}^2x"
            f"{d_} (width {r['kernel_width']}): kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms "
            f"({r['library_backend']}), bound {r['bound_ms']:.4f} ms "
            f"({r['bound_ms'] / r['ms']:.3f} of it reached); max_abs_err "
            f"{r['max_abs_err']}" + (
                f", {max(x['max_steps'] for x in r['seeds'])} bf16 steps at "
                f"most over seeds {list(FA_BF16_SEEDS)}"
                if dtype == torch.bfloat16 else
                f" (tol {FA_F32_TOL}), {r['query_tile']}-row tiles"))
        del q, k, v
    torch.cuda.empty_cache()
    return out


def every_head_dim_check(dev) -> dict:
    """B6 at every head dim from 1 to MAX_KERNEL_WIDTH and at FA_ABOVE_D
    (in slabs) in both dtypes, at FA_EVERY_D: one launch each (bf16 head
    dims that are no multiple of 8 through the pitch copy), held to the
    plain version."""
    from repro_torch.kernels import FLASH_ATTENTION, ref
    from repro_torch.kernels.flash_attention import (MAX_KERNEL_WIDTH,
                                                     flash_attention)
    b_, h_, hkv_, sq_, skv_ = FA_EVERY_D
    head_dims = (*range(1, MAX_KERNEL_WIDTH + 1), *FA_ABOVE_D)
    worst = {}
    t0 = time.perf_counter()
    for dtype in (torch.bfloat16, torch.float32):
        worst[str(dtype)] = 0.0
        for d in head_dims:
            q, k, v = attention_inputs(
                (b_, h_, hkv_, sq_, skv_, d), dtype,
                torch.Generator(device=dev).manual_seed(d), dev)
            before = FLASH_ATTENTION.launches
            got = flash_attention(q, k, v, causal=True)
            want = ref.flash_attention(q, k, v, causal=True)
            torch.cuda.synchronize()
            check(FLASH_ATTENTION.launches == before + 1,
                  f"flash_attention {dtype} head dim {d}: not one launch")
            if dtype == torch.bfloat16:
                err = float(bf16_steps(got, want).max())
                check(err <= FA_BF16_STEPS, f"flash_attention bf16 head dim "
                      f"{d}: {err} bf16 steps from the plain version")
            else:
                err = max_abs_err(got, want)
                check(err <= FA_F32_TOL, f"flash_attention f32 head dim {d}:"
                      f" {err} from the plain version")
            worst[str(dtype)] = max(worst[str(dtype)], err)
    out = dict(shape=list(FA_EVERY_D), head_dims=[1, MAX_KERNEL_WIDTH],
               above=list(FA_ABOVE_D), launches=2 * len(head_dims),
               max_bf16_steps=worst["torch.bfloat16"],
               max_abs_err_f32=worst["torch.float32"],
               seconds=time.perf_counter() - t0)
    log(f"flash_attention at every head dim 1..{MAX_KERNEL_WIDTH} and "
        f"{list(FA_ABOVE_D)}, bf16 and f32, "
        f"{b_}x{h_}({hkv_})x{sq_}x{skv_} causal: {out['launches']} launches, "
        f"at most {out['max_bf16_steps']} bf16 steps and "
        f"{out['max_abs_err_f32']} in f32 from the plain version "
        f"({out['seconds']:.1f} s)")
    return out


def sdpa_backend(q, k, v, causal: bool) -> str:
    """The backend F.scaled_dot_product_attention picks for these inputs
    (``torch._fused_sdp_choice``), by name: what SDPA's time is of."""
    from torch.nn.attention import SDPBackend
    names = {int(m): n for n, m in SDPBackend.__members__.items()}
    return names[int(torch._fused_sdp_choice(q, k, v, is_causal=causal,
                                             enable_gqa=True))]


def slab_prefill_phase(run_phase, dev) -> dict:
    """qwen3-1.7b's published widths with head_dim SLAB_PREFILL_D, which B6
    runs in slabs, at SLAB_PREFILL_LAYERS layers, random bf16 weights from
    seed 0, 1 x PREFILL_S tokens: one slab launch a layer, held to the
    plain attention under the prefill gates."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel_slabs
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_config("qwen3-1.7b"),
                              n_layers=SLAB_PREFILL_LAYERS,
                              head_dim=SLAB_PREFILL_D)
    model = Model(cfg, attn_impl="kernel", device=dev)
    params = model.init(0)
    tokens = torch.from_numpy(np.random.default_rng(23).integers(
        0, cfg.vocab_size, (1, PREFILL_S))).to(dev)
    model.forward(params, {"tokens": tokens})          # warm up
    name = (f"qwen3-1.7b head_dim {SLAB_PREFILL_D} ({SLAB_PREFILL_LAYERS} "
            f"layers) prefill 1x{PREFILL_S} bf16")
    t0 = time.perf_counter()
    logits, _ = run_phase(name, ["flash_attention"],
                          lambda: model.forward(params, {"tokens": tokens}),
                          {"flash_attention_bf16_slabs": cfg.n_layers,
                           "flash_attention_bf16": 0})
    wall = (time.perf_counter() - t0) * 1e3
    plain, _ = Model(cfg, attn_impl="ref", device=dev).forward(
        params, {"tokens": tokens})
    out = prefill_gates(name, logits, plain)
    out.update(arch="qwen3-1.7b", n_layers=cfg.n_layers,
               head_dim=SLAB_PREFILL_D,
               slabs=list(kernel_slabs(SLAB_PREFILL_D)),
               tokens=[1, PREFILL_S], launches=cfg.n_layers, wall_ms=wall,
               weight_gb=param_bytes(params) / 1e9)
    log(f"{name}: {out['weight_gb']:.2f} GB of weights, forward wall "
        f"{wall:.3f} ms, {cfg.n_layers} slab launches")
    return out


def nemotron_phase(run_phase, dev) -> dict:
    """nemotron-4-340b at NEMOTRON_LAYERS of its 96 layers, published
    widths, random bf16 weights from seed 0, 1 x NEMOTRON_S tokens: B6 at
    D = 192 once a layer against the plain attention under the prefill
    gates; its wall, profiled busy time, idle share and peak memory, which
    must stay under CARD_GB."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_config("nemotron-4-340b"),
                              n_layers=NEMOTRON_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, attn_impl="kernel", device=dev)
    params = model.init(0)
    batch = family_batch(cfg, 1, NEMOTRON_S, dev)
    name = (f"nemotron-4-340b ({cfg.n_layers} of 96 layers) prefill "
            f"1x{NEMOTRON_S} bf16")
    model.forward(params, batch)                       # warm up
    t0 = time.perf_counter()
    logits, _ = run_phase(name, ["flash_attention"],
                          lambda: model.forward(params, batch),
                          {"flash_attention_bf16": cfg.n_layers})
    wall = (time.perf_counter() - t0) * 1e3
    busy = profiled_busy_ms(lambda: model.forward(params, batch))
    plain, _ = Model(cfg, attn_impl="ref", device=dev).forward(params, batch)
    check(logits.shape == (1, NEMOTRON_S, cfg.vocab_size),
          f"{name}: logits of shape {tuple(logits.shape)}")
    out = prefill_gates(name, logits, plain)
    out.update(layers=cfg.n_layers, head_dim=cfg.resolved_head_dim,
               tokens=NEMOTRON_S, flash_attention_launches=cfg.n_layers,
               wall_ms=wall, device_busy_ms=busy,
               idle_share=max(0.0, 1.0 - busy / wall),
               weight_gb=param_bytes(params) / 1e9,
               params=sum(p.numel() for p in params.parameters()),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"{name}: {out['params']} parameters ({out['weight_gb']:.2f} GB), "
        f"forward wall {wall:.3f} ms, device busy {busy:.3f} ms (profiled), "
        f"idle share {out['idle_share']:.4f}, peak {out['peak_gb']:.2f} GB")
    check(out["peak_gb"] < CARD_GB, f"{name}: peak {out['peak_gb']:.2f} GB "
          f"is not under {CARD_GB} GB")
    return out


def pipeline_phase(run_phase, model, params, dev) -> dict:
    """qwen3-1.7b's prefill weights in PIPE_STAGES stage actors
    (``make_layer_stage_actors``), PIPE_MICROBATCHES microbatches of 1 x
    PREFILL_S tokens through a ``PipelineRunner`` of depth PIPE_DEPTH with
    ``emit="ref"``: B6 launched once a layer a microbatch, no host transfer
    or spill of the activation, the results on the card and each under the
    prefill gates against ``model.forward`` of the same microbatch (the
    same ops in the same order: a difference of 0 is expected); the staged
    wall beside PIPE_MICROBATCHES fused forwards, a reading."""
    from repro_torch.core import ActorSystem, DeviceRef
    from repro_torch.core.memref import registry
    from repro_torch.dist.pipeline import (PipelineRunner,
                                           make_layer_stage_actors)
    cfg = model.cfg
    rng = np.random.default_rng(PIPE_SEED)
    mbs = [rng.integers(0, cfg.vocab_size, (1, PREFILL_S))
           for _ in range(PIPE_MICROBATCHES)]
    name = (f"pipeline qwen3-1.7b {PIPE_STAGES} stages, {PIPE_MICROBATCHES} "
            f"x 1x{PREFILL_S} bf16, depth {PIPE_DEPTH}")
    fused = [model.forward(params, {"tokens": mb})[0] for mb in mbs]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for mb in mbs:
        model.forward(params, {"tokens": mb})
    torch.cuda.synchronize()
    fused_ms = (time.perf_counter() - t0) * 1e3
    with ActorSystem(name="pipeline") as system:
        runner = PipelineRunner(system, make_layer_stage_actors(
            system, model, params, n_stages=PIPE_STAGES), depth=PIPE_DEPTH)
        runner.run(mbs[:1])                            # warm up
        before = registry.stats()
        t0 = time.perf_counter()
        refs = run_phase(name, ["flash_attention"],
                         lambda: runner.run(mbs, emit="ref"),
                         {"flash_attention_bf16":
                          cfg.n_layers * PIPE_MICROBATCHES})
        staged_ms = (time.perf_counter() - t0) * 1e3
        after = registry.stats()
    moved = {k: after[k] - before[k] for k in ("transfers", "spills")}
    check(moved == {"transfers": 0, "spills": 0},
          f"{name}: the activation moved through the host: {moved}")
    gates, diffs = [], []
    for i, (ref, want) in enumerate(zip(refs, fused)):
        check(isinstance(ref, DeviceRef) and ref.device == dev,
              f"{name}: microbatch {i} came back as {type(ref).__name__} on "
              f"{getattr(ref, 'device', None)}")
        got = ref.array
        diffs.append(max_abs_err(got.float(), want.float()))
        gates.append(prefill_gates(f"{name}, microbatch {i}", got, want))
        ref.release()
    out = dict(stages=PIPE_STAGES, depth=PIPE_DEPTH,
               microbatches=PIPE_MICROBATCHES, tokens=PREFILL_S,
               flash_attention_launches=cfg.n_layers * PIPE_MICROBATCHES,
               max_abs_diff=max(diffs), gates=gates, staged_ms=staged_ms,
               fused_ms=fused_ms, **moved)
    log(f"{name}: staged logits against the fused forward: max |diff| "
        f"{out['max_abs_diff']} (0 expected: the same ops in the same "
        f"order); staged wall {staged_ms:.3f} ms, {PIPE_MICROBATCHES} fused "
        f"forwards {fused_ms:.3f} ms; transfers and spills {moved}")
    del fused, refs
    return out


def collectives_phase(dev) -> dict:
    """``compressed_psum`` and ``tree_psum_with_error_feedback`` over a
    world of one on nccl (one card: a smoke only). The sum of one rank is
    its own dequantized payload, bit for bit; the mean the same, and the
    new error the residual."""
    import torch.distributed as dist
    from repro_torch.dist.collectives import (_quantize, compressed_psum,
                                              tree_psum_with_error_feedback)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=dev)
    try:
        x = torch.randn(1 << COLL_LOG2, generator=torch.Generator(
            device=dev).manual_seed(0), device=dev)
        deq = _quantize(x)[2]
        got = compressed_psum(x)
        check(torch.equal(got.view(torch.int32), deq.view(torch.int32)),
              "compressed_psum over one rank differs from its dequantized "
              "payload")
        mean, err = tree_psum_with_error_feedback({"g": x},
                                                  {"g": torch.zeros_like(x)})
        check(torch.equal(mean["g"], deq) and torch.equal(err["g"], x - deq),
              "tree_psum_with_error_feedback over one rank: the mean is "
              "not the payload or the error not the residual")
        out = dict(n=x.numel(), backend=dist.get_backend(),
                   world=dist.get_world_size(),
                   max_abs_err=max_abs_err(got, x),
                   ms=cuda_ms(lambda: compressed_psum(x), 10))
    finally:
        dist.destroy_process_group()
    log(f"compressed_psum 2^{COLL_LOG2} f32 over a world of 1 (nccl): bit "
        f"for bit its dequantized payload, {out['ms']:.4f} ms a call; "
        f"quantization error {out['max_abs_err']}")
    return out


def roofline_child(queue) -> None:
    """The roofline phase's dry run: ``lower_cell`` of each ROOF_SHAPES
    cell on a 1 x 1 mesh of a one-rank ``fake`` group, in a process of its
    own (the group is process-wide, and the parent runs a nccl one)."""
    import traceback
    try:
        from repro_torch import configs
        from repro_torch.launch import dryrun_lib
        from repro_torch.launch.dryrun import start_fake_group
        from repro_torch.launch.mesh import make_mesh
        start_fake_group(1)
        configs.SHAPES.update(ROOF_SHAPES)
        mesh = make_mesh((1, 1), ("data", "model"))
        out = {}
        for shape in ROOF_SHAPES:
            t0 = time.perf_counter()
            out[shape] = dryrun_lib.lower_cell("qwen3-1.7b", shape, mesh,
                                               "1x1", plan_overrides=ROOF_PLAN)
            out[shape]["child_s"] = time.perf_counter() - t0
        queue.put(("ok", out))
    except BaseException:
        queue.put(("error", traceback.format_exc()))
        raise


def wall_ms(fn, reps: int) -> list:
    """The sorted host walls of ``reps`` calls of ``fn``, each ending in a
    synchronize, in ms (one untimed call first)."""
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return sorted(walls)


def optimizer_bytes(state, plan, where) -> float:
    """The bytes the roofline counter counts in the train step's AdamW
    update alone: on ``state``'s own tensors on the card (the kernel), or
    on ``"meta"`` tensors of their shapes (the loop, as on the dry run's
    DTensors), with zero gradients of the step's dtype (the accumulator's
    under ``grad_accum``)."""
    import torch.utils._pytree as pytree

    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.roofline.counter import count
    gdt = getattr(torch, plan.accum_dtype) if plan.grad_accum > 1 else None
    params, opt = state["params"], state["opt"]
    if where == "meta":
        params, opt = (pytree.tree_map(
            lambda t: torch.empty_like(t, device="meta"), x)
            for x in (params, opt))
    grads = pytree.tree_map(
        lambda t: torch.zeros_like(t, dtype=gdt or t.dtype), params)
    ocfg = AdamWConfig(state_dtype=plan.opt_dtype)
    _, st = count(lambda: adamw.update(grads, opt, params, ocfg, 1.0),
                  torch.device(where).type)
    return st.bytes_accessed


def adamw_kernel_bytes(state, plan) -> int:
    """The bytes the AdamW kernel moves in one train step, which the
    roofline counter cannot see (a ctypes launch): each gradient read
    twice (the norm and the update), each parameter, ``m`` and ``v`` read
    and written once."""
    import torch.utils._pytree as pytree
    gdt = getattr(torch, plan.accum_dtype) if plan.grad_accum > 1 else None
    opt = state["opt"]
    return sum(2 * p.numel() * ((gdt or p.dtype).itemsize + p.element_size()
                                + m.element_size() + v.element_size())
               for p, m, v in zip(*(pytree.tree_leaves(t) for t in (
                   state["params"], opt["m"], opt["v"]))))


def roofline_cell(run_phase, shape: str, meta_for, dev) -> dict:
    """One ROOF_SHAPES cell on the card: the counter over the step on real
    tensors (plain attention), the step's wall, profiled busy time, peak
    memory and MFU (the prefill with B6, the train step with the plain
    attention: B6 has no backward); then the counts held to the dry run's
    report, ``meta_for(shape)``."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun_lib
    from repro_torch.roofline.analysis import model_flops_for
    from repro_torch.roofline.counter import count
    cfg = get_config("qwen3-1.7b")
    seq, batch, kind = ROOF_SHAPES[shape]
    name = f"roofline qwen3-1.7b {kind} {batch}x{seq} bf16"
    base = torch.cuda.memory_allocated()
    run, args, plan = dryrun_lib.device_cell(cfg, shape, dev,
                                             plan_overrides=ROOF_PLAN)
    allocated = torch.cuda.memory_allocated() - base
    arg_bytes = dryrun_lib.argument_bytes(args)
    run()                                   # warm up
    torch.cuda.synchronize()
    _, st = run_phase(f"{name} counted", [], lambda: count(
        run, torch.device(dev).type, seq_dims={seq, 512, 1024, 2048}))
    if kind == "prefill":
        timed, _, _ = dryrun_lib.device_cell(
            cfg, shape, dev, plan_overrides={"attn_impl": "kernel"})
        attn = "kernel"
    else:
        timed, attn = run, "ref"
    walls = run_phase(f"{name} timed ({attn} attention)",
                      ["flash_attention"] if attn == "kernel" else [],
                      lambda: wall_ms(timed, ROOF_REPS))
    # the peak of the counted program (plain attention), as predicted
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    del out
    busy = profiled_busy_ms(timed)
    args_state = args[0] if kind == "train" else None
    del timed, run, args
    torch.cuda.empty_cache()

    meta = meta_for(shape)
    rl = meta["roofline"]
    mem = rl["memory_per_device"]
    # the card's AdamW goes through its kernel and the dry run's DTensors
    # through the loop, so the optimizer's bytes differ by design: held
    # equal is the step less the optimizer, each side's counted alone
    opt_card = opt_meta = 0.0
    kernel_bytes = 0
    if kind == "train":
        opt_card, opt_meta = (optimizer_bytes(args_state, plan, where)
                              for where in (dev, "meta"))
        kernel_bytes = adamw_kernel_bytes(args_state, plan)
    log(f"{name}: meta {rl['flops_per_device']:.6e} FLOPs "
        f"{rl['bytes_per_device']:.6e} bytes, card {st.flops:.6e} FLOPs "
        f"{st.bytes_accessed:.6e} bytes; arguments meta "
        f"{mem['argument_size_in_bytes']:.0f} B, card tensors {arg_bytes} B "
        f"({allocated} B allocated for them)")
    check(plan.to_dict() == meta["plan"], f"{name}: the card's plan "
          f"{plan.to_dict()} is not the dry run's {meta['plan']}")
    check(st.flops == rl["flops_per_device"],
          f"{name}: the card counts {st.flops} FLOPs, the dry run "
          f"{rl['flops_per_device']}")
    check(st.bytes_accessed - opt_card == rl["bytes_per_device"] - opt_meta,
          f"{name}: the card counts {st.bytes_accessed} bytes ({opt_card} "
          f"of them AdamW's), the dry run {rl['bytes_per_device']} "
          f"({opt_meta} AdamW's)")
    check(arg_bytes == mem["argument_size_in_bytes"],
          f"{name}: the step's tensors hold {arg_bytes} bytes, the dry run "
          f"says {mem['argument_size_in_bytes']}")
    wall = walls[len(walls) // 2]
    model_flops = model_flops_for(cfg, shape, seq, batch, kind)
    # the card's bytes: the counted step and the AdamW kernel's, which the
    # counter cannot see; the dry run's count the loop's instead
    card_bytes = st.bytes_accessed + kernel_bytes
    memory_ms = bytes_ms(card_bytes)
    bound_ms = max(rl["compute_s"] * 1e3, memory_ms)
    res = dict(
        kind=kind, batch=batch, seq=seq, plan=meta["plan"],
        flops=st.flops, bytes=st.bytes_accessed,
        flops_by_op=st.flops_by_op, argument_bytes=arg_bytes,
        allocated_for_arguments=allocated,
        temp_bytes_meta=mem["temp_size_in_bytes"],
        temp_bytes_card_count=st.peak_live_bytes,
        peak_allocated_bytes=peak, compute_ms=rl["compute_s"] * 1e3,
        memory_ms=memory_ms, memory_ms_dry_run=rl["memory_s"] * 1e3,
        bound_ms=bound_ms, card_bytes=card_bytes,
        bottleneck="compute" if rl["compute_s"] * 1e3 >= memory_ms
        else "memory", timed_attention=attn,
        wall_ms=walls, wall_ms_median=wall, device_busy_ms=busy,
        model_flops=model_flops, mfu=model_flops / (BF16_FLOPS * wall / 1e3),
        busy_over_bound=busy / bound_ms, dry_run_s=meta["child_s"],
        adamw_bytes_card=opt_card, adamw_bytes_dry_run=opt_meta,
        adamw_kernel_bytes=kernel_bytes)
    del args_state
    log(f"{name}: {attn} attention wall median {wall:.3f} ms, device busy "
        f"{busy:.3f} ms (profiled) against compute {res['compute_ms']:.3f} "
        f"ms, memory {memory_ms:.3f} ms ({card_bytes:.6e} bytes with the "
        f"AdamW kernel's {kernel_bytes:.6e}; the dry run's "
        f"{res['memory_ms_dry_run']:.3f} ms with the loop's), bound "
        f"{bound_ms:.3f} ms ({res['bottleneck']}); MFU {res['mfu']:.4f}; "
        f"temp predicted {mem['temp_size_in_bytes'] / 1e9:.3f} GB (card count "
        f"{st.peak_live_bytes / 1e9:.3f}), peak allocated above the "
        f"arguments by the plain-attention step {peak / 1e9:.3f} GB; dry run "
        f"{meta['child_s']:.1f} s")
    return res


def roofline_phase(run_phase, card: str, dev) -> dict:
    """qwen3-1.7b's prefill and train step at full width: the dry run in a
    spawned child while the same steps are counted and timed on the card
    (``roofline_cell``), then the two held equal."""
    import multiprocessing as mp
    import queue as queue_mod
    from repro_torch import configs
    configs.SHAPES.update(ROOF_SHAPES)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    child = ctx.Process(target=roofline_child, args=(results,))
    t0 = time.perf_counter()
    child.start()
    metas = {}

    def meta_for(shape: str) -> dict:
        if not metas:
            try:
                status, payload = results.get(timeout=900)
            except queue_mod.Empty:
                payload, status = None, "timeout"
            child.join(timeout=60)
            if child.is_alive():
                child.kill()
                child.join(timeout=30)
            check(status == "ok" and child.exitcode == 0,
                  f"roofline dry-run child: {status}, exit code "
                  f"{child.exitcode}\n{payload}")
            metas.update(payload)
            metas["wall_s"] = time.perf_counter() - t0
        return metas[shape]

    try:
        out = {"card": card}
        for shape in ROOF_SHAPES:
            out[shape] = roofline_cell(run_phase, shape, meta_for, dev)
    finally:
        if child.is_alive():
            child.kill()
            child.join(timeout=30)
    out["dry_run_wall_s"] = metas["wall_s"]
    return out


def adamw_row(dev) -> dict:
    """The AdamW kernel (``kernels/adamw.py``) at qwen3-1.7b's full
    parameter tree: each leaf's sum of squares against ``torch.sum``, the
    update against the loop (``optim.adamw.leaf_update``) to the bit at
    the same scalars, the kernels' CUDA-event times beside their bounds,
    the whole ``adamw.update`` call's profiled device time and host time,
    the loop's, and ``torch._fused_adamw_``'s (a yardstick the port never
    calls: it takes one dtype for all four lists, so f32 throughout, 28
    bytes a parameter)."""
    import torch.utils._pytree as pytree

    from repro_torch.configs import get_config
    from repro_torch.kernels.adamw import KERNEL, Leaves
    from repro_torch.models import Model
    from repro_torch.models.layers import plain_tree
    from repro_torch.optim import AdamWConfig, adamw
    cfg = get_config("qwen3-1.7b")
    shapes = pytree.tree_leaves(plain_tree(Model(cfg, device="meta")
                                           .param_shapes()))
    gen = torch.Generator(device=dev).manual_seed(30)
    draw = lambda t, scale: torch.randn(t.shape, generator=gen,
                                        device=dev) * scale
    p = [draw(t, 0.02).bfloat16() for t in shapes]
    g = [draw(t, 1e-3).bfloat16() for t in shapes]
    m = [draw(t, 1e-4) for t in shapes]
    v = [draw(t, 1e-4).square() for t in shapes]
    n = sum(t.numel() for t in p)
    ocfg = AdamWConfig()
    # the scalars of a step at count 3, from the kernel's own norm
    sums = Leaves(g, m, v, p, torch.float32).sums_of_squares()
    want = torch.stack([torch.sum(torch.square(x.float())) for x in g])
    sum_rel = float(((sums.double() - want.double()).abs() /
                     want.double()).max())
    gnorm = torch.sqrt(torch.sum(sums))
    gnorm_rel = rel_err(gnorm, adamw.global_norm(g))
    check(sum_rel <= ADAMW_SUM_RTOL and gnorm_rel <= ADAMW_SUM_RTOL,
          f"adamw: leaf sums of squares off by {sum_rel}, norm by "
          f"{gnorm_rel} (limit {ADAMW_SUM_RTOL})")
    scale = torch.clamp(ocfg.clip_norm / (gnorm + 1e-9), max=1.0)
    c = torch.tensor(3.0, device=dev)
    bc1, bc2 = 1.0 - torch.pow(ocfg.b1, c), 1.0 - torch.pow(ocfg.b2, c)
    scalars = torch.stack([scale, bc1, bc2,
                           torch.full((), ocfg.lr, device=dev)])
    leaves = Leaves(g, m, v, p, torch.float32)

    def update():
        return leaves.update(scalars, b1=ocfg.b1, b2=ocfg.b2, eps=ocfg.eps,
                             weight_decay=ocfg.weight_decay)

    got = update()
    differ = 0
    for i, (gi, mi, vi, pi) in enumerate(zip(g, m, v, p)):
        loop = adamw.leaf_update(gi * scale.to(gi.dtype), mi, vi, pi, bc1,
                                 bc2, ocfg.lr, ocfg)
        differ += sum(not same_bits(a, b) for a, b in
                      zip(loop, (got[0][i], got[1][i], got[2][i])))
    check(differ == 0, f"adamw: {differ} output leaves differ from the "
          "loop's bits")
    del got, loop
    out = dict(kernel=KERNEL, params=n, leaves=len(p), sum_rel=sum_rel,
               gnorm_rel=gnorm_rel, bitwise_leaves=3 * len(p))
    out["ms"] = cuda_ms(update, 10)
    out["bound_ms"] = bytes_ms(ADAMW_UPDATE_BYTES * n)
    out["norm_ms"] = cuda_ms(leaves.sums_of_squares, 10)
    out["norm_bound_ms"] = bytes_ms(ADAMW_NORM_BYTES * n)
    del leaves
    torch.cuda.empty_cache()
    params = {f"w{i}": t for i, t in enumerate(p)}
    state = {"m": {f"w{i}": t for i, t in enumerate(m)},
             "v": {f"w{i}": t for i, t in enumerate(v)},
             "count": torch.tensor(2, dtype=torch.int32, device=dev)}
    grads = {f"w{i}": t for i, t in enumerate(g)}
    before = dict(KERNEL.function_launches)
    adamw.update(grads, state, params, ocfg)
    torch.cuda.synchronize()
    after = KERNEL.function_launches
    out["launches_a_call"] = {k: after[k] - before.get(k, 0) for k in after}
    check(out["launches_a_call"] == ADAMW_A_STEP,
          f"adamw.update launched {out['launches_a_call']}")
    out["call_device_ms"] = profiled_busy_ms(
        lambda: adamw.update(grads, state, params, ocfg))
    out["call_bound_ms"] = bytes_ms((ADAMW_UPDATE_BYTES + ADAMW_NORM_BYTES)
                                    * n)
    out["call_host_us"] = host_us(
        lambda: adamw.update(grads, state, params, ocfg), 3)

    def loop():
        gn = adamw.global_norm(g)
        sc = torch.clamp(ocfg.clip_norm / (gn + 1e-9), max=1.0)
        return [adamw.leaf_update(gi * sc.to(gi.dtype), mi, vi, pi, bc1,
                                  bc2, ocfg.lr, ocfg)
                for gi, mi, vi, pi in zip(g, m, v, p)]
    out["plain_ms"] = profiled_busy_ms(loop)
    out["plain_host_us"] = host_us(loop, 1, rounds=3)
    del params, state, grads
    torch.cuda.empty_cache()
    # the library yardstick, f32 parameters and gradients over m and v
    p32 = [t.float() for t in p]
    g32 = [t.float() for t in g]
    del p, g
    steps = [torch.tensor(3.0, device=dev) for _ in p32]
    out["library_ms"] = cuda_ms(lambda: torch._fused_adamw_(
        p32, g32, m, v, [], steps, lr=ocfg.lr, beta1=ocfg.b1,
        beta2=ocfg.b2, weight_decay=ocfg.weight_decay, eps=ocfg.eps,
        amsgrad=False, maximize=False), 10)
    out["library"] = ("torch._fused_adamw_, f32 params, grads, m, v (28 "
                      "bytes a parameter)")
    out["library_bound_ms"] = bytes_ms(28 * n)
    del p32, g32, m, v, steps
    torch.cuda.empty_cache()
    log(f"adamw qwen3-1.7b tree ({len(shapes)} leaves, {n} parameters): "
        f"update kernel {out['ms']:.4f} ms against a bound of "
        f"{out['bound_ms']:.4f} ms ({out['bound_ms'] / out['ms']:.3f} of "
        f"it); norm {out['norm_ms']:.4f} ms (bound "
        f"{out['norm_bound_ms']:.4f}); adamw.update {out['call_device_ms']:.3f}"
        f" ms of device (bound {out['call_bound_ms']:.3f}), "
        f"{out['call_host_us'] / 1e3:.3f} ms of host, launches "
        f"{out['launches_a_call']}; the loop {out['plain_ms']:.3f} ms of "
        f"device, {out['plain_host_us'] / 1e3:.3f} ms of host; "
        f"torch._fused_adamw_ f32 {out['library_ms']:.4f} ms (bound "
        f"{out['library_bound_ms']:.4f}); {3 * len(shapes)} output leaves "
        f"equal to the loop's bits; leaf sums within {sum_rel:.3g}, norm "
        f"within {gnorm_rel:.3g}")
    return out


def matmul_row(x, y, reps: int) -> dict:
    """B1's ``x @ y`` held to its plain version within MM_TOL, and its
    time beside the plain version's and ``torch.matmul``'s, its bound and
    the host's time a call."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.matmul import matmul as matmul_kernel
    dt, tol = x.dtype, MM_TOL[x.dtype]
    (m, k), n = x.shape, y.shape[1]
    got, want = matmul_kernel(x, y), ref.matmul(x, y)
    check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
          f"matmul {dt} {m}x{k}x{n} disagrees with the plain version beyond "
          f"{tol}")
    peak = F32_FLOPS if dt == torch.float32 else BF16_FLOPS
    return dict(
        max_abs_err=max_abs_err(got.float(), want.float()),
        ms=cuda_ms(lambda: matmul_kernel(x, y), reps),
        plain_ms=cuda_ms(lambda: ref.matmul(x, y), reps),
        bound_ms=max(bytes_ms((m * k + k * n + m * n) * x.element_size()),
                     ops_ms(2.0 * m * n * k, peak)),
        bound_by="operations",
        library_ms=cuda_ms(lambda: torch.matmul(x, y), reps),
        host_us=host_us(lambda: matmul_kernel(x, y), 20),
        library_host_us=host_us(lambda: torch.matmul(x, y), 20))


def sort_row(keys, pos, reps: int, plain_reps: int) -> dict:
    """``ops.radix_sort`` (one radix_histogram and 4 radix_onesweep
    passes) of uint32 ``keys`` with the int32 payload ``pos``, bit for bit
    its plain version's, timed beside it and ``torch.sort`` of the keys as
    int64; its bound is the keys and payload read and written once."""
    from repro_torch.kernels import ops, ref
    got_k, got_p = ops.radix_sort(keys, pos)
    want_k, want_p = ops.radix_sort(keys, pos, impl="ref")
    check(words_equal(got_k, want_k) and torch.equal(got_p, want_p),
          f"ops.radix_sort n={keys.numel()} differs from its plain version")
    wide = ref.u32_to_i64(keys)
    return dict(
        max_abs_err=max(max_abs_err(got_k, want_k),
                        max_abs_err(got_p, want_p)),
        ms=cuda_ms(lambda: ops.radix_sort(keys, pos), reps),
        plain_ms=cuda_ms(lambda: ops.radix_sort(keys, pos, impl="ref"),
                         plain_reps),
        bound_ms=bytes_ms(keys.numel() * 16), bound_by="bytes",
        library_ms=cuda_ms(lambda: torch.sort(wide, stable=True), reps),
        library="torch.sort(stable=True) of the keys as int64",
        host_us=host_us(lambda: ops.radix_sort(keys, pos), 10),
        library_host_us=host_us(lambda: torch.sort(wide, stable=True), 10))


def interleave_row(fills, lits, reps: int) -> dict:
    """B4's interleave of uint32 ``fills`` and ``lits``, bit for bit its
    plain version's, timed beside it and a stack of the two; its bound is
    both inputs read and the interleave written once."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.wah import wah_interleave
    n = fills.numel()
    out_i, out_p = wah_interleave(fills, lits), ref.wah_interleave(fills, lits)
    check(words_equal(out_i, out_p), f"wah_interleave n={n} disagrees")
    fv, lv = fills.view(torch.int32), lits.view(torch.int32)
    return dict(
        max_abs_err=max_abs_err(out_i, out_p),
        ms=cuda_ms(lambda: wah_interleave(fills, lits), reps),
        plain_ms=cuda_ms(lambda: ref.wah_interleave(fills, lits), reps),
        bound_ms=bytes_ms(n * 4 * 2 + n * 8), bound_by="bytes",
        library_ms=cuda_ms(lambda: torch.stack((fv, lv), 1).reshape(-1),
                           reps),
        library="torch.stack((f, l), 1).reshape(-1)")


def compact_row(words, reps: int, plain_reps: int) -> dict:
    """B5's block compaction of uint32 ``words`` (zeros dropped), bit for
    bit its plain version's, timed beside it and ``x[x != 0]``; its bound
    is the words read, the blocks written and a count a block."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.stream_compact import local_compact
    n = words.numel()
    bl, cn = local_compact(words)
    bl_p, cn_p = ref.local_compact(words)
    check(words_equal(bl, bl_p) and torch.equal(cn, cn_p),
          f"local_compact n={n} disagrees")
    w32 = words.view(torch.int32)
    return dict(
        max_abs_err=max_abs_err(bl, bl_p),
        ms=cuda_ms(lambda: local_compact(words), reps),
        plain_ms=cuda_ms(lambda: ref.local_compact(words), plain_reps),
        bound_ms=bytes_ms(n * 4 + n * 4 + (n // 256) * 4), bound_by="bytes",
        library_ms=cuda_ms(lambda: w32[w32 != 0], reps), library="x[x != 0]")


def example_kernel_rows(rows, quick: dict, values: np.ndarray, dev) -> None:
    """B1 on the quickstart's own 512^2 f32 matrices and B3-B5 at the
    shapes ``build_wah_index`` gives them for the WAH example's 2^17
    ``values`` (a sort of its 2^17 keys with an int32 payload, the
    interleave of 2^17 fills and literals, the compaction of their 2^18
    words), by the main rows' helpers: sub-rows of the kernels' entries.
    These launches do not count."""
    from repro_torch.kernels import ref
    gen = np.random.default_rng(7)
    a, b = (torch.from_numpy(quick[k]).to(dev) for k in ("m1", "m2"))
    rows["matmul"]["quickstart_f32_512"] = dict(
        matmul_row(a, b, 50), library="torch.matmul f32 (TF32 off)")
    m = values.shape[0]
    rows["radix_pass"]["wah_example_2^17"] = dict(
        sort_row(torch.from_numpy(values).to(dev),
                 torch.arange(m, dtype=torch.int32, device=dev), 50, 10),
        what="ops.radix_sort: 1 radix_histogram + 4 radix_onesweep")
    fills, lits = (ref.i64_to_u32(torch.from_numpy(
        gen.integers(0, 2 ** 32, m, dtype=np.int64)).to(dev))
        for _ in range(2))
    rows["wah_interleave"]["wah_example_2^17"] = interleave_row(fills, lits,
                                                                50)
    words = torch.where(torch.from_numpy(gen.random(2 * m) < 0.5).to(dev),
                        torch.cat([fills, lits]).view(torch.int32),
                        0).view(torch.uint32)
    rows["local_compact"]["wah_example_2^18"] = compact_row(words, 50, 10)
    for name, key in (("matmul", "quickstart_f32_512"),
                      ("radix_pass", "wah_example_2^17"),
                      ("wah_interleave", "wah_example_2^17"),
                      ("local_compact", "wah_example_2^18")):
        r = rows[name][key]
        log(f"{name} at the examples' {key}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}); max_abs_err "
            f"{r['max_abs_err']}")


def examples_phase(run_phase, rows, dev) -> dict:
    """The six user examples of ``repro_torch.examples``, each through its
    ``run`` on the card (see EXAMPLE_*); returns each one's readings."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.dist.step import build_serve_step
    from repro_torch.examples import (dist_pipeline, graph_diamond,
                                      quickstart, serve_lm, train_lm,
                                      wah_indexing)
    from repro_torch.kernels import ref
    from repro_torch.models import Model
    out = {}

    def timed(name, needs, body, functions=None):
        t0 = time.perf_counter()
        result = run_phase(name, needs, body, functions)
        return result, time.perf_counter() - t0

    quick, wall = timed("example quickstart m_mult 512x512 f32", ["matmul"],
                        quickstart.run)
    want = ref.matmul(torch.from_numpy(quick["m1"]).to(dev),
                      torch.from_numpy(quick["m2"]).to(dev)).cpu().numpy()
    check(quick["result"].shape == (EXAMPLE_MM_N,) * 2
          and np.isfinite(quick["result"]).all(), "quickstart: bad product")
    np.testing.assert_allclose(quick["result"], want,
                               rtol=MM_TOL[torch.float32],
                               atol=MM_TOL[torch.float32])
    out["quickstart"] = dict(wall_s=wall, norm=quick["norm"],
                             platforms=[repr(p) for p in quick["platforms"]])
    log(f"example quickstart: m_mult ok, equal to the plain product within "
        f"{MM_TOL[torch.float32]}, |result|_F = {quick['norm']:.1f}")

    r, wall = timed(f"example wah_indexing n={EXAMPLE_WAH_N}",
                    ["radix_pass", "wah_interleave", "local_compact"],
                    wah_indexing.run,
                    {"radix_histogram": 1, "radix_onesweep": 4,
                     "radix_pass": 0})
    host = wah_indexing.run(device="cpu")
    for key in ("words", "starts", "counts", "out"):
        check(r[key].dtype == host[key].dtype and
              np.array_equal(r[key], host[key]),
              f"wah_indexing: {key} differs from run(device='cpu')")
    check(r["n_words"] == host["n_words"] and r["total"] == host["total"],
          "wah_indexing: n_words or total differs from the CPU's")
    out["wah_indexing"] = dict(wall_s=wall, build_s=r["seconds"],
                               n_words=r["n_words"], total=r["total"])
    log(f"example wah_indexing: {r['n_words']} words, build "
        f"{r['seconds']:.4f} s, pipeline {r['total']} words; bit for bit "
        "the CPU's")
    example_kernel_rows(rows, quick, r["values"], dev)

    r, wall = timed("example graph_diamond", [], graph_diamond.run)
    check(set(r["placements"].values()) == {f"{dev.type}:{dev.index or 0}"},
          f"graph_diamond placed off the card: {r['placements']}")
    check(r["readbacks"] == 1 and r["transfers"] <= 1,
          f"graph_diamond: {r['transfers']} transfers, {r['readbacks']} "
          "read-backs (the input in, the output out only)")
    check(r["error"].startswith("bad/double:"),
          f"graph_diamond: build error {r['error']!r}")
    out["graph_diamond"] = dict(wall_s=wall, transfers=r["transfers"],
                                readbacks=r["readbacks"], error=r["error"])

    cfg = get_config("qwen3-1.7b")
    model = Model(cfg, device=dev)
    params = model.init(0)
    name = f"example serve_lm qwen3-1.7b {serve_lm.BATCH}x{serve_lm.STEPS}"
    r, wall = timed(name, [], lambda: serve_lm.run(cfg, params))
    # the example returns tokens: its step (the plain attention, the
    # Model's default) run outside the actor and fed them one at a time
    # must pick each next one, which holds the actor's wiring (the cache
    # carried from message to message); a step's logits must be finite
    toks = torch.from_numpy(r["tokens"]).to(dev).long()
    step = build_serve_step(model)
    cache = model.init_cache(serve_lm.BATCH, serve_lm.STEPS + 1)
    with torch.no_grad():
        for t in range(serve_lm.STEPS):
            nxt, logits, cache = step(params, cache, toks[:, t:t + 1])
            check(torch.equal(nxt.long(), toks[:, t + 1:t + 2]) and
                  bool(torch.isfinite(logits).all()),
                  f"{name}: step {t} picked other tokens than the example's "
                  "actor, or its logits are not finite")
    out["serve_lm"] = dict(wall_s=wall, decode_s=r["seconds"],
                           tok_s=r["tok_s"], replayed_steps=serve_lm.STEPS)
    log(f"example serve_lm: {r['tok_s']:.1f} tok/s on the card "
        f"({serve_lm.STEPS} steps x {serve_lm.BATCH} requests in "
        f"{r['seconds']:.3f} s); the step replayed outside the actor picks "
        "the same tokens")
    del r, params, model, cache, logits, toks
    torch.cuda.empty_cache()

    tcfg = dataclasses.replace(cfg, n_layers=EXAMPLE_TRAIN_LAYERS)
    name = (f"example train_lm qwen3-1.7b {EXAMPLE_TRAIN_LAYERS} layers "
            f"{EXAMPLE_TRAIN_STEPS} steps of {EXAMPLE_TRAIN_B}x"
            f"{EXAMPLE_TRAIN_S}")
    r, wall = timed(name, [], lambda: train_lm.run(
        tcfg, steps=EXAMPLE_TRAIN_STEPS, batch=EXAMPLE_TRAIN_B,
        seq=EXAMPLE_TRAIN_S, fail_at=EXAMPLE_TRAIN_FAIL_AT))
    check(r["steps"] == EXAMPLE_TRAIN_STEPS and r["recoveries"] == 1
          and r["loss_n"] < r["loss0"] and np.isfinite(r["losses"]).all(),
          f"{name}: {r}")
    out["train_lm"] = {k: r[k] for k in ("steps", "recoveries", "fail_at",
                                         "loss0", "loss_n", "seconds",
                                         "tok_s")}
    out["train_lm"]["wall_s"] = wall
    log(f"example train_lm: loss {r['loss0']:.4f} -> {r['loss_n']:.4f}, "
        f"{r['recoveries']} recovery, {r['tok_s']:,.0f} tok/s wall on the "
        "card")
    torch.cuda.empty_cache()

    r, wall = timed("example dist_pipeline", [], dist_pipeline.run)
    check(r["device"] == str(dev) and r["chunks"] == 12,
          f"dist_pipeline: {r}")
    out["dist_pipeline"] = dict(wall_s=wall, rel_err=r["rel_err"],
                                reissued=r["reissued"],
                                sources=sorted(r["sources"]))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()

    import dataclasses

    from repro_torch.core import ActorSystem
    from repro_torch.core.memref import registry
    from repro_torch.examples.mandelbrot_offload import run as run_offload
    from repro_torch.indexing import (build_wah_index, decode_wah_bitmap,
                                      wah_index_pipeline_actors)
    from repro_torch.kernels import (FLASH_ATTENTION, KERNELS, LOCAL_COMPACT,
                                     MANDELBROT, MATMUL, RADIX_PASS,
                                     WAH_INTERLEAVE, build_all, ops, ref)
    from repro_torch.kernels.build import device_sm_count
    from repro_torch.kernels.flash_attention import (HEAD_DIMS,
                                                     SLAB_WIDTHS,
                                                     f32_query_tile,
                                                     f32_query_tiles,
                                                     flash_attention,
                                                     kernel_info,
                                                     kernel_slabs)
    from repro_torch.kernels.mandelbrot import mandelbrot as mandelbrot_kernel
    from repro_torch.kernels.matmul import kernel_info as matmul_kernel_info
    from repro_torch.kernels.matmul import matmul as matmul_kernel
    from repro_torch.models import Model
    from repro_torch.kernels.radix_sort import (OnesweepScratch,
                                                radix_histogram,
                                                radix_onesweep, radix_pass)
    from repro_torch.kernels.radix_sort import kernel_info as radix_kernel_info
    from repro_torch.kernels.stream_compact import local_compact

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    build_s = build_all(KERNELS)
    log(f"built {len(KERNELS)} kernels in {build_s:.2f} s")
    fa_info = []
    for d in HEAD_DIMS:
        info = kernel_info(d)
        log(f"flash_attention bf16 kernel, head dim {d}: {info['registers']} "
            f"registers a thread at launch, {info['spill_bytes']} spill "
            f"bytes, {info['smem_bytes']} bytes of shared memory a block; "
            f"P.V: {info['pv']}")
        fa_info.append(info)
        for tile in f32_query_tiles(d):
            info = kernel_info(d, torch.float32, tile)
            log(f"flash_attention f32 kernel, head dim {d}, {tile}-row query "
                f"tile: {info['registers']} registers a thread, "
                f"{info['spill_bytes']} spill bytes, {info['smem_bytes']} "
                "bytes of shared memory a block")
            fa_info.append(info)
    # the slab kernels, each at a head dim that runs on it
    slab_dims = {kernel_slabs(d)[1]: d for d in FA_ABOVE_D}
    check(sorted(slab_dims) == sorted(SLAB_WIDTHS),
          f"FA_ABOVE_D runs on slabs {sorted(slab_dims)}, not {SLAB_WIDTHS}")
    for w in SLAB_WIDTHS:
        for dtype in (torch.bfloat16, torch.float32):
            info = kernel_info(slab_dims[w], dtype)
            log(f"flash_attention {dtype} slab kernel, width {w} (head dim "
                f"{slab_dims[w]} in {info['slabs']} slabs): "
                f"{info['registers']} registers a thread at launch, "
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

    fa_sass = sass[FLASH_ATTENTION.name]
    d192_tc = [fn for fn in fa_sass
               if "flash_attention_tc_kernelILi192E" in fn]
    check(len(d192_tc) == 1 and fa_sass[d192_tc[0]]["HGMMA"] > 0,
          f"no bf16 D = 192 kernel with HGMMA among {list(fa_sass)}")
    log(f"sass flash_attention bf16 D = 192 ({d192_tc[0]}): "
        f"{fa_sass[d192_tc[0]]}")
    slab_tc = [fn for fn in fa_sass if "flash_attention_tc_slab_kernel" in fn]
    check(len(slab_tc) == len(SLAB_WIDTHS), f"{len(slab_tc)} bf16 slab "
          f"kernels, not {len(SLAB_WIDTHS)}, among {list(fa_sass)}")

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    rows = {}

    # -- per-kernel phase: each kernel against its plain version ---------------
    a = torch.from_numpy(rng.random((MM_N, MM_N), np.float32)).to(dev)
    b = torch.from_numpy(rng.random((MM_N, MM_N), np.float32)).to(dev)
    mm = {}
    for x, y in ((a, b), (a.bfloat16(), b.bfloat16())):
        dt, tol = x.dtype, MM_TOL[x.dtype]
        r = mm[dt] = matmul_row(x, y, 10)
        log(f"matmul {dt} {MM_N}^3: kernel {r['ms']:.4f} ms, torch.matmul "
            f"{r['library_ms']:.4f} ms ({r['ms'] / r['library_ms']:.2f}x), "
            f"bound {r['bound_ms']:.4f} ms; host {r['host_us']:.1f} us a "
            f"call, torch.matmul {r['library_host_us']:.1f} us; max_abs_err "
            f"{r['max_abs_err']} (tol {tol} rel+abs)")
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
    rows["matmul"] = dict(
        mm[torch.float32], kernel=MATMUL,
        library="torch.matmul f32 (TF32 off)",
        bf16=dict(mm[torch.bfloat16], library="torch.matmul bf16"),
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
    sort = sort_row(rand_keys, pos, 10, 3)
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
        kernel=RADIX_PASS, max_abs_err=max(sort_err, sort["max_abs_err"]),
        ms=onesweep_ms(rand_keys, hist[0], 0, 20),
        plain_ms=cuda_ms(lambda: ref.radix_onesweep(rand_keys, pos, hist[0],
                                                    8, 0), 3),
        bound_ms=bytes_ms(WAH_N * 16), bound_by="bytes",
        library_ms=sort["library_ms"],
        library="torch.sort(stable=True) of the keys as int64 (values and "
                "permutation), against radix_sort_ms",
        onesweep_one_digit_ms=onesweep_ms(keys, wah_hist[1], 8, 20),
        histogram_ms=cuda_ms(lambda: radix_histogram(rand_keys), 20),
        histogram_plain_ms=cuda_ms(lambda: ref.radix_histogram(rand_keys, 8),
                                   3),
        histogram_bound_ms=bytes_ms(WAH_N * 4),
        radix_sort_ms=sort["ms"], radix_sort_plain_ms=sort["plain_ms"],
        # the sort's own bytes (keys and payload in and out), and the bytes
        # of this design: the histogram's read and 4 passes of 16 B a key
        # (the int32 payload rides through the passes)
        radix_sort_bound_ms=sort["bound_ms"],
        radix_sort_design_bound_ms=bytes_ms(WAH_N * (4 + 4 * 16)),
        library_int32_ms=cuda_ms(lambda: torch.sort(narrow_keys, stable=True),
                                 10),
        host_us=sort["host_us"], library_host_us=sort["library_host_us"],
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
    bl, cn = local_compact(words, drop_value=7)
    bl_p, cn_p = ref.local_compact(words, drop_value=7)
    check(words_equal(bl, bl_p) and torch.equal(cn, cn_p),
          "local_compact kernel disagrees (drop_value=7)")
    comp, total = ops.stream_compact(words)
    comp_p, total_p = ref.stream_compact(words)
    check(words_equal(comp, comp_p) and int(total) == int(total_p),
          "ops.stream_compact disagrees with the plain compaction")
    rows["local_compact"] = dict(compact_row(words, 20, 3),
                                 kernel=LOCAL_COMPACT)
    log(f"local_compact n=2^25: bit-exact for drop_value 0 and 7")
    del bl, cn, bl_p, cn_p, comp, comp_p

    lits = torch.cat([rand_keys[1:], rand_keys[:1]])
    rows["wah_interleave"] = dict(interleave_row(rand_keys, lits, 20),
                                  kernel=WAH_INTERLEAVE)
    log("wah_interleave n=2^24: bit-exact")
    del words, lits, rand_keys, keys, pos
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

    def sdpa(q, k, v):
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)

    q, k, v = qkv(*FA_LAYER, torch.bfloat16)
    rows["flash_attention"] = dict(
        kernel=FLASH_ATTENTION, max_abs_err=fa_err[f"bf16 causal S={FA_S}"],
        ms=cuda_ms(lambda: flash_attention(q, k, v, causal=True), 10),
        plain_ms=cuda_ms(lambda: ref.flash_attention(q, k, v, causal=True),
                         3),
        bound_ms=attention_bound_ms(q, k, v, True), bound_by="operations",
        library_ms=cuda_ms(lambda: sdpa(q, k, v), 10),
        library="F.scaled_dot_product_attention(is_causal=True, "
                "enable_gqa=True), bf16", instantiations=fa_info)
    # bf16 at three shapes over several seeds, in bf16 steps: the layer
    # shape and the two prefills' own launches, PREFILL_B x 16 (8 KV) heads
    # x PREFILL_S^2 x 128 and FA_LLAMA, causal
    sweep = []
    for shape in (FA_LAYER, FA_PREFILL, FA_LLAMA):
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

    for key, shape in (("prefill_shape", FA_PREFILL),
                       ("llama_prefill_shape", FA_LLAMA)):
        q, k, v = attention_inputs(
            shape, torch.bfloat16, torch.Generator(device=dev).manual_seed(0),
            dev)
        rows["flash_attention"][key] = dict(
            shape=list(shape),
            max_abs_err=next(r["max_abs_err"] for r in sweep
                             if r["shape"] == list(shape) and r["seed"] == 0),
            ms=cuda_ms(lambda: flash_attention(q, k, v, causal=True), 20),
            plain_ms=cuda_ms(lambda: ref.flash_attention(q, k, v,
                                                         causal=True), 3),
            bound_ms=attention_bound_ms(q, k, v, True),
            library_ms=cuda_ms(lambda: sdpa(q, k, v), 20),
            host_us=host_us(lambda: flash_attention(q, k, v, causal=True),
                            20),
            library_host_us=host_us(lambda: sdpa(q, k, v), 20))
        del q, k, v
    prefill_shape = rows["flash_attention"]["prefill_shape"]
    for r in (rows["flash_attention"], prefill_shape,
              rows["flash_attention"]["llama_prefill_shape"]):
        b_, h_, hkv_, s_, _, d_ = r.get("shape", FA_LAYER)
        log(f"flash_attention bf16 causal {b_}x{h_}({hkv_})x{s_}^2x{d_}: "
            f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, SDPA "
            f"{r['library_ms']:.4f} ms ({r['ms'] / r['library_ms']:.2f}x), "
            f"bound {r['bound_ms']:.4f} ms")
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
            bound_ms=attention_bound_ms(q, k, v, True),
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

    # B6 at head dim 256: recurrentgemma-9b's layer launch, window 2048, in
    # bf16 (held to one bf16 step of the plain version) and in f32 (64-row
    # tiles, 2e-4); SDPA gets the window as a boolean mask
    fa_mask = window_mask(FA_D256[3], FA_D256[4], True, FA_D256_WINDOW, dev)
    d256 = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = attention_inputs(
            FA_D256, dtype, torch.Generator(device=dev).manual_seed(0), dev)
        fa_call = (lambda: flash_attention(q, k, v, causal=True,
                                           window=FA_D256_WINDOW))
        before = FLASH_ATTENTION.launches
        got = fa_call()
        torch.cuda.synchronize()
        check(FLASH_ATTENTION.launches == before + 1,
              f"flash_attention {dtype} D=256: not one launch")
        want = ref.flash_attention(q, k, v, causal=True,
                                   window=FA_D256_WINDOW)
        r = dict(shape=list(FA_D256), window=FA_D256_WINDOW,
                 dtype=str(dtype),
                 max_abs_err=max_abs_err(got.float(), want.float()))
        if dtype == torch.bfloat16:
            r["max_steps"] = float(bf16_steps(got, want).max())
            check(r["max_steps"] <= FA_BF16_STEPS,
                  f"flash_attention bf16 D=256: {r['max_steps']} bf16 steps "
                  f"from the plain version > {FA_BF16_STEPS}")
        else:
            r["query_tile"] = f32_query_tile(1, FA_D256[1], FA_D256[3],
                                             device_sm_count(dev.index), 256)
            check(torch.allclose(got, want, rtol=FA_F32_TOL, atol=FA_F32_TOL),
                  f"flash_attention f32 D=256 disagrees beyond {FA_F32_TOL}")
        del got, want
        r.update(
            ms=cuda_ms(fa_call, 10),
            plain_ms=cuda_ms(lambda: ref.flash_attention(
                q, k, v, causal=True, window=FA_D256_WINDOW), 3),
            bound_ms=attention_bound_ms(q, k, v, True, FA_D256_WINDOW),
            bound_by="operations",
            library_ms=cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=fa_mask, enable_gqa=True), 10),
            library="F.scaled_dot_product_attention(attn_mask=the window, "
                    "enable_gqa=True)")
        d256["bf16" if dtype == torch.bfloat16 else "f32"] = r
        log(f"flash_attention {dtype} causal D=256 1x16(1)x4096^2 window "
            f"{FA_D256_WINDOW}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_ms'] / r['ms']:.3f} of it "
            f"reached); max_abs_err {r['max_abs_err']}"
            + (f", {r['max_steps']} bf16 steps" if "max_steps" in r else
               f" (tol {FA_F32_TOL}), {r['query_tile']}-row tiles"))
        del q, k, v
    rows["flash_attention"]["d256"] = d256
    del fa_mask
    rows["flash_attention"]["d192"] = fa_shape_rows("D=192 (nemotron-4)",
                                                     FA_D192, dev)
    # the widths 32, 96 and 160: every head dim up to 256 launches B6
    rows["flash_attention"]["widths"] = {
        "built": list(HEAD_DIMS),
        "every_head_dim": every_head_dim_check(dev),
        **{tag: fa_shape_rows(tag, shape, dev)
           for tag, shape in FA_WIDTH_SHAPES}}
    # head dims above 256: O in slabs, each its own block
    rows["flash_attention"]["slabs"] = {
        "widths": list(SLAB_WIDTHS), "build_all_s": build_s,
        "info": [i for i in fa_info if i["slabs"] > 1],
        **{tag: fa_shape_rows(tag, shape, dev)
           for tag, shape in FA_SLAB_SHAPES}}
    # the families' other bf16 launch shapes
    family_shapes = []
    for tag, shape, causal in FA_FAMILY_SHAPES:
        q, k, v = attention_inputs(
            shape, torch.bfloat16, torch.Generator(device=dev).manual_seed(0),
            dev)
        got = flash_attention(q, k, v, causal=causal)
        want = ref.flash_attention(q, k, v, causal=causal)
        steps = float(bf16_steps(got, want).max())
        check(steps <= FA_BF16_STEPS, f"flash_attention bf16 {tag} {shape}: "
              f"{steps} bf16 steps from the plain version")
        r = dict(tag=tag, shape=list(shape), causal=causal, max_steps=steps,
                 max_abs_err=max_abs_err(got.float(), want.float()),
                 ms=cuda_ms(lambda: flash_attention(q, k, v, causal=causal),
                            20),
                 plain_ms=cuda_ms(lambda: ref.flash_attention(
                     q, k, v, causal=causal), 3),
                 bound_ms=attention_bound_ms(q, k, v, causal),
                 library_ms=cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                     q, k, v, is_causal=causal, enable_gqa=True), 20))
        family_shapes.append(r)
        b_, h_, hkv_, sq_, skv_, d_ = shape
        log(f"flash_attention bf16 {tag} {b_}x{h_}({hkv_})x{sq_}x{skv_}x{d_}"
            f"{' causal' if causal else ''}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms; {steps} bf16 steps at most")
        del q, k, v, got, want
    rows["flash_attention"]["family_shapes"] = family_shapes
    torch.cuda.empty_cache()
    rows["adamw"] = adamw_row(dev)

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
        for n, dt in ((MM_N, torch.float32), (MM_N, torch.bfloat16)):
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

    # -- training, and the llama3-8b prefill --------------------------------------
    train = {"card": card,
             "parity": train_parity_phase(run_phase, dev)}
    torch.cuda.empty_cache()
    train["full"] = train_full_phase(run_phase, dev)
    torch.cuda.empty_cache()
    train["recovery"] = recovery_phase(run_phase)
    train["llama3_8b_prefill"] = llama_prefill_phase(run_phase, dev)
    torch.cuda.empty_cache()
    rows["flash_attention"]["slabs"]["prefill"] = slab_prefill_phase(
        run_phase, dev)
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
    check(logits.shape == (PREFILL_B, PREFILL_S, cfg.vocab_size),
          f"prefill logits of shape {tuple(logits.shape)}")
    log(f"qwen3-1.7b prefill bf16: warm forward median of 5 "
        f"{forward_ms[2]:.3f} ms (min {forward_ms[0]:.3f}, max "
        f"{forward_ms[-1]:.3f})")
    prefill_gates("qwen3-1.7b prefill bf16", logits, plain)
    del logits, plain
    torch.cuda.empty_cache()
    dist_layer = {"card": card,
                  "pipeline": pipeline_phase(run_phase, model, params, dev)}
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
    print(json.dumps({"train": train}), flush=True)

    # -- the families: moe, ssm, hybrid, encdec, vlm ------------------------------
    families = {"card": card}
    for phase, fn in (("moe", moe_phase), ("ssm", ssm_phase),
                      ("hybrid", hybrid_phase), ("encdec", encdec_phase),
                      ("vlm", vlm_phase)):
        t0 = time.perf_counter()
        families[phase] = fn(run_phase, dev)
        families[phase]["phase_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        log(f"family phase {phase}: {families[phase]['phase_s']:.1f} s")
    print(json.dumps({"families": families}), flush=True)

    # -- the distribution layer: nemotron-4-340b at D = 192, collectives --------
    dist_layer["nemotron"] = nemotron_phase(run_phase, dev)
    torch.cuda.empty_cache()
    dist_layer["collectives"] = collectives_phase(dev)
    print(json.dumps({"dist": dist_layer}), flush=True)

    # -- the roofline: qwen3-1.7b's prefill and train step, meta and card -----
    print(json.dumps({"roofline": roofline_phase(run_phase, card, dev)}),
          flush=True)

    # -- the user examples: repro_torch.examples on the card --------------------
    t0 = time.perf_counter()
    examples = {"card": card, **examples_phase(run_phase, rows, dev)}
    examples["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"examples": examples}), flush=True)

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
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Time B6's f32 flash-attention kernel, and the f32 prefill that runs it,
on one CUDA card.

    python3 tools/flash_attention_time.py [--src DIR] [--tag NAME]

Imports ``repro_torch`` from ``DIR`` (by default this checkout's ``src``),
so that one command can time two trees in turns, for example the parent
commit unpacked by ``git archive`` into a gitignored directory: parent,
change, change, parent. With TF32 off, it prints:

* the time to build the flash-attention library, and, where the tree has
  them, the f32 kernel's registers, spill bytes and shared memory at each
  head dim and query tile;
* the f32 kernel, causal, at the qwen3-1.7b layer shape (1 x 16 heads
  (8 KV) x 4096^2 x 128) and at the f32 prefill's own launch shape
  (1 x 16 (8) x 512^2 x 128): max_abs_err against the plain version, its
  time by CUDA events with the card held busy while the calls are
  enqueued (``chip_smoke.cuda_ms``), the bound (operations at the f32
  SIMT peak), SDPA f32's time, and the host µs a call of both
  (``chip_smoke.host_us``);
* the qwen3-1.7b f32 prefill forward at full width, 1 x 512 tokens,
  random weights from seed 0: the median wall of five forwards (host
  clock, ending in a synchronise), and, from one forward under
  ``torch.profiler``, the card's busy time and the flash-attention
  kernel's share of it.

The last line is one JSON object with these numbers. Needs a CUDA card;
exits with code 2 without one.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

import chip_smoke as smoke  # noqa: E402  (puts this checkout's src/ on the path)
import torch  # noqa: E402

LAYER = (1, 16, 8, 4096, 4096, 128)
PREFILL = (1, 16, 8, 512, 512, 128)
REPS = {LAYER: 10, PREFILL: 50}
FORWARDS = 5


def bound_ms(shape) -> float:
    """Causal attention's least time in f32: 4·B·H·S²·D / 2 operations at
    the SIMT peak against each input read and the output written once."""
    b, h, hkv, s, _, d = shape
    nbytes = 4 * (2 * b * h * s * d + 2 * b * hkv * s * d)
    return max(smoke.bytes_ms(nbytes),
               smoke.ops_ms(4.0 * b * h * s * s * d / 2, smoke.F32_FLOPS))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(os.path.dirname(HERE), "src"))
    ap.add_argument("--tag", default="this checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_attention_time: no CUDA device is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.configs import get_config
    from repro_torch.kernels import FLASH_ATTENTION, build_all, ref
    from repro_torch.models import Model
    fa = importlib.import_module("repro_torch.kernels.flash_attention")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    out = {"tag": args.tag, "card": card,
           "build_s": build_all([FLASH_ATTENTION])}
    print(f"[{args.tag}] {card}; built in {out['build_s']:.2f} s", flush=True)
    if hasattr(fa, "f32_query_tile"):
        out["f32_kernels"] = [fa.kernel_info(d, torch.float32, t)
                              for d in fa.HEAD_DIMS
                              for t in fa.f32_query_tiles(d)]
        for info in out["f32_kernels"]:
            print(f"[{args.tag}] f32 kernel {info}", flush=True)

    def sdpa(q, k, v):
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)

    for name, shape in (("layer", LAYER), ("prefill_shape", PREFILL)):
        q, k, v = smoke.attention_inputs(
            shape, torch.float32, torch.Generator(device=dev).manual_seed(0),
            dev)
        got = fa.flash_attention(q, k, v, causal=True)
        want = ref.flash_attention(q, k, v, causal=True)
        reps = REPS[shape]
        row = dict(
            shape=list(shape), max_abs_err=smoke.max_abs_err(got, want),
            within_tol=bool(torch.allclose(got, want, rtol=smoke.FA_F32_TOL,
                                           atol=smoke.FA_F32_TOL)),
            ms=smoke.cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True),
                             reps),
            bound_ms=bound_ms(shape),
            sdpa_ms=smoke.cuda_ms(lambda: sdpa(q, k, v), reps),
            host_us=smoke.host_us(
                lambda: fa.flash_attention(q, k, v, causal=True), 20),
            sdpa_host_us=smoke.host_us(lambda: sdpa(q, k, v), 20))
        out[name] = row
        print(f"[{args.tag}] f32 causal {shape}: kernel {row['ms']:.4f} ms, "
              f"bound {row['bound_ms']:.4f} ({row['bound_ms'] / row['ms']:.3f}"
              f" of it), SDPA {row['sdpa_ms']:.4f} ms; host {row['host_us']:.1f}"
              f" us a call, SDPA {row['sdpa_host_us']:.1f}; max_abs_err "
              f"{row['max_abs_err']} (within {smoke.FA_F32_TOL}: "
              f"{row['within_tol']})", flush=True)
        del q, k, v, got, want
    torch.cuda.empty_cache()

    cfg = get_config("qwen3-1.7b")
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    model = Model(cfg32, attn_impl="kernel", device=dev)
    params = model.init(0)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, smoke.PREFILL_F32_S))).to(dev)

    def forward():
        return model.forward(params, {"tokens": tokens})

    forward()
    torch.cuda.synchronize()
    walls = []
    for _ in range(FORWARDS):
        t0 = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    walls.sort()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        forward()
        torch.cuda.synchronize()
    events = prof.events()
    busy = smoke.device_busy_ms(events)
    fa_ms = sum(e.time_range.elapsed_us() for e in events
                if e.device_type == DeviceType.CUDA
                and "flash_attention" in e.name) / 1e3
    fa_launches = sum(1 for e in events if e.device_type == DeviceType.CUDA
                      and "flash_attention" in e.name)
    out["prefill_f32"] = dict(tokens=list(tokens.shape),
                              wall_ms_median=walls[FORWARDS // 2],
                              wall_ms_min=walls[0], wall_ms_max=walls[-1],
                              device_busy_ms=busy, kernel_ms=fa_ms,
                              kernel_launches=fa_launches,
                              kernel_share=fa_ms / busy)
    r = out["prefill_f32"]
    print(f"[{args.tag}] qwen3-1.7b f32 prefill 1x{smoke.PREFILL_F32_S}: wall "
          f"median {r['wall_ms_median']:.3f} ms (min {r['wall_ms_min']:.3f}, "
          f"max {r['wall_ms_max']:.3f}); profiled forward: device busy "
          f"{busy:.3f} ms, flash attention {fa_ms:.3f} ms in {fa_launches} "
          f"launches ({r['kernel_share']:.3f} of the busy time)", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

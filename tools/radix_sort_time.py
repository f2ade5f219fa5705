"""Time the radix sort, and the WAH build that begins with it, on one CUDA
card.

    python3 tools/radix_sort_time.py [--src DIR] [--tag NAME]

Imports ``repro_torch`` from ``DIR`` (by default this checkout's ``src``),
so that one command can time two trees in turns, for example the parent
commit unpacked by ``git archive`` into a gitignored directory: parent,
change, change, parent. At 2**24 keys it times, by CUDA events with the
card held busy while the calls are enqueued (``chip_smoke.cuda_ms``), and
by the host clock around calls that end in ``torch.cuda.synchronize()``:

* ``build_wah_index`` over ``chip_smoke``'s WAH values (cardinality 64),
  and the ``ops.radix_sort(values, pos)`` call it begins with;
* ``ops.radix_sort`` of random uint32 keys with an int32 payload;
* ``torch.sort(stable=True)`` of the same keys as int64 and as int32 (the
  int32 order differs for keys at or above 2**31: timed only);
* the host µs a call of ``ops.radix_sort`` and of ``torch.sort``
  (``chip_smoke.host_us``);
* where the tree has them, one ``radix_onesweep`` pass of the random keys
  (each call on scratch zeroed beforehand), the same pass at shift 8 of
  the WAH values (one digit), and ``radix_histogram``;
* the device operations of one random-key sort under ``torch.profiler``
  (``tools/profile_main_path.py``'s breakdown).

The last line is one JSON object with these numbers. Needs a CUDA card;
exits with code 2 without one.
"""
from __future__ import annotations

import argparse
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
from profile_main_path import _phase  # noqa: E402

REPS = 5


def wall_ms(fn, reps: int = REPS) -> float:
    """Median host-clock time of ``fn`` followed by a synchronise."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[reps // 2]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(os.path.dirname(HERE), "src"))
    ap.add_argument("--tag", default="this checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("radix_sort_time: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.indexing import build_wah_index
    from repro_torch.kernels import ops, ref

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    values = torch.from_numpy(smoke.wah_values(rng)).to(dev)
    pos = torch.arange(smoke.WAH_N, dtype=torch.int32, device=dev)
    keys = ref.i64_to_u32(torch.from_numpy(
        rng.integers(0, 2 ** 32, smoke.WAH_N, dtype=np.int64)).to(dev))
    wide, narrow = ref.u32_to_i64(keys), keys.view(torch.int32)
    sort_wide = lambda: torch.sort(wide, stable=True)  # noqa: E731
    got_k, got_p = ops.radix_sort(keys, pos)
    want_k, want_p = sort_wide()
    if not (torch.equal(ref.u32_to_i64(got_k), want_k) and
            torch.equal(got_p.long(), want_p)):
        raise AssertionError("ops.radix_sort disagrees with torch.sort")
    del got_k, got_p, want_k, want_p
    r = {
        "tag": args.tag, "src": args.src, "card": card, "n": smoke.WAH_N,
        "wah_build_ms": smoke.cuda_ms(
            lambda: build_wah_index(values, smoke.WAH_CARD), REPS),
        "wah_build_wall_ms": wall_ms(
            lambda: build_wah_index(values, smoke.WAH_CARD)),
        "wah_sort_ms": smoke.cuda_ms(lambda: ops.radix_sort(values, pos), REPS),
        "wah_sort_wall_ms": wall_ms(lambda: ops.radix_sort(values, pos)),
        "random_sort_ms": smoke.cuda_ms(lambda: ops.radix_sort(keys, pos), REPS),
        "torch_sort_int64_ms": smoke.cuda_ms(sort_wide, REPS),
        "torch_sort_int32_ms": smoke.cuda_ms(
            lambda: torch.sort(narrow, stable=True), REPS),
        "sort_host_us": smoke.host_us(lambda: ops.radix_sort(keys, pos), 10),
        "torch_sort_host_us": smoke.host_us(sort_wide, 10),
    }
    r["wah_sort_share"] = r["wah_sort_ms"] / r["wah_build_ms"]
    try:
        from repro_torch.kernels.radix_sort import (OnesweepScratch,
                                                    radix_histogram,
                                                    radix_onesweep)
    except ImportError:         # a tree from before the onesweep sort
        pass
    else:
        def pass_ms(k_in, shift):
            counts = radix_histogram(k_in)[shift // 8]
            scratch = OnesweepScratch(smoke.WAH_N, 8, dev, passes=22)
            return smoke.cuda_ms(lambda: radix_onesweep(
                k_in, pos, counts, 8, shift, scratch=scratch), 20)
        r["onesweep_ms"] = pass_ms(keys, 0)
        r["onesweep_one_digit_ms"] = pass_ms(values, 8)
        r["histogram_ms"] = smoke.cuda_ms(lambda: radix_histogram(keys), 20)
    r["sort_profile"] = _phase("ops.radix_sort, 2^24 random keys",
                               lambda: ops.radix_sort(keys, pos))
    for k, v in r.items():
        print(f"{k}: {v}", flush=True)
    print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run ``chip_smoke.py``'s roofline phase alone, from one tree, on one
CUDA card.

    python3 tools/roofline_time.py [--src DIR] [--tag NAME]

Imports ``chip_smoke`` and ``repro_torch`` from ``DIR`` (by default this
checkout), so that one command can time two trees in turns, for example
the parent commit unpacked by ``git archive`` into a gitignored
directory: parent, change, change, parent. It builds the tree's kernels
and runs ``chip_smoke.roofline_phase``: qwen3-1.7b's prefill (2 x 2048,
timed with the flash-attention kernel) and train step (8 x 512), each
counted on ``meta`` in a spawned child and on the card, the counts held
equal, and each step's wall (median of five, host clock ending in a
synchronise) and profiled busy time. Each phase's wall is printed as it
ends; the last line is one JSON object with the tag, the card's name and
power limit, and each step's walls, median, busy time, FLOPs and bytes.
Needs a CUDA card; exits with code 2 without one.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--src", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="the tree to run (its root)")
    parser.add_argument("--tag", default="tree")
    args = parser.parse_args()
    tree = os.path.abspath(args.src)
    sys.path[:0] = [os.path.join(tree, "src"), tree]
    os.chdir(tree)
    import torch
    if not torch.cuda.is_available():
        print("roofline_time: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import KERNELS, build_all
    t0 = time.perf_counter()
    build_all(KERNELS)
    print(f"{args.tag}: built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()

    def run_phase(name, needs, body, functions=None):
        start = time.perf_counter()
        result = body()
        torch.cuda.synchronize()
        print(f"{args.tag} phase {name}: "
              f"{(time.perf_counter() - start) * 1e3:.1f} ms", flush=True)
        return result

    out = chip_smoke.roofline_phase(run_phase, card, torch.device("cuda:0"))
    keep = ("wall_ms", "wall_ms_median", "device_busy_ms", "flops", "bytes")
    print(json.dumps({"tag": args.tag, "card": card, **{
        k: {f: v[f] for f in keep} for k, v in out.items()
        if isinstance(v, dict)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Readings that set a cell's limits, on the card, in one process: the
program's compared numbers over many seeds, the control's (the reference
in fp8 in the program's place), and the planted faults' (``faults.py``).

    python3 bench_h100/calibrate.py --workload W --seeds 1,2,3 \
        --seconds 6 [--control fp8] [--fault half_batch]

Each reading is one JSON line on standard output. The benchmark's own
runs never run this.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.join(os.path.dirname(HERE), "src"),
                os.path.dirname(HERE)]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="1")
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--control", default="f32")
    ap.add_argument("--fault", default=None)
    args = ap.parse_args()
    from bench_h100 import faults
    from bench_h100.harness import run_cell
    from bench_h100.spec import load_cell
    kind = load_cell(args.workload).traffic["kind"]
    seeds = [int(s) for s in args.seeds.split(",")]
    log = lambda m: print(m, file=sys.stderr, flush=True)  # noqa: E731
    for seed in seeds:
        t = time.perf_counter()
        ctx = (faults.fault(kind, args.fault) if args.fault
               else contextlib.nullcontext())
        with ctx:
            r = run_cell(args.workload, seed, args.seconds, False,
                         t_start=t, control=args.control, log=log)
        print(json.dumps({"seed": seed, "control": args.control,
                          "fault": args.fault, "correct": r["correct"],
                          "checks": r["checks"],
                          "diagnostics": r["diagnostics"],
                          "metrics": r["metrics"], "device": r["device"],
                          "attempted": r["attempted"],
                          "wall_s": time.perf_counter() - t}), flush=True)


if __name__ == "__main__":
    main()

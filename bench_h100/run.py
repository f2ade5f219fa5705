"""Run one cell of the port's benchmark once and print its result line.

    python3 bench_h100/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's files are found by name from ``BENCHMARK.json`` (see
``README.md``). The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``; the compared numbers under ``checks``, last);
the numbers compared, each with its limit, are also the last lines of
standard error. Without the CUDA devices the cell asks for, or with
``jax``, ``jaxlib``, ``flax`` or ``repro`` loaded after the window, it
exits 1 and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, "cache")


def _environment() -> None:
    """Every build and kernel cache at a fixed place inside the checkout;
    no library loads JAX on its own."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(CACHE, "inductor")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (os.path.join(ROOT, "src"), ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    from bench_h100.harness import NoChip, forbidden_modules, run_cell

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    try:
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace), t_start=T_START, log=log)
    except NoChip as exc:
        log(f"no result: {exc}")
        return 1
    except Exception as exc:
        import traceback
        traceback.print_exc()
        log(f"no result: {type(exc).__name__}: {exc}")
        return 1
    found = forbidden_modules()
    if found:
        log(f"no result: modules loaded in the run: {found}")
        return 1
    print(json.dumps(result), flush=True)
    checks = result["checks"]
    for name, c in checks.items():
        log(f"{name} {c['value']!r} limit {c['limit']!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

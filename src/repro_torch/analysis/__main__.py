"""CLI: ``python -m repro_torch.analysis [paths] --baseline FILE``; with
no paths it lints ``src/repro_torch``, which needs no baseline.

Exit status:

* ``0`` — no findings outside the baseline (stale baseline entries are
  reported as warnings but do not fail the run — *except* that an entry
  whose finding still exists obviously keeps the run green only while
  the finding is baselined; delete the line after fixing the code).
* ``1`` — at least one finding not covered by the baseline, or a file
  that could not be parsed.
* ``2`` — usage error.

``--write-baseline`` regenerates the baseline from the current tree
(use when adopting the linter, never to silence a regression).
"""
from __future__ import annotations

import argparse
import sys
from typing import List

from .lint import compare, load_baseline, run_rules, write_baseline


def main(argv: List[str] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Actor-runtime lint: ref lifecycle, blocking calls "
                    "in behaviors, silent excepts, static lock order.")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files or directories to lint (default: src/repro_torch)")
    ap.add_argument("--baseline", metavar="FILE", default=None,
                    help="fingerprint file of accepted pre-existing "
                         "findings; only findings NOT listed fail the run")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write all current findings to --baseline and "
                         "exit 0")
    ap.add_argument("--list", action="store_true", dest="list_all",
                    help="print every finding, including baselined ones")
    args = ap.parse_args(argv)

    paths = args.paths or ["src/repro_torch"]
    findings, errors = run_rules(paths)

    for err in errors:
        print(f"error: {err}", file=sys.stderr)

    if args.write_baseline:
        if not args.baseline:
            print("error: --write-baseline requires --baseline FILE",
                  file=sys.stderr)
            return 2
        n = write_baseline(args.baseline, findings)
        print(f"wrote {n} fingerprint(s) to {args.baseline}")
        return 0

    baseline = load_baseline(args.baseline) if args.baseline else []
    new, stale = compare(findings, baseline)

    shown = findings if args.list_all else new
    for f in shown:
        tag = "" if f in new else " [baselined]"
        print(f.render() + tag)

    for b in stale:
        print(f"warning: stale baseline entry (finding fixed? delete the "
              f"line): {b}", file=sys.stderr)

    total, n_new = len(findings), len(new)
    print(f"{total} finding(s), {n_new} new, "
          f"{total - n_new} baselined, {len(stale)} stale baseline "
          f"entr{'y' if len(stale) == 1 else 'ies'}", file=sys.stderr)
    return 1 if (new or errors) else 0


if __name__ == "__main__":
    sys.exit(main())

"""Multi-pod dry-run entry point — the port of the JAX package's
``repro/launch/dryrun.py``.

Runs every (architecture × input shape) cell on ``meta`` tensors over the
single-pod (16×16) and multi-pod (2×16×16) production meshes, prints each
cell's status and bottleneck, and writes one JSON artifact a cell under
``experiments/dryrun_torch/`` (``REPRO_DRYRUN_DIR`` or ``--out``
overrides it).

The meshes need a process group of 512 ranks (256 with
``--single-pod-only``). This module starts one in this process with
PyTorch's ``fake`` backend, whose ``FakeStore`` lives under
``torch.testing._internal.distributed.fake_pg``: an internal module, the
one place the port depends on one. Its collectives move nothing; the
counter prices them.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""
import argparse
import json
import sys


def start_fake_group(world: int) -> None:
    """A ``fake`` default process group of ``world`` ranks, this process
    rank 0."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--arch", action="append", default=None,
                        help="architecture id (repeatable); default: all")
    parser.add_argument("--shape", action="append", default=None,
                        help="input shape name (repeatable); default: all")
    parser.add_argument("--all", action="store_true")
    parser.add_argument("--single-pod-only", action="store_true",
                        help="skip the 2-pod 512-rank mesh")
    parser.add_argument("--out", default=None, help="artifact directory")
    parser.add_argument("--plan", default=None,
                        help="JSON dict of CellPlan overrides")
    args = parser.parse_args(argv)

    start_fake_group(256 if args.single_pod_only else 512)

    from repro_torch import configs
    from repro_torch.launch import dryrun_lib

    archs = args.arch or configs.list_archs()
    shapes = args.shape or list(configs.SHAPES)
    overrides = json.loads(args.plan) if args.plan else None

    results = dryrun_lib.run_cells(
        archs, shapes, multi_pod_check=not args.single_pod_only,
        out_dir=args.out or dryrun_lib.ARTIFACT_DIR,
        plan_overrides=overrides)

    failed = {k: v for k, v in results.items() if v["status"] == "FAILED"}
    ok = sum(1 for v in results.values() if v["status"] == "counted")
    skipped = sum(1 for v in results.values() if v["status"] == "skipped")
    print(f"\n== dry-run: {ok} counted, {skipped} skipped "
          f"(documented), {len(failed)} failed ==")
    for k, v in failed.items():
        print(f"  FAILED {k}: {v['error'][:200]}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

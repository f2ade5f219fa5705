"""A run with the timed path broken underneath comes out not correct, for
each fault a cell can have, and so does the control (the reference in
fp8 in the program's place); the same run unbroken is correct."""
import contextlib
import time

import pytest

from bench_h100 import faults

CELLS = {"prefill": "qwen3-1.7b.prefill-mixed",
         "moe": "phi3.5-moe.prefill-mixed",
         "train": "qwen3-1.7b.train-8x1024"}
CASES = [(c, f) for c in CELLS for f in (None, "fp8") + faults.FAULTS]


@pytest.mark.parametrize("which,fault", CASES)
def test_fault_is_caught(which, fault, small):
    from bench_h100.harness import run_cell
    workload = CELLS[which]
    kind = "train" if which == "train" else "prefill"
    ctx = (faults.fault(kind, fault) if fault in faults.FAULTS
           else contextlib.nullcontext())
    with ctx:
        r = run_cell(workload, 9001, 0.5, False, t_start=time.perf_counter(),
                     device="cpu", overrides=small,
                     control="fp8" if fault == "fp8" else "f32",
                     log=lambda m: None)
    assert r["correct"] is (fault is None), r["checks"]


def test_one_wrong_row_in_twenty_fails_row_gap():
    """A fault in one row of twenty passes the 75th percentile of the gaps
    and fails ``row_gap``, the widest of the rows' median gaps."""
    import torch
    from bench_h100 import compare
    g = torch.Generator().manual_seed(3)
    ref = torch.randn(20 * 17, 64, generator=g)
    prog = ref.clone()
    prog[17:34] = torch.randn(17, 64, generator=g)      # row 1 wrong
    limits = {"compare": ["token_gap", "row_gap"], "token_gap_q": 0.75}
    numbers, _ = compare.prefill_numbers(prog, ref, limits, [17] * 20)
    assert numbers["token_gap"] == 0.0
    assert numbers["row_gap"] > 1.0
    numbers, _ = compare.prefill_numbers(ref, ref, limits, [17] * 20)
    assert numbers == {"token_gap": 0.0, "row_gap": 0.0}

"""Paper §4 — WAH bitmap indexing on the device, on the port.

Builds the full index with the data-parallel pipeline (radix sort →
literals/fills → fuseFillsLiterals → lookup table; on a card the sort,
the interleave and the compaction are the hand-written kernels), checks a
few bitmaps by decoding them back to position lists, then runs the fuse
step as Listing 5's pipeline of three kernel actors:

    PYTHONPATH=src python -m repro_torch.examples.wah_indexing [n_values]
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core import ActorSystem
from repro_torch.indexing import (build_wah_index, decode_wah_bitmap,
                                  wah_index_pipeline_actors)

CARDINALITY = 64
#: Listing 5's input: fill and literal words, this many of each
PIPE_K = 1 << 12


def run(n: int = 1 << 17, device=None) -> Dict[str, Any]:
    """Index ``n`` values of cardinality 64 from ``default_rng(0)`` on
    ``device`` (``cuda:0`` by default), round-trip three bitmaps, and run
    Listing 5's staged pipeline on the next draws of the same stream.
    Returns the index as numpy arrays (``words`` cut to ``n_words``), the
    pipeline's ``out`` and ``total`` and the build's wall seconds."""
    rng = np.random.default_rng(0)
    values = rng.integers(0, CARDINALITY, n).astype(np.uint32)
    with ActorSystem(device=device) as system:
        dev = system.opencl_manager().find_device().torch_device
        vals = torch.from_numpy(values).to(dev)
        t0 = time.perf_counter()
        words, n_words, starts, counts = build_wah_index(vals, CARDINALITY)
        n_words = int(n_words)                   # waits for the build
        seconds = time.perf_counter() - t0
        words = words[:n_words].cpu().numpy()
        starts, counts = starts.cpu().numpy(), counts.cpu().numpy()

        for v in (0, CARDINALITY // 2, CARDINALITY - 1):
            got = decode_wah_bitmap(words, int(starts[v]), int(counts[v]))
            assert np.array_equal(got, np.flatnonzero(values == v)), v

        # paper Listing 5: the fuse step as a pipeline of kernel actors
        # (staged: the intermediates stay on the device)
        k = PIPE_K
        fills = (rng.integers(0, 2, k) * ((1 << 31) | rng.integers(1, 99, k))
                 ).astype(np.uint32)
        lits = rng.integers(1, 2 ** 31, k).astype(np.uint32)
        pipe = wah_index_pipeline_actors(system, k, mode="staged")
        out, total = pipe.ask(fills, lits)
    return {"n": n, "values": values, "words": words, "n_words": n_words,
            "starts": starts, "counts": counts, "seconds": seconds,
            "k": k, "out": np.asarray(out), "total": int(total)}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("n_values", nargs="?", type=int, default=1 << 17)
    args = parser.parse_args(argv)
    r = run(args.n_values)
    print(f"indexed {r['n']} values → {r['n_words']} WAH words in "
          f"{r['seconds']:.3f}s ({r['n'] / r['seconds'] / 1e6:.2f} Mvals/s)")
    print("bitmap round-trip verified for 3 values")
    print(f"fuseFillsLiterals actor pipeline: {2 * r['k']} slots → "
          f"{r['total']} words (zeros compacted)")


if __name__ == "__main__":
    main()

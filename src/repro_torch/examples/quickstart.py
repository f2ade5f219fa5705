"""Quickstart — the paper's Listings 1+2 on the port.

A kernel actor multiplying two square matrices: declare the kernel with
``@kernel`` (signature and index space captured at the definition site),
spawn it from the actor system, send the matrices, receive the product.
On a card the product is the hand-written matmul kernel; the system binds
``cuda:0`` unless it is asked for another device:

    PYTHONPATH=src python -m repro_torch.examples.quickstart
"""
from __future__ import annotations

import argparse
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core import ActorSystem, In, NDRange, Out, dim_vec, kernel
from repro_torch.kernels import ops

MX_DIM = 512


# Listing 1's kernel: ops.matmul launches the matmul kernel on a card and
# runs its plain version on the CPU.
@kernel(In(torch.float32), In(torch.float32),
        Out(torch.float32, shape=(MX_DIM, MX_DIM)),
        nd_range=NDRange(dim_vec(MX_DIM, MX_DIM)), name="m_mult")
def m_mult(a, b):
    return ops.matmul(a, b)


def run(device=None) -> Dict[str, Any]:
    """Listing 2 on ``device`` (``cuda:0`` by default): the platforms the
    manager found, the seed-0 matrices and their product, held to ``m1 @
    m2`` within 1e-4."""
    # Listing 2: create an actor system with the device module loaded
    with ActorSystem(device=device) as system:
        platforms = system.opencl_manager().platforms
        worker = system.spawn(m_mult)
        rng = np.random.default_rng(0)
        m1 = rng.random((MX_DIM, MX_DIM), np.float32)
        m2 = rng.random((MX_DIM, MX_DIM), np.float32)
        # request/receive (the paper's scoped_actor pattern)
        result = np.asarray(worker.ask(m1, m2))
    np.testing.assert_allclose(result, m1 @ m2, rtol=1e-4, atol=1e-4)
    return {"platforms": platforms, "m1": m1, "m2": m2, "result": result,
            "norm": float(np.linalg.norm(result))}


def main(argv=None) -> None:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    out = run()
    print("platforms:", out["platforms"])
    print(f"m_mult ok: {MX_DIM}x{MX_DIM}, |result|_F = {out['norm']:.1f}")


if __name__ == "__main__":
    main()

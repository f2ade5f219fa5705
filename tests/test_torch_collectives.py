"""The port's compressed all-reduce (``repro_torch.dist.collectives``)
against the JAX package's.

Each rank's dequantized contribution is bit-equal to
``repro.dist.collectives._quantize(x)[2]`` on the same numpy input; in
four gloo processes on the CPU (a ``FileStore`` under ``tmp_path``, never
a fixed port: the suite runs on several xdist workers at once) the
checks of ``tests/test_fault.py::test_compressed_psum_multidevice`` hold:
the sum within 2e-2, the error-feedback mean within 0.05.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import collectives as jcoll
from repro_torch.dist import collectives

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4

#: one rank of a gloo world: argv = rank, world size, FileStore path
_RANK = textwrap.dedent("""
    import json, sys
    import numpy as np, torch, torch.distributed as dist
    from repro_torch.dist.collectives import (
        _quantize, compressed_psum, tree_psum_with_error_feedback)
    rank, world, path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    dist.init_process_group("gloo", store=dist.FileStore(path, world),
                            rank=rank, world_size=world)
    out = {}
    # tests/test_fault.py: every rank contributes full(8, rank + 1)
    out["sum"] = compressed_psum(torch.full((8,), float(rank + 1))).tolist()
    # a random contribution: its dequantized payload, bit for bit, and
    # the sum of all four
    x = torch.from_numpy(np.random.default_rng(rank).standard_normal(
        4096).astype(np.float32))
    out["deq_bits"] = _quantize(x)[2].view(torch.int32).tolist()
    out["rand_sum"] = compressed_psum(x).tolist()
    assert torch.equal(x, torch.from_numpy(np.random.default_rng(
        rank).standard_normal(4096).astype(np.float32))), "x was written"
    # error feedback: a bare tensor and a tree
    g = torch.from_numpy(np.linspace(-1, 1, 8, dtype=np.float32) * (rank + 1))
    mean, err = tree_psum_with_error_feedback(g, torch.zeros(8))
    out["mean"], out["err"] = mean.tolist(), err.tolist()
    out["err_is_residual"] = bool(torch.equal(err, g - _quantize(g)[2]))
    tmean, terr = tree_psum_with_error_feedback(
        {"a": g, "b": [2 * g]}, {"a": torch.zeros(8), "b": [torch.zeros(8)]})
    out["tree"] = [sorted(tmean), len(tmean["b"]), sorted(terr)]
    out["tree_mean_b"] = tmean["b"][0].tolist()
    dist.destroy_process_group()
    print("RESULT " + json.dumps(out))
""")


def run_world(code: str, world: int, tmp_path) -> list:
    """Run ``code`` as ``world`` ranks of one gloo group, each its own
    process; → each rank's ``RESULT`` JSON, in rank order."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    store = str(tmp_path / "store")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(world),
                               store], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for r in range(world)]
    try:
        done = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    outs = []
    for p, (stdout, stderr) in zip(procs, done):
        assert p.returncode == 0, stderr[-3000:]
        line = [ln for ln in stdout.splitlines() if ln.startswith("RESULT ")]
        outs.append(json.loads(line[-1][len("RESULT "):]))
    return outs


def _jax_deq(x: np.ndarray) -> np.ndarray:
    return np.asarray(jcoll._quantize(jnp.asarray(x))[2])


@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 1e-3), (2, 3e4)])
def test_dequantized_contribution_is_bit_exact_with_jax(seed, scale):
    x = (np.random.default_rng(seed).standard_normal(5000) *
         scale).astype(np.float32)
    q, s, deq = collectives._quantize(torch.from_numpy(x))
    jq, js, jdeq = jcoll._quantize(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert np.float32(s.item()).view(np.int32) == \
        np.asarray(js, np.float32).view(np.int32)
    np.testing.assert_array_equal(deq.numpy().view(np.int32),
                                  np.asarray(jdeq, np.float32).view(np.int32))


def test_compressed_psum_in_four_gloo_processes(tmp_path):
    ranks = run_world(_RANK, WORLD, tmp_path)
    want = float(sum(range(1, WORLD + 1)))
    jdeqs = []
    for rank, out in enumerate(ranks):
        # tests/test_fault.py's sum, within 2e-2
        np.testing.assert_allclose(out["sum"], want, rtol=2e-2)
        x = np.random.default_rng(rank).standard_normal(4096).astype(
            np.float32)
        jdeq = _jax_deq(x)
        np.testing.assert_array_equal(np.asarray(out["deq_bits"], np.int32),
                                      jdeq.view(np.int32))
        jdeqs.append(jdeq)
        assert out["err_is_residual"]
    # the f32 sum of the four dequantized payloads (order aside)
    for out in ranks:
        np.testing.assert_allclose(out["rand_sum"], np.sum(jdeqs, axis=0),
                                   rtol=1e-6, atol=1e-5)
    # error feedback: the mean of the four within 0.05 (tests/test_fault.py)
    g = np.stack([np.linspace(-1, 1, 8, dtype=np.float32) * (i + 1)
                  for i in range(WORLD)])
    for out in ranks:
        np.testing.assert_allclose(out["mean"], g.mean(axis=0), atol=0.05)
        np.testing.assert_allclose(out["tree_mean_b"], 2 * g.mean(axis=0),
                                   atol=0.1)
        assert out["tree"] == [["a", "b"], 1, ["a", "b"]]
    # every rank got the same reduction
    assert all(out["mean"] == ranks[0]["mean"] for out in ranks)


def test_error_feedback_needs_matching_trees():
    with pytest.raises(ValueError):
        collectives.tree_psum_with_error_feedback(
            {"a": torch.zeros(2)}, [torch.zeros(2)])

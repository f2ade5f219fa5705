"""The hand-written kernels and the port's stream handling on a CUDA card.

Every test here needs an NVIDIA card (marker ``cuda``) and skips without
one. On the card run::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports only torch, numpy and the port, so it runs where JAX is
not installed. ``python3 chip_smoke.py`` is the full-size check.
"""
import pickle

import numpy as np
import pytest
import torch

from repro_torch.core import ActorSystem, DeviceRef, In, InOut, Out, kernel
from repro_torch.core.memref import registry
from repro_torch.indexing import (build_wah_index, build_wah_index_numpy,
                                  wah_index_pipeline_actors)
from repro_torch.kernels import KERNELS, ops, ref
from repro_torch.kernels.matmul import matmul
from repro_torch.kernels.radix_sort import radix_pass
from repro_torch.kernels.stream_compact import local_compact
from repro_torch.kernels.wah import wah_interleave

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run python3 chip_smoke.py there")
    return torch.device("cuda", 0)


def _launches():
    return {k.name: k.launches for k in KERNELS}


def _words(rng, n, density, device):
    x = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    x = x * (rng.random(n) < density)
    return torch.from_numpy(x).to(device)


def _same_words(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


@pytest.mark.parametrize("n", [1, 255, 5000, 1 << 16])
@pytest.mark.parametrize("name", ["radix_pass", "local_compact",
                                  "wah_interleave"])
def test_integer_kernel_is_bit_exact(cuda_device, name, n):
    rng = np.random.default_rng(n)
    x = _words(rng, n, 0.5, cuda_device)
    before = _launches()
    if name == "radix_pass":
        for bits, shift in ((8, 0), (8, 24), (4, 4)):
            for bs in (256, 1024):
                got = radix_pass(x, bs=bs, bits=bits, shift=shift)
                want = ref.radix_pass(x, bs=bs, bits=bits, shift=shift)
                assert all(torch.equal(g, w) for g, w in zip(got, want))
    elif name == "local_compact":
        for drop in (0, 7):
            for bs in (64, 256):
                got = local_compact(x, bs=bs, drop_value=drop)
                want = ref.local_compact(x, bs=bs, drop_value=drop)
                assert _same_words(got[0], want[0])
                assert torch.equal(got[1], want[1])
    else:
        assert _same_words(wah_interleave(x, x.flip(0)),
                           ref.wah_interleave(x, x.flip(0)))
    torch.cuda.synchronize()
    assert _launches()[name] > before[name]


@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (300, 200, 170),
                                   (1, 1000, 3)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_matmul_within_tolerance(cuda_device, m, k, n, dtype, tol):
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(m * n)
    a = torch.rand(m, k, generator=g).to(cuda_device, dtype)
    b = torch.rand(k, n, generator=g).to(cuda_device, dtype)
    torch.testing.assert_close(matmul(a, b).float(), ref.matmul(a, b).float(),
                               rtol=tol, atol=tol)


def test_ops_sort_and_compact_match_plain(cuda_device):
    rng = np.random.default_rng(1)
    keys = _words(rng, 1 << 15, 1.0, cuda_device)
    pos = torch.arange(keys.shape[0], dtype=torch.int32, device=cuda_device)
    got_k, got_v = ops.radix_sort(keys, pos)
    want_k, want_v = ops.radix_sort(keys, pos, impl="ref")
    assert _same_words(got_k, want_k) and torch.equal(got_v, want_v)
    x = _words(rng, 1 << 15, 0.3, cuda_device)
    got, n = ops.stream_compact(x)
    want, want_n = ops.stream_compact(x, impl="ref")
    assert _same_words(got, want) and int(n) == int(want_n)


def test_cuda_tensor_never_takes_the_plain_path(cuda_device):
    before = _launches()
    x = _words(np.random.default_rng(2), 4096, 1.0, cuda_device)
    build_wah_index(ref.i64_to_u32(ref.u32_to_i64(x) % 16), 16)
    torch.cuda.synchronize()
    after = _launches()
    assert after["radix_pass"] - before["radix_pass"] == 4
    assert after["wah_interleave"] - before["wah_interleave"] == 1
    assert after["local_compact"] - before["local_compact"] == 1


def test_build_wah_index_matches_numpy(cuda_device):
    values = np.random.default_rng(3).integers(0, 64, 1 << 14).astype(np.uint32)
    words, n_words, starts, counts = build_wah_index(
        torch.from_numpy(values).to(cuda_device), 64)
    r_words, r_n, r_starts, r_counts = build_wah_index_numpy(values, 64)
    assert int(n_words) == r_n
    np.testing.assert_array_equal(words[:r_n].cpu().numpy(), r_words)
    np.testing.assert_array_equal(starts.cpu().numpy(), r_starts)
    np.testing.assert_array_equal(counts.cpu().numpy(), r_counts)


@pytest.mark.parametrize("mode", ["staged", "fused"])
def test_listing5_pipeline_on_the_card(cuda_device, mode):
    rng = np.random.default_rng(4)
    k = 1 << 12
    fills = (rng.integers(0, 2, k) * ((1 << 31) | rng.integers(1, 99, k))
             ).astype(np.uint32)
    lits = rng.integers(1, 2 ** 31, k).astype(np.uint32)
    want, want_n = ref.stream_compact(ref.wah_interleave(
        torch.from_numpy(fills), torch.from_numpy(lits)))
    with ActorSystem(max_workers=4) as system:
        assert system.opencl_manager().find_device().torch_device == cuda_device
        pipe = wah_index_pipeline_actors(system, k, mode=mode)
        before = registry.stats()
        out, n = pipe.ask(fills, lits)
        after = registry.stats()
    assert int(n) == int(want_n)
    np.testing.assert_array_equal(out, want.numpy())
    assert after["readbacks"] - before["readbacks"] == 2
    assert after["transfers"] == before["transfers"]


def test_ref_read_on_another_stream_waits_for_its_producer(cuda_device):
    """A kernel actor launches on its device's stream; a ref read on the
    caller's stream must see the finished result."""
    torch.backends.cuda.matmul.allow_tf32 = False
    slow = kernel(In(torch.float32), Out(torch.float32, as_ref=True),
                  name="slow")(lambda x: (x @ x) @ x)
    a = np.full((1024, 1024), 1e-3, np.float32)
    with ActorSystem(max_workers=2) as system:
        ref_out = system.spawn(slow).ask(a)
        dev = system.opencl_manager().find_device()
        assert ref_out._stream == dev.stream
        assert torch.cuda.current_stream(cuda_device) != dev.stream
        want = (a.astype(np.float64) @ a @ a).astype(np.float32)
        np.testing.assert_allclose(ref_out.to_value(), want, rtol=1e-4)
        ref_out.release()


def test_inout_and_spill_through_pinned_memory(cuda_device):
    bump = kernel(InOut(torch.float32, as_ref=True), name="bump")(
        lambda x: x.add_(1.0))
    with ActorSystem(max_workers=2) as system:
        ref_in = DeviceRef.put(np.zeros(4096, np.float32))
        out = system.spawn(bump).ask(ref_in)
        with pytest.raises(RuntimeError, match="donat"):
            _ = ref_in.array
        out.spill()
        assert out._host.is_pinned()
        clone = pickle.loads(pickle.dumps(out))
        clone.unspill(cuda_device)
        assert clone.device == cuda_device
        np.testing.assert_allclose(clone.to_value(), 1.0)
        out.release()
        clone.release()

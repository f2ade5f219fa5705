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

from repro_torch.configs import get_smoke_config
from repro_torch.core import (ActorSystem, DeviceRef, Graph, In, InOut, Out,
                              kernel)
from repro_torch.core.memref import registry
from repro_torch.examples.mandelbrot_offload import Frame
from repro_torch.examples.mandelbrot_offload import run as run_offload
from repro_torch.indexing import (build_wah_index, build_wah_index_numpy,
                                  wah_index_pipeline_actors)
from repro_torch.kernels import KERNELS, ops, ref
from repro_torch.kernels.flash_attention import (HEAD_DIMS,
                                                 MAX_KERNEL_WIDTH,
                                                 f32_query_tiles,
                                                 f32_vector_loads,
                                                 flash_attention, kernel_info,
                                                 kernel_operand, kernel_slabs,
                                                 kernel_width, tma_ready)
from repro_torch.kernels.matmul import INSTANTIATIONS
from repro_torch.kernels.matmul import KERNEL as MATMUL_KERNEL
from repro_torch.kernels.matmul import kernel_info as matmul_kernel_info
from repro_torch.kernels.matmul import matmul
from repro_torch.kernels.matmul import tma_ready as matmul_tma_ready
from repro_torch.kernels.radix_sort import KERNEL as RADIX_KERNEL
from repro_torch.kernels.radix_sort import TILE, radix_histogram, radix_onesweep
from repro_torch.kernels.radix_sort import kernel_info as radix_kernel_info
from repro_torch.kernels.radix_sort import radix_pass
from repro_torch.kernels.stream_compact import local_compact
from repro_torch.kernels.wah import wah_interleave
from repro_torch.models import Model

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


def _offset_slice(rows, cols, generator, device, dtype):
    """A ``rows x cols`` matrix whose base lies one element past its
    allocation's start: off 16 bytes for both kernels' wide copies."""
    flat = torch.rand(rows * cols + 1, generator=generator).to(device, dtype)
    return flat[1:].view(rows, cols)


@pytest.mark.parametrize("m,k,n,offset", [
    (128, 128, 128, False), (300, 200, 170, False), (1, 1000, 3, False),
    (129, 65, 255, False), (4095, 64, 4097, False),    # tile-ragged
    (256, 1000, 256, False),                           # K % BK != 0
    (1, 512, 300, False), (300, 512, 1, False),        # M = 1, N = 1
    (300, 200, 170, True), (257, 384, 129, True),      # A offset by 1
    (512, 4096, 512, False),                           # long K sums
])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_matmul_within_tolerance(cuda_device, m, k, n, offset, dtype, tol):
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(m * n)
    a = (_offset_slice(m, k, g, cuda_device, dtype) if offset else
         torch.rand(m, k, generator=g).to(cuda_device, dtype))
    b = torch.rand(k, n, generator=g).to(cuda_device, dtype)
    before = _launches()["matmul"]
    got = matmul(a, b)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (m, n)
    assert _launches()["matmul"] == before + 1
    torch.testing.assert_close(got.float(), ref.matmul(a, b).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("layout", ["offset_base", "odd_pitch", "transposed"])
def test_matmul_bf16_copies_what_tma_cannot_read(cuda_device, layout):
    """A bf16 operand off TMA's 16-byte rules is copied to a 16-byte row
    pitch and still goes through the kernel, once."""
    g = torch.Generator().manual_seed(8)
    b = torch.rand(384, 200, generator=g).to(cuda_device, torch.bfloat16)
    if layout == "offset_base":
        a = _offset_slice(300, 384, g, cuda_device, torch.bfloat16)
    elif layout == "odd_pitch":
        a = torch.rand(300, 385, generator=g).to(cuda_device,
                                                 torch.bfloat16)[:, :384]
    else:
        a = torch.rand(384, 300, generator=g).to(cuda_device,
                                                 torch.bfloat16).t()
    assert not matmul_tma_ready(a) and matmul_tma_ready(b)
    before = _launches()["matmul"]
    got = matmul(a, b)
    torch.cuda.synchronize()
    assert _launches()["matmul"] == before + 1
    torch.testing.assert_close(got.float(), ref.matmul(a, b).float(),
                               rtol=2e-2, atol=2e-2)


def test_matmul_kernels_compile_without_spills(cuda_device):
    """Every B1 instantiation fits its registers; the bf16 kernel runs on
    the tensor cores fed by TMA, the f32 kernels on the FMA pipes."""
    infos = matmul_kernel_info()
    assert [i["kernel"] for i in infos] == list(INSTANTIATIONS)
    for info in infos:
        assert info["spill_bytes"] == 0, info
        assert 0 < info["registers"] <= 255
        assert info["smem_bytes"] <= 232448
    for fn, ops_ in MATMUL_KERNEL.sass_opcodes().items():
        if "hgemm" in fn:
            assert ops_["HGMMA"] > 0 and ops_["UTMALDG"] > 0
        elif "sgemm" in fn:
            assert ops_["FFMA"] > 0 and not (ops_["HGMMA"] or ops_["HMMA"])


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
    """One build_wah_index sorts once: one radix_histogram and one
    radix_onesweep a pass; radix_pass (the TPU kernel's own contract) is
    not on the path."""
    before = _launches()
    by_fn = dict(RADIX_KERNEL.function_launches)
    x = _words(np.random.default_rng(2), 4096, 1.0, cuda_device)
    build_wah_index(ref.i64_to_u32(ref.u32_to_i64(x) % 16), 16)
    torch.cuda.synchronize()
    after = _launches()
    sort_launches = {fn: RADIX_KERNEL.function_launches[fn] - by_fn.get(fn, 0)
                     for fn in ("radix_histogram", "radix_onesweep",
                                "radix_pass")}
    assert sort_launches == {"radix_histogram": 1, "radix_onesweep": 4,
                             "radix_pass": 0}
    assert after["radix_pass"] - before["radix_pass"] == 5
    assert after["wah_interleave"] - before["wah_interleave"] == 1
    assert after["local_compact"] - before["local_compact"] == 1


#: key distributions of the B3 card tests; "card64" is the WAH input's
#: (values below 64: every pass but the first sees one digit)
SORT_DISTRIBUTIONS = ("random", "equal", "two_digits", "sorted", "reversed",
                      "card64")


def _sort_keys(dist, n, seed, device):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2 ** 32, n, dtype=np.uint64)
    if dist == "equal":
        x = np.full(n, 0x9E3779B9, np.uint64)
    elif dist == "two_digits":
        x = rng.choice(np.array([0x01234567, 0xFEDCBA98], np.uint64), n)
    elif dist == "sorted":
        x = np.sort(x)
    elif dist == "reversed":
        x = np.sort(x)[::-1].copy()
    elif dist == "card64":
        x = rng.integers(0, 64, n).astype(np.uint64)
    return torch.from_numpy(x.astype(np.uint32)).to(device)


@pytest.mark.parametrize("n", [1, 255, 4096, TILE - 1, TILE + 1, 1 << 20])
@pytest.mark.parametrize("dist", SORT_DISTRIBUTIONS)
@pytest.mark.parametrize("bits", [4, 8])
def test_radix_histogram_and_onesweep_are_bit_exact(cuda_device, n, dist,
                                                     bits):
    """Every pass of the onesweep kernel, fed the histogram kernel's row,
    equals the plain stable pass on the same keys and payload."""
    keys = _sort_keys(dist, n, n + bits, cuda_device)
    idx = torch.arange(n, dtype=torch.int32, device=cuda_device).flip(0)
    hist = radix_histogram(keys, bits=bits)
    assert torch.equal(hist, ref.radix_histogram(keys, bits))
    for p in range(32 // bits):
        for payload in (idx, None):
            got_k, got_i = radix_onesweep(keys, payload, hist[p], bits, p * bits)
            want_k, want_i = ref.radix_onesweep(keys, payload, hist[p], bits,
                                                p * bits)
            assert _same_words(got_k, want_k), (dist, n, bits, p)
            assert torch.equal(got_i, want_i), (dist, n, bits, p)


@pytest.mark.parametrize("dist", ["random", "equal"])
def test_radix_kernels_repeat_exactly(cuda_device, dist):
    """Three calls on the same input give the same outputs: the
    histogram's atomics add integers, and the look-back's order of
    publication does not reach the result."""
    keys = _sort_keys(dist, 1 << 20, 5, cuda_device)
    idx = torch.arange(keys.shape[0], dtype=torch.int32, device=cuda_device)
    outs = []
    for _ in range(3):
        hist = radix_histogram(keys)
        k, i = radix_onesweep(keys, idx, hist[1], 8, 8)
        outs.append((hist, k.clone(), i.clone(), ops.radix_sort(keys, idx)))
    torch.cuda.synchronize()
    for hist, k, i, (sk, si) in outs[1:]:
        assert torch.equal(hist, outs[0][0])
        assert _same_words(k, outs[0][1]) and torch.equal(i, outs[0][2])
        assert _same_words(sk, outs[0][3][0])
        assert torch.equal(si, outs[0][3][1])


def test_radix_sort_is_stable_with_few_values(cuda_device):
    """2**20 keys of 16 values: equal keys keep input order."""
    keys = _sort_keys("card64", 1 << 20, 6, cuda_device)
    keys = ref.i64_to_u32(ref.u32_to_i64(keys) % 16)
    pos = torch.arange(keys.shape[0], dtype=torch.int32, device=cuda_device)
    k, p = ops.radix_sort(keys, pos)
    k64, p64 = ref.u32_to_i64(k), p.long()
    assert torch.equal(k64, torch.sort(ref.u32_to_i64(keys)).values)
    same = k64[1:] == k64[:-1]
    assert bool((p64[1:][same] > p64[:-1][same]).all())


@pytest.mark.parametrize("n", [1, 1000, 4097, 300_000])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("vals_dtype", [torch.int32, torch.int64])
def test_ops_radix_sort_equals_plain(cuda_device, n, bits, vals_dtype):
    """int32 values ride through the passes; int64 values are gathered by
    the carried index."""
    keys = _sort_keys("random", n, n, cuda_device)
    vals = torch.arange(n, dtype=vals_dtype, device=cuda_device) * 3
    before = dict(RADIX_KERNEL.function_launches)
    got_k, got_v = ops.radix_sort(keys, vals, bits_per_pass=bits)
    want_k, want_v = ops.radix_sort(keys, vals, bits_per_pass=bits, impl="ref")
    assert _same_words(got_k, want_k) and torch.equal(got_v, want_v)
    assert (RADIX_KERNEL.function_launches["radix_onesweep"] -
            before.get("radix_onesweep", 0)) == 32 // bits


def test_radix_kernels_compile_without_spills(cuda_device):
    infos = radix_kernel_info()
    assert [i["kernel"] for i in infos] == ["radix_histogram",
                                            "radix_onesweep"]
    for info in infos:
        assert info["spill_bytes"] == 0, info
        assert 0 < info["registers"] <= 255
        assert info["smem_bytes"] <= 48 * 1024


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


VIEW = dict(re_min=-0.5, re_max=0.1, im_min=-0.7375, im_max=-0.1375)


@pytest.mark.parametrize("height,width,max_iter,row_offset,total", [
    (1080, 1920, 200, 0, 1080),     # ragged rows: 1080 is no multiple of 8
    (540, 1920, 200, 540, 1080),    # the bottom half of that frame
    (37, 300, 100, 5, 90),          # width no multiple of 128
    (8, 128, 16, 0, 8),
    (1, 1, 10, 0, 1),
])
def test_mandelbrot_kernel_is_bit_exact(cuda_device, height, width,
                                        max_iter, row_offset, total):
    kw = dict(height=height, width=width, max_iter=max_iter,
              row_offset=row_offset, total_height=total, **VIEW)
    before = _launches()["mandelbrot"]
    got = ops.mandelbrot(device=cuda_device, **kw)
    want = ops.mandelbrot(device=cuda_device, impl="ref", **kw)
    torch.cuda.synchronize()
    assert got.device == cuda_device and got.dtype == torch.int32
    assert torch.equal(got, want)
    assert _launches()["mandelbrot"] == before + 1


@pytest.mark.parametrize("b,h,hkv,sq,skv,d,causal,window", [
    (1, 2, 2, 128, 128, 64, True, None),       # MHA, causal
    (2, 4, 2, 128, 256, 64, False, None),      # GQA, not causal
    (1, 8, 1, 64, 128, 128, True, None),       # MQA
    (1, 2, 2, 128, 256, 64, True, 100),        # local window
    (1, 2, 2, 200, 70, 128, True, 16),         # Sq > Skv: blind rows
    (2, 4, 2, 33, 45, 16, True, None),         # ragged tiles
    (1, 2, 2, 300, 300, 128, True, None),      # Skv no multiple of 128
    (1, 2, 1, 100, 333, 64, True, None),       # ragged, Skv > Sq, MQA
    (1, 2, 2, 300, 130, 64, True, None),       # Sq > Skv, no window
    (1, 2, 2, 520, 520, 128, True, 200),       # window across tile edges
    (2, 4, 2, 384, 384, 128, True, None),      # GQA 2, three query tiles
    (1, 2, 1, 256, 256, 16, True, None),       # D = 16, two query tiles
    (2, 16, 8, 520, 600, 128, False, None),    # not causal, f32 128-row tiles
    (1, 16, 8, 512, 512, 128, True, None),     # the f32 prefill: 64-row tiles
    (4, 16, 8, 300, 300, 64, True, 50),        # f32 128-row tiles, D = 64
    (4, 16, 4, 300, 300, 16, True, None),      # f32 128-row tiles, D = 16
    (1, 2, 2, 256, 256, 256, True, None),      # D = 256, causal
    (1, 2, 1, 520, 520, 256, True, 200),       # D = 256, window across tiles
    (1, 16, 1, 384, 384, 256, True, None),     # D = 256, GQA 16:1
    (2, 4, 2, 201, 333, 256, True, None),      # D = 256, ragged Sq and Skv
    (1, 4, 4, 150, 270, 256, False, None),     # D = 256, not causal, Sq < Skv
    (1, 2, 2, 256, 256, 192, True, None),      # D = 192, causal
    (1, 2, 1, 520, 520, 192, True, 200),       # D = 192, window across tiles
    (1, 12, 1, 384, 384, 192, True, None),     # D = 192, GQA 12:1
    (1, 96, 8, 256, 256, 192, True, None),     # D = 192, nemotron-4's 96:8
    (2, 4, 2, 201, 333, 192, True, None),      # D = 192, ragged Sq and Skv
    (1, 4, 4, 150, 270, 192, False, None),     # D = 192, not causal, Sq < Skv
    (1, 2, 2, 256, 256, 32, True, None),       # D = 32, causal
    (2, 8, 2, 201, 333, 32, True, None),       # D = 32, GQA 4, ragged
    (4, 16, 4, 300, 300, 32, True, None),      # D = 32, f32 128-row tiles
    (1, 2, 1, 520, 520, 72, True, 200),        # D = 72 on 96, window
    (2, 4, 2, 201, 333, 72, True, None),       # D = 72, ragged Sq and Skv
    (1, 32, 32, 256, 256, 80, True, None),     # D = 80 (phi-2's) on 96
    (1, 4, 4, 150, 270, 80, False, None),      # D = 80, not causal, Sq < Skv
    (1, 32, 8, 384, 384, 96, True, None),      # D = 96 (phi-3-mini's), GQA 4
    (4, 16, 8, 300, 300, 96, True, 50),        # D = 96, f32 128-row tiles
    (1, 12, 1, 384, 384, 160, True, None),     # D = 160, GQA 12:1
    (2, 4, 2, 201, 333, 160, True, 100),       # D = 160, ragged, window
    (1, 2, 2, 200, 70, 160, True, 16),         # D = 160, Sq > Skv: blind rows
    (1, 4, 2, 256, 256, 320, True, None),      # D = 320 on 2 x 160, GQA 2
    (1, 8, 2, 520, 520, 320, True, 200),       # D = 320, GQA 4, window
    (2, 4, 2, 201, 333, 272, True, None),      # D = 272, ragged Sq and Skv
    (1, 4, 4, 150, 270, 384, False, None),     # D = 384 on 2 x 192, Sq < Skv
    (1, 16, 4, 384, 384, 512, True, None),     # D = 512 on 2 x 256, GQA 4
    (1, 8, 2, 520, 520, 512, True, 100),       # D = 512, window across tiles
    (1, 2, 2, 200, 70, 512, True, 16),         # D = 512, Sq > Skv: blind rows
    (1, 4, 1, 300, 300, 896, True, None),      # D = 896 on 7 x 128, Q streams
    (2, 4, 2, 201, 333, 1024, True, 50),       # D = 1024 on 4 x 256, window
])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 3e-2)])
def test_flash_attention_kernel_within_tolerance(cuda_device, b, h, hkv, sq,
                                                 skv, d, causal, window,
                                                 dtype, tol):
    g = torch.Generator(device=cuda_device).manual_seed(sq * skv + d)
    q = torch.randn(b, h, sq, d, generator=g, device=cuda_device).to(dtype)
    k = torch.randn(b, hkv, skv, d, generator=g, device=cuda_device).to(dtype)
    v = torch.randn(b, hkv, skv, d, generator=g, device=cuda_device).to(dtype)
    before = _launches()["flash_attention"]
    got = flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if sq > skv:
        assert (got[:, :, :sq - skv] == 0).all()
    assert _launches()["flash_attention"] == before + 1


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 3e-2)])
def test_flash_attention_takes_the_softmax_scale(cuda_device, dtype, tol):
    """granite-4.0-h-small's attention: 32 heads over 8 KV of 128, causal,
    logits scaled by 1/128 (its ``attention_multiplier``), not 1/sqrt(128),
    through ``ops.flash_attention`` as the model calls it, against SDPA
    with the same scale."""
    g = torch.Generator(device=cuda_device).manual_seed(128)
    q, k, v = (torch.randn(1, h, 1024, 128, generator=g, device=cuda_device
                           ).to(dtype) * 4 for h in (32, 8, 8))
    before = _launches()["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=True, scale=1 / 128)
    want = torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=1 / 128, enable_gqa=True)
    plain_scale = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert _launches()["flash_attention"] == before + 2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert not torch.allclose(got.float(), plain_scale.float(), rtol=tol,
                              atol=tol)


def test_device_time_reads_the_cards_time_over_the_block(cuda_device):
    """``trace.device_time`` on the card: two events around the block, read
    once by ``counters``, the card's time whatever the host did meanwhile."""
    from repro_torch import trace
    dev = torch.device(cuda_device)
    torch.cuda.synchronize()
    trace.reset()
    with trace.recording():
        with trace.device_time("t_ns", dev):
            torch.cuda._sleep(20_000_000)
        with trace.device_time("u_ns", dev):
            pass
        torch.cuda.synchronize()
        got = trace.counters()
    assert 1e6 < got["t_ns"] < 1e9
    assert 0 <= got["u_ns"] < got["t_ns"] / 100


def test_flash_attention_reads_strided_projections(cuda_device):
    """The model hands the kernel transposed [B,S,H,D] views."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randn(2, 300, 16, 128, generator=g, device=cuda_device)
    kv = torch.randn(2, 300, 8, 128, generator=g, device=cuda_device)
    q, k = x.transpose(1, 2), kv.transpose(1, 2)
    torch.testing.assert_close(flash_attention(q, k, k),
                               ref.flash_attention(q, k, k),
                               rtol=2e-4, atol=2e-4)


def test_flash_attention_reads_strided_bf16_projections(cuda_device):
    """The bf16 kernel reads the model's [B,S,H,D] views where they lie,
    through its TMA tensor maps, without a copy."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randn(2, 300, 16, 128, generator=g, device=cuda_device)
    kv = torch.randn(2, 300, 8, 128, generator=g, device=cuda_device)
    q, k = x.bfloat16().transpose(1, 2), kv.bfloat16().transpose(1, 2)
    v = (kv * 0.5).bfloat16().transpose(1, 2)
    assert all(kernel_operand(t) is t for t in (q, k, v))
    before = _launches()["flash_attention"]
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(),
                               ref.flash_attention(q, k, v).float(),
                               rtol=3e-2, atol=3e-2)
    assert _launches()["flash_attention"] == before + 1


@pytest.mark.parametrize("d", [32, 72, 80, 96, 160, 33, 257, 272, 320, 384,
                               512, 896, 1024])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 3e-2)])
def test_flash_attention_reads_strided_views_at_the_new_widths(
        cuda_device, d, dtype, tol):
    """[B,S,H,D] projections seen as [B,H,S,D] at the head dims the widths
    32, 96 and 160 took on and above 256 in slabs, in one launch; at D =
    33 and 257 bf16 heads lie off 16 bytes, so q, k, v go through the
    pitch copy (f32 at 257: 4-byte copies)."""
    g = torch.Generator(device=cuda_device).manual_seed(d)
    x = torch.randn(2, 300, 16, d, generator=g, device=cuda_device)
    kv = torch.randn(2, 300, 8, d, generator=g, device=cuda_device)
    q, k = x.to(dtype).transpose(1, 2), kv.to(dtype).transpose(1, 2)
    v = (kv * 0.5).to(dtype).transpose(1, 2)
    if dtype == torch.bfloat16:
        assert all(tma_ready(t) == (d % 8 == 0) for t in (q, k, v))
    before = _launches()["flash_attention"]
    got = flash_attention(q, k, v, causal=True, window=120)
    want = ref.flash_attention(q, k, v, causal=True, window=120)
    torch.cuda.synchronize()
    assert _launches()["flash_attention"] == before + 1
    n, w = kernel_slabs(d)
    assert got.shape == q.shape and got.stride(2) == n * w
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 3e-2)])
def test_flash_attention_launches_at_every_head_dim(cuda_device, dtype, tol):
    """Every head dim from 1 to 256, and head dims above it on each slab
    width, launch the kernel once, ragged, GQA and causal, within the
    tolerance; none reaches the plain version."""
    above = (257, 272, 300, 320, 384, 448, 500, 512, 640, 896, 1024)
    for d in (*range(1, MAX_KERNEL_WIDTH + 1), *above):
        g = torch.Generator(device=cuda_device).manual_seed(d)
        q = torch.randn(1, 4, 67, d, generator=g, device=cuda_device)
        k, v = (torch.randn(1, 2, 131, d, generator=g, device=cuda_device)
                for _ in range(2))
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
        before = _launches()["flash_attention"]
        got = flash_attention(q, k, v, causal=True)
        want = ref.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        assert _launches()["flash_attention"] == before + 1, d
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol, msg=lambda m: f"d={d}: {m}")


@pytest.mark.parametrize("layout", ["odd_row_stride", "odd_base"])
def test_flash_attention_copies_what_tma_cannot_read(cuda_device, layout):
    """A bf16 tensor whose base or strides are off TMA's 16 bytes is copied
    contiguous and still goes through the kernel, once."""
    g = torch.Generator(device=cuda_device).manual_seed(6)
    if layout == "odd_row_stride":
        q = torch.randn(1, 4, 200, 129, generator=g,
                        device=cuda_device).bfloat16()[..., :128]
    else:
        q = torch.randn(4 * 200 * 128 + 1, generator=g,
                        device=cuda_device).bfloat16()[1:].view(1, 4, 200, 128)
    k = torch.randn(1, 2, 200, 128, generator=g, device=cuda_device).bfloat16()
    assert not tma_ready(q) and tma_ready(k)
    before = _launches()["flash_attention"]
    got = flash_attention(q, k, k, causal=True)
    torch.cuda.synchronize()
    assert _launches()["flash_attention"] == before + 1
    torch.testing.assert_close(got.float(), ref.flash_attention(
        q, k, k, causal=True).float(), rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("layout", ["odd_row_stride", "odd_base"])
def test_flash_attention_f32_reads_operands_off_16_bytes(cuda_device, layout):
    """An f32 tensor whose rows or base are off 16 bytes is read where it
    lies, 4 bytes a thread: one launch, no copy."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    if layout == "odd_row_stride":
        q, k, v = (torch.randn(1, h, 300, 129, generator=g,
                               device=cuda_device)[..., :128]
                   for h in (16, 8, 8))
    else:
        q, k, v = (torch.randn(h * 300 * 128 + 1, generator=g,
                               device=cuda_device)[1:].view(1, h, 300, 128)
                   for h in (16, 8, 8))
    assert all(kernel_operand(t) is t and not f32_vector_loads(t)
               for t in (q, k, v))
    before = _launches()["flash_attention"]
    got = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert _launches()["flash_attention"] == before + 1
    torch.testing.assert_close(got, ref.flash_attention(q, k, v, causal=True),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_repeats_exactly(cuda_device, dtype):
    """No atomics and no order that changes between runs: two launches on
    the same inputs give the same bits."""
    g = torch.Generator(device=cuda_device).manual_seed(8)
    q = torch.randn(2, 16, 600, 128, generator=g, device=cuda_device).to(dtype)
    k, v = (torch.randn(2, 8, 600, 128, generator=g,
                        device=cuda_device).to(dtype) for _ in range(2))
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    first = flash_attention(q, k, v, causal=True)
    second = flash_attention(q, k, v, causal=True)
    assert torch.equal(first.view(bits), second.view(bits))


def test_flash_attention_f32_kernel_info(cuda_device):
    """The f32 kernel compiles without spills at every head dim and query
    tile built for it, and fits one block an SM; so do its slab kernels
    (272 on 160, 384 on 192, 512 on 256, 896 on 128)."""
    for d in HEAD_DIMS + (272, 384, 512, 896):
        for tile in f32_query_tiles(d):
            info = kernel_info(d, torch.float32, tile)
            assert info["query_tile"] == tile and info["spill_bytes"] == 0
            assert info["kernel_width"] == kernel_width(d)
            assert 0 < info["registers"] <= 255
            assert info["smem_bytes"] <= 232448


def test_flash_attention_bf16_kernel_info(cuda_device):
    """The bf16 kernel compiles without spills and fits one block an SM;
    so do its slab kernels."""
    for d in HEAD_DIMS + (272, 384, 512, 896):
        info = kernel_info(d)
        assert info["spill_bytes"] == 0
        assert info["kernel_width"] == kernel_width(d)
        assert 0 < info["registers"] <= 255
        assert info["smem_bytes"] <= 232448


def test_offload_frames_on_the_card_and_the_cpu(cuda_device):
    frame = Frame(width=640, height=360, max_iter=60, **VIEW)
    before = registry.stats()
    launches = _launches()["mandelbrot"]
    with ActorSystem(max_workers=4) as system:
        out = run_offload(system, frame, shares=(1.0, 0.5), chunks=6)
    assert out["frame"].device == cuda_device
    assert registry.stats()["transfers"] == before["transfers"]
    assert _launches()["mandelbrot"] > launches


def test_map_over_stays_on_the_card(cuda_device):
    torch.backends.cuda.matmul.allow_tf32 = False
    w = torch.rand(256, 128, generator=torch.Generator().manual_seed(0)
                   ).to(cuda_device)
    mm = kernel(In(torch.float32), Out(torch.float32), name="mm")(
        lambda x: ops.matmul(x, w))
    x = np.random.default_rng(6).random((1024, 256), np.float32)
    with ActorSystem(max_workers=4) as system:
        g = Graph(system, name="mapped_mm")
        # no speculative re-issue: this test counts launches, and a chunk
        # that lags on a noisy host would be issued twice
        g.output(g.map_over(mm, g.source("x", torch.float32), chunks=4,
                            replicas=2, min_chunk_bytes=0,
                            straggler_factor=float("inf")))
        built = g.build()
        x_ref = DeviceRef.put(x)
        before = registry.stats()
        launches = _launches()["matmul"]
        out = built.ask(x_ref)
        after = registry.stats()
        x_ref.release()
    assert after["transfers"] == before["transfers"]
    assert _launches()["matmul"] - launches == 4
    want = ref.matmul(torch.from_numpy(x).to(cuda_device), w).cpu().numpy()
    np.testing.assert_allclose(out, want, rtol=2e-5, atol=2e-5)


def test_smoke_model_prefill_kernel_matches_plain(cuda_device):
    cfg = get_smoke_config("qwen3-1.7b")
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 100))
    model = Model(cfg, attn_impl="kernel")
    assert model.device == cuda_device
    params = model.init(0)
    before = _launches()["flash_attention"]
    got, _ = model.forward(params, {"tokens": tokens})
    want, _ = Model(cfg, attn_impl="ref").forward(params, {"tokens": tokens})
    torch.cuda.synchronize()
    assert _launches()["flash_attention"] - before == cfg.n_layers
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


def test_two_stage_pipeline_equals_the_fused_forward(cuda_device):
    """The 2-layer f32 smoke model in 2 stage actors on the card: the
    staged logits equal the fused forward's, B6 launches once a layer a
    microbatch, and the activation crosses as a DeviceRef on the card."""
    from repro_torch.dist.pipeline import (PipelineRunner,
                                           make_layer_stage_actors)
    cfg = get_smoke_config("qwen3-1.7b")
    model = Model(cfg, attn_impl="kernel", device=cuda_device)
    params = model.init(0)
    rng = np.random.default_rng(8)
    mbs = [rng.integers(0, cfg.vocab_size, (2, 100)) for _ in range(3)]
    before, traffic = _launches()["flash_attention"], registry.stats()
    with ActorSystem(max_workers=4) as system:
        runner = PipelineRunner(system, make_layer_stage_actors(
            system, model, params, n_stages=2))
        refs = runner.run(mbs, emit="ref")
    torch.cuda.synchronize()
    assert _launches()["flash_attention"] - before == cfg.n_layers * len(mbs)
    assert (registry.stats()["transfers"], registry.stats()["spills"]) == \
        (traffic["transfers"], traffic["spills"])
    for mb, ref in zip(mbs, refs):
        assert isinstance(ref, DeviceRef) and ref.device == cuda_device
        want, _ = model.forward(params, {"tokens": mb})
        assert torch.equal(ref.array, want)


# ----------------------------------------------------------------------------
# decode and serving on the card (no kernel of the port is on this path)
# ----------------------------------------------------------------------------
def _cache_leaves(cache):
    import torch.utils._pytree as pytree
    return pytree.tree_leaves(cache)


def test_decode_step_on_the_card_matches_the_cpu(cuda_device):
    """The smoke model decodes 8 teacher-forced tokens on the card and on
    the CPU from one set of weights; f32 logits within 2e-4 (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config("qwen3-1.7b")
    model = Model(cfg)
    assert model.device == cuda_device
    params = model.init(0)
    cpu_model = Model(cfg, device="cpu")
    cpu_params = cpu_model.init(0)
    for a, b in zip(params.parameters(), cpu_params.parameters()):
        b.copy_(a.cpu())
    tokens = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32))
    cache, cpu_cache = model.init_cache(2, 9), cpu_model.init_cache(2, 9)
    for t in range(8):
        got, cache = model.decode_step(params, tokens[:, t:t + 1].to(
            cuda_device), cache)
        want, cpu_cache = cpu_model.decode_step(cpu_params,
                                                tokens[:, t:t + 1], cpu_cache)
        torch.testing.assert_close(got.cpu(), want, rtol=2e-4, atol=2e-4)
    assert int(cache["len"]) == 8


def test_decode_step_on_the_card_leaves_its_cache(cuda_device):
    cfg = get_smoke_config("qwen3-1.7b")
    model = Model(cfg)
    params = model.init(1)
    cache = model.init_cache(3, 6)
    tok = torch.zeros((3, 1), dtype=torch.int32, device=cuda_device)
    _, cache = model.decode_step(params, tok, cache)
    leaves = _cache_leaves(cache)
    before = [t.clone() for t in leaves]
    a, a_cache = model.decode_step(params, tok + 1, cache)
    b, b_cache = model.decode_step(params, tok + 1, cache)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert all(torch.equal(x, y) for x, y in zip(_cache_leaves(a_cache),
                                                 _cache_leaves(b_cache)))
    assert all(torch.equal(x, y) for x, y in zip(leaves, before))


def test_engine_tokens_equal_the_sync_loop_on_the_card(cuda_device):
    from repro_torch.launch.serve import run_engine, run_sync
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config("qwen3-1.7b")
    model = Model(cfg)
    params = model.init(2)
    prompts = [int(t) for t in np.random.default_rng(9).integers(
        0, cfg.vocab_size, 4)]
    run = run_engine(model, params, requests=4, batch=4, steps=12, workers=2,
                     prompts=prompts, timeout=300)
    sync = run_sync(model, params, batch=4, steps=12, prompts=prompts)
    assert [list(r.tokens) for r in run["results"]] == sync["tokens"].tolist()
    assert run["memref_after"]["transfers"] == \
        run["memref_before"]["transfers"]


def test_paged_engine_tokens_equal_contiguous_on_the_card(cuda_device):
    from repro_torch.launch.serve import (contiguous_tokens, paged_model,
                                          run_paged)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config("qwen3-1.7b")
    run = run_paged(cfg, cuda_device, requests=9, batch=4, steps=10,
                    workers=2, prefill_workers=2, pages=128, timeout=300)
    assert run["pool"].device == cuda_device
    prefill_fn, step_fn = paged_model(run["weights"])
    for p, r in zip(run["prompts"], run["results"]):
        assert contiguous_tokens(prefill_fn, step_fn, p, 10) == \
            [int(t) for t in r.tokens]
    assert run["stats"]["prefix_hits"] > 0
    for key in ("transfers", "spills"):
        assert run["memref_after"][key] == run["memref_before"][key]
    run["pool"].evict_prefixes()
    assert run["pool"].stats()["pages_live"] == 0


def test_pages_written_on_a_side_stream_are_read_in_order(cuda_device):
    """A page written on another stream (as a prefill worker's thread
    may) and gathered on the current one: the DeviceRef makes the reader
    wait for the writer, so the gather sees the written values."""
    from repro_torch.serve import PagePool, PageTable
    pool = PagePool([((256,), torch.float32)], page_tokens=16,
                    max_pages=8, device=cuda_device)
    side = torch.cuda.Stream(device=cuda_device)
    with torch.cuda.stream(side):
        torch.cuda._sleep(50_000_000)       # hold the side stream
        entries = torch.arange(40 * 256, dtype=torch.float32,
                               device=cuda_device).reshape(40, 256)
        pages, length = pool.write_pages([entries])
    assert all(p.refs[0]._stream == side for p in pages)
    table = PageTable(pool, pages=pages, length=length)
    (got,) = table.gather()                 # on the default stream
    want = torch.arange(40 * 256, dtype=torch.float32).reshape(40, 256)
    assert torch.equal(got[:40].cpu(), want)
    table.release_pages()


def test_launch_serve_binds_the_card(cuda_device, capsys):
    from repro_torch.launch import serve as launch_serve
    assert launch_serve.main(["--arch", "qwen3-1.7b", "--requests", "4",
                              "--batch", "4", "--steps", "4"]) == 0
    assert "tok/s" in capsys.readouterr().out


# -- the network layer on the card -------------------------------------------
@pytest.fixture()
def card_nodes(cuda_device):
    from repro_torch.net import NodeRuntime
    sa = ActorSystem("card-a", max_workers=4)
    sb = ActorSystem("card-b", max_workers=4)
    na = NodeRuntime(sa, name="a", listen=("127.0.0.1", 0))
    nb = NodeRuntime(sb, name="b")
    nb.connect(na.address)
    assert na.wait_for_peer("b", 30)
    yield sa, sb, na, nb
    na.shutdown()
    nb.shutdown()
    sa.shutdown()
    sb.shutdown()


@pytest.mark.parametrize("compress", [False, True])
def test_device_ref_hop_between_nodes_on_the_card(card_nodes, cuda_device,
                                                  compress):
    """Two nodes in one process, both bound to cuda:0: a DeviceRef sent to
    a remote stage and back spills and unspills once per hop on each side
    (one shared registry: two of each) and lands on the card, equal to
    the same computation on the CPU — through the int8 codec of each hop
    when compressed."""
    from repro_torch.core import memory_stats, reset_transfer_stats
    from repro_torch.dist.collectives import dequantize_ref, quantize_ref
    from repro_torch.net.demo import stage_square

    def codec(t):
        return dequantize_ref(*quantize_ref(t)).array

    sa, sb, na, nb = card_nodes
    assert na.unspill_device == cuda_device == nb.unspill_device
    na.compress = nb.compress = compress
    nb.publish("sq", sb.spawn(stage_square))
    remote = na.remote_actor("b", "sq", timeout=60)
    x = torch.linspace(-3, 3, 4096, device=cuda_device)
    ref = DeviceRef(x.clone())
    reset_transfer_stats()
    out = remote.ask(ref, timeout=60)
    stats = memory_stats()
    assert stats["spills"] == 2 and stats["unspills"] == 2, stats
    assert out.device == cuda_device and not ref.is_spilled
    host = x.cpu()
    want = codec(codec(host).square()) if compress else host * host
    assert torch.equal(out.array.cpu(), want)


def test_int8_codec_on_the_card_equals_the_cpu(cuda_device):
    """Bit for bit, over absmax values where absmax × f32(1/127) misses
    absmax / 127 (the card's scalar division) as well as those where it
    does not."""
    from repro_torch.dist.collectives import dequantize_ref, quantize_ref
    rng = np.random.default_rng(5)
    sweep = [np.array([a, -a / 3, a / 7], np.float32)
             for a in np.linspace(0.5, 10, 500, dtype=np.float32)]
    inv = np.float32(1) / np.float32(127)
    assert sum(x[0] * inv != x[0] / np.float32(127) for x in sweep) > 10
    for x in [rng.standard_normal(1 << 20).astype(np.float32) * 7,
              np.array([127, 2.5, -2.5, 0.5, -1.5, 126.5], np.float32),
              np.zeros(9, np.float32)] + sweep:
        host = torch.from_numpy(x)
        q_cpu, s_cpu = quantize_ref(host)
        q_gpu, s_gpu = quantize_ref(host.to(cuda_device))
        assert q_gpu.device == cuda_device and s_gpu == s_cpu
        assert torch.equal(q_gpu.array.cpu(), q_cpu.array)
        for dt in (torch.float32, torch.bfloat16):
            a = dequantize_ref(q_gpu, s_gpu, dtype=dt).array.cpu()
            b = dequantize_ref(q_cpu, s_cpu, dtype=dt).array
            assert a.dtype == dt and torch.equal(a, b)


def test_bf16_leaf_and_ref_cross_the_wire_as_bf16(cuda_device):
    from repro_torch.net import wire
    x = torch.randn(5, 7, device=cuda_device).bfloat16()
    leaf, ref = wire.decode(wire.encode((x, DeviceRef(x.clone()))),
                            device=cuda_device)
    assert leaf.dtype == torch.bfloat16 and leaf.device.type == "cpu"
    assert torch.equal(leaf, x.cpu())
    assert ref.dtype == torch.bfloat16 and ref.device == cuda_device
    assert torch.equal(ref.array, x)


def test_run_worker_binds_the_card(cuda_device):
    """A worker process started by spawn with device="cuda" binds its own
    cuda:0: refs it is sent land there, and its node says so."""
    import multiprocessing as mp

    from repro_torch.launch.node import run_worker
    from repro_torch.net import NodeRuntime
    from repro_torch.net.demo import stage_square
    system = ActorSystem("card-driver", max_workers=4)
    node = NodeRuntime(system, name="driver", listen=("127.0.0.1", 0))
    child = mp.get_context("spawn").Process(
        target=run_worker, args=(node.address, "card-worker"),
        kwargs={"device": "cuda"}, daemon=True)
    child.start()
    try:
        assert node.wait_for_peer("card-worker", 120)
        assert node.peer_stats("card-worker", timeout=60)["device"] == "cuda:0"
        sq = node.spawn_remote("card-worker", stage_square, timeout=60)
        x = torch.arange(16, dtype=torch.float32, device=cuda_device)
        out = sq.ask(DeviceRef(x), timeout=60)
        assert out.device == cuda_device and torch.equal(out.array, x * x)
        worker = node.peer_stats("card-worker", timeout=60)
        assert worker["spills"] == 1 and worker["unspills"] == 1, worker
    finally:
        node.shutdown()
        system.shutdown()
        if child.is_alive():
            child.kill()
        child.join(timeout=30)
    assert not child.is_alive()


# -- training ----------------------------------------------------------------------
def _train_inputs(dtype="float32", batch=4, seq=32):
    import dataclasses

    from repro_torch.data import SyntheticLM
    cfg = dataclasses.replace(get_smoke_config("qwen3-1.7b"),
                              param_dtype=dtype, compute_dtype=dtype)
    return cfg, SyntheticLM(cfg, batch=batch, seq=seq, seed=3).batch_at(0)


def test_train_step_on_the_card_matches_the_cpu(cuda_device):
    import torch.utils._pytree as pytree

    from repro_torch.dist.step import (build_train_step, init_train_state,
                                       loss_and_grads)
    from repro_torch.optim import AdamWConfig
    cfg, batch = _train_inputs()
    lr = 1e-3
    ocfg = AdamWConfig(lr=lr)
    cpu, card = Model(cfg, device="cpu"), Model(cfg, device=cuda_device)
    state = init_train_state(card, 0, ocfg)
    state_cpu = pytree.tree_map(lambda t: t.cpu(), state)
    g_card = loss_and_grads(card, state["params"], batch)
    g_cpu = loss_and_grads(cpu, state_cpu["params"], batch)
    np.testing.assert_allclose(float(g_card[0]), float(g_cpu[0]), rtol=1e-5)
    for a, b in zip(pytree.tree_leaves(g_card[2]), pytree.tree_leaves(g_cpu[2])):
        assert a.device == cuda_device
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-3,
                                   atol=1e-5)
    new, m = build_train_step(card, ocfg, grad_accum=2)(state, batch)
    new_cpu, m_cpu = build_train_step(cpu, ocfg, grad_accum=2)(state_cpu, batch)
    np.testing.assert_allclose(float(m["loss"]), float(m_cpu["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(m_cpu["grad_norm"]), rtol=1e-4)
    for a, b in zip(pytree.tree_leaves(new), pytree.tree_leaves(new_cpu)):
        assert a.device == cuda_device and a.dtype == b.dtype
        np.testing.assert_allclose(a.cpu().double().numpy(),
                                   b.double().numpy(), rtol=0,
                                   atol=2.1 * lr)


def test_kernel_attention_raises_under_grad_on_the_card(cuda_device):
    from repro_torch.dist.step import loss_and_grads
    from repro_torch.models.layers import plain_tree
    for dtype in ("float32", "bfloat16"):
        cfg, batch = _train_inputs(dtype)
        model = Model(cfg, attn_impl="kernel", device=cuda_device)
        params = model.init(0)
        before = _launches()
        with pytest.raises(NotImplementedError, match="ROADMAP B6"):
            loss_and_grads(model, plain_tree(params), batch)
        assert _launches() == before
        model.forward(params, batch)                    # serving launches it
        assert (_launches()["flash_attention"] ==
                before["flash_attention"] + cfg.n_layers)


def test_bf16_train_state_survives_a_checkpoint_on_the_card(cuda_device,
                                                           tmp_path):
    import torch.utils._pytree as pytree

    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.dist.step import build_train_step, init_train_state
    from repro_torch.optim import AdamWConfig
    cfg, batch = _train_inputs("bfloat16")
    model = Model(cfg, device=cuda_device)
    ocfg = AdamWConfig()
    state, _ = build_train_step(model, ocfg)(
        init_train_state(model, 0, ocfg), batch)
    ckpt.save(str(tmp_path), 1, state)
    restored, manifest = ckpt.restore(str(tmp_path), target=state)
    assert manifest["step"] == 1
    dtypes = set()
    for a, b in zip(pytree.tree_leaves(restored), pytree.tree_leaves(state)):
        assert a.device == b.device == cuda_device and a.dtype == b.dtype
        assert torch.equal(a.view(torch.uint8) if a.dim() else a,
                           b.view(torch.uint8) if b.dim() else b)
        dtypes.add(a.dtype)
    assert dtypes == {torch.bfloat16, torch.float32, torch.int32}


def test_counter_on_a_bf16_matmul_on_the_card_counts_as_on_meta(cuda_device):
    """The roofline counter counts a bf16 product on the card as it counts
    the same product on ``meta``: 2·m·n·k FLOPs, both operands read and
    the result written once."""
    from repro_torch.roofline.counter import count
    m, k, n = 512, 1024, 256
    got = {}
    for dev in (cuda_device, torch.device("meta")):
        a = torch.ones(m, k, dtype=torch.bfloat16, device=dev)
        b = torch.ones(k, n, dtype=torch.bfloat16, device=dev)
        _, st = count(lambda: a @ b, dev.type)
        got[dev.type] = (st.flops, st.bytes_accessed, st.flops_by_op)
    assert got["cuda"] == got["meta"] == (
        2 * m * n * k, 2 * (m * k + k * n + m * n), {"aten.mm": 2 * m * n * k})


# -- the AdamW kernel --------------------------------------------------------------
_ADAMW_DTYPES = [(g, p, s) for g in (torch.bfloat16, torch.float32)
                 for p in (torch.bfloat16, torch.float32)
                 for s in (torch.float32, torch.bfloat16)]
#: leaf sizes: one element, under one 8-element group, whole groups and a
#: tail, two chunks and one element, and over 4 M elements
_ADAMW_SIZES = (1, 7, 2047, 65537, (1 << 22) + 3)


def _qwen3_smoke_shapes(n_layers=28):
    """The leaf shapes of qwen3-1.7b's smoke config at 28 layers: 310."""
    import dataclasses

    import torch.utils._pytree as pytree

    from repro_torch.models.layers import plain_tree
    cfg = dataclasses.replace(get_smoke_config("qwen3-1.7b"),
                              n_layers=n_layers)
    return [tuple(t.shape) for t in pytree.tree_leaves(
        plain_tree(Model(cfg, device="meta").param_shapes()))]


def _offset(t):
    """``t``'s values in a view one element into its storage: an address
    that no 16-byte load may take."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:].copy_(t.flatten())
    return buf[1:].view(t.shape)


def _adamw_leaves(shapes, g_dt, p_dt, s_dt, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    draw = lambda shape, scale: torch.randn(shape, generator=gen,
                                            device=dev) * scale
    g = [draw(s, 3.0).to(g_dt) for s in shapes]
    m = [draw(s, 0.1).to(s_dt) for s in shapes]
    v = [draw(s, 0.1).square().to(s_dt) for s in shapes]
    p = [draw(s, 1.0).to(p_dt) for s in shapes]
    return g, m, v, p


def _adamw_cfg(s_dt):
    from repro_torch.optim import AdamWConfig
    return AdamWConfig(lr=1e-3, state_dtype=str(s_dt).removeprefix("torch."))


def _adamw_scalars(dev, scale):
    """``[scale, bc1, bc2, lr]`` at count 3, as ``adamw.update`` makes
    them, and the Python ``lr`` the loop takes."""
    cfg = _adamw_cfg(torch.float32)
    c = torch.tensor(3.0, device=dev)
    bc1, bc2 = 1.0 - torch.pow(cfg.b1, c), 1.0 - torch.pow(cfg.b2, c)
    return (torch.stack([scale, bc1, bc2, torch.full((), cfg.lr,
                                                      device=dev)]),
            bc1, bc2, cfg.lr)


def _adamw_loop(g, m, v, p, scale, bc1, bc2, lr, cfg):
    from repro_torch.optim import adamw
    out = [adamw.leaf_update(gi * scale.to(gi.dtype), mi, vi, pi, bc1, bc2,
                             lr, cfg) for gi, mi, vi, pi in zip(g, m, v, p)]
    return [list(o) for o in zip(*out)]


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _same_bits(a, b):
    return (a.dtype == b.dtype and a.shape == b.shape and
            torch.equal(_bits(a), _bits(b)))


def _adamw_function_launches():
    from repro_torch.kernels.adamw import KERNEL
    return dict(KERNEL.function_launches)


@pytest.mark.parametrize("g_dt,p_dt,s_dt", _ADAMW_DTYPES)
def test_adamw_kernel_equals_the_loop_bit_for_bit(cuda_device, g_dt, p_dt,
                                                  s_dt):
    """The same scalars give the loop's p', m' and v' to the bit, with a
    clip scale and with none (1), over ragged and large leaves, a leaf
    whose every pointer is unaligned, a transposed gradient, and
    qwen3-1.7b's 310 smoke leaves."""
    from repro_torch.kernels.adamw import Leaves
    cfg = _adamw_cfg(s_dt)
    shapes = [(n,) for n in _ADAMW_SIZES] + [(33, 70)] + \
        _qwen3_smoke_shapes()
    g, m, v, p = _adamw_leaves(shapes, g_dt, p_dt, s_dt, cuda_device)
    g[0], m[1], v[2], p[3] = _offset(g[0]), _offset(m[1]), _offset(v[2]), \
        _offset(p[3])
    g[4], m[4], v[4], p[4] = (_offset(t) for t in (g[4], m[4], v[4], p[4]))
    g[5] = g[5].t().contiguous().t()                # column-major gradient
    assert not g[5].is_contiguous()
    for scale in (torch.tensor(0.37, device=cuda_device),
                  torch.ones((), device=cuda_device)):
        scalars, bc1, bc2, lr = _adamw_scalars(cuda_device, scale)
        got = Leaves(g, m, v, p, s_dt).update(
            scalars, b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
            weight_decay=cfg.weight_decay)
        want = _adamw_loop(g, m, v, p, scale, bc1, bc2, lr, cfg)
        for name, gl, wl in zip("pmv", got, want):
            for i, (a, b) in enumerate(zip(gl, wl)):
                assert a.device == cuda_device
                assert _same_bits(a, b), (name, i, shapes[i], float(scale),
                                          (a.float() - b.float()).abs().max())


def test_adamw_leaves_give_the_same_bits_when_called_again(cuda_device):
    """A second ``sums_of_squares`` and ``update`` on one ``Leaves`` read
    the same inputs, the contiguous copies of non-contiguous leaves too,
    though the allocator has handed out blocks of their size between the
    calls."""
    from repro_torch.kernels.adamw import Leaves
    cfg = _adamw_cfg(torch.float32)
    g, m, v, p = _adamw_leaves([(33, 70), (2047,), (64, 48)], torch.bfloat16,
                               torch.bfloat16, torch.float32, cuda_device)
    g[0], m[2] = g[0].t().contiguous().t(), m[2].t().contiguous().t()
    leaves = Leaves(g, m, v, p, torch.float32)
    scalars = _adamw_scalars(cuda_device,
                             torch.tensor(0.37, device=cuda_device))[0]
    kw = dict(b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
              weight_decay=cfg.weight_decay)
    sums = leaves.sums_of_squares().clone()
    first = [[t.clone() for t in out] for out in leaves.update(scalars, **kw)]
    junk = [torch.full_like(t, float("nan")) for t in (g[0], m[2])
            for _ in range(8)]
    assert _same_bits(leaves.sums_of_squares(), sums)
    for a, b in zip(first, leaves.update(scalars, **kw)):
        assert all(_same_bits(x, y) for x, y in zip(a, b))
    del junk


@pytest.mark.parametrize("g_dt", [torch.bfloat16, torch.float32])
def test_adamw_kernel_sums_of_squares(cuda_device, g_dt):
    from repro_torch.kernels.adamw import Leaves
    shapes = [(n,) for n in _ADAMW_SIZES] + [(0,), (33, 70)]
    g, m, v, p = _adamw_leaves(shapes, g_dt, torch.float32, torch.float32,
                               cuda_device)
    g[2] = _offset(g[2])
    got = Leaves(g, m, v, p, torch.float32).sums_of_squares()
    want = torch.stack([torch.sum(x.float() ** 2) for x in g])
    assert got.dtype == torch.float32 and got.shape == (len(shapes),)
    assert float(got[5]) == 0.0
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-6)


def _adamw_state(shapes, dev, seed=0):
    from repro_torch.optim import adamw
    cfg = _adamw_cfg(torch.float32)
    g, m, v, p = _adamw_leaves(shapes, torch.bfloat16, torch.bfloat16,
                               torch.float32, dev, seed)
    tree = lambda leaves: {f"w{i}": t for i, t in enumerate(leaves)}
    state = {"m": tree(m), "v": tree(v),
             "count": torch.tensor(2, dtype=torch.int32, device=dev)}
    return tree(g), state, tree(p), cfg, adamw


def test_adamw_update_on_the_card_is_pure_repeatable_and_the_loops(
        cuda_device):
    """Through ``adamw.update`` on qwen3-1.7b's 310 smoke leaves: two
    calls give the same bits, the inputs are left as they were, every
    leaf is counted as the kernel's, the norm is the loop's within 1e-6,
    and the update is the loop's to the bit at the kernel's clip scale."""
    import torch.utils._pytree as pytree

    from repro_torch import trace
    grads, state, params, cfg, adamw = _adamw_state(_qwen3_smoke_shapes(),
                                                    cuda_device)
    before = [t.clone() for t in pytree.tree_leaves((grads, state, params))]
    with trace.recording():
        a = adamw.update(grads, state, params, cfg)
        counts = trace.counters()
    b = adamw.update(grads, state, params, cfg)
    assert counts["optim.fused_leaves"] == 310
    assert counts["optim.loop_leaves"] == 0
    assert counts["cuda.adamw_update"] == 1
    for x, y in zip(pytree.tree_leaves(a), pytree.tree_leaves(b)):
        assert _same_bits(x, y)
    for x, y in zip(before, pytree.tree_leaves((grads, state, params))):
        assert _same_bits(x, y)
    g = pytree.tree_leaves(grads)
    gnorm = a[2]["grad_norm"]
    np.testing.assert_allclose(float(gnorm), float(adamw.global_norm(g)),
                               rtol=1e-6)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    c = (state["count"] + 1).float()
    want = _adamw_loop(g, pytree.tree_leaves(state["m"]),
                       pytree.tree_leaves(state["v"]),
                       pytree.tree_leaves(params), scale,
                       1.0 - torch.pow(cfg.b1, c), 1.0 - torch.pow(cfg.b2, c),
                       cfg.lr, cfg)
    got = [pytree.tree_leaves(a[0]), pytree.tree_leaves(a[1]["m"]),
           pytree.tree_leaves(a[1]["v"])]
    for gl, wl in zip(got, want):
        assert all(_same_bits(x, y) for x, y in zip(gl, wl))
    assert int(a[1]["count"]) == 3


@pytest.mark.parametrize("n_leaves", [1, 10, 310])
def test_adamw_update_launches_do_not_grow_with_the_leaves(cuda_device,
                                                           n_leaves):
    grads, state, params, cfg, adamw = _adamw_state(
        _qwen3_smoke_shapes()[:n_leaves], cuda_device)
    before = _adamw_function_launches()
    adamw.update(grads, state, params, cfg, torch.tensor(0.5))
    after = _adamw_function_launches()
    assert {k: after[k] - before.get(k, 0) for k in after} == {
        "adamw_norm_chunks": 1, "adamw_norm_leaves": 1, "adamw_update": 1}

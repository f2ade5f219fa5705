"""The port's Mandelbrot (kernel B2's plain version, ``ops.mandelbrot``)
and the fractional-offload example against the JAX package.

The counts must agree bit for bit: the port rounds after every f32
operation, as the Pallas kernel does when it is interpreted at the sweep
shapes of ``tests/test_kernels.py``. At the 128x256x100 frame of
``benchmarks/bench_offload.py`` JAX's CPU code contracts or reorders the
f32 arithmetic and leaves the strict result at a few pixels; there the
port is held bit-exact against a numpy loop that rounds every operation,
and against JAX only to the 98 % the JAX benchmark itself accepts.
The kernel itself runs only on a card (``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core import ActorSystem
from repro_torch.examples.mandelbrot_offload import Frame, run
from repro_torch.kernels import KERNELS, ops, ref
from repro_torch.kernels.mandelbrot import mandelbrot as mandelbrot_kernel

VIEW = dict(re_min=-0.5, re_max=0.1, im_min=-0.7375, im_max=-0.1375)


def _strict_numpy(height, width, max_iter, row_offset=0, total_height=None,
                  **view):
    """Escape counts with numpy f32 scalars: every operation rounded."""
    th = total_height or height
    f = np.float32
    re_step = f((view["re_max"] - view["re_min"]) / max(width - 1, 1))
    im_step = f((view["im_max"] - view["im_min"]) / max(th - 1, 1))
    x = f(view["re_min"]) + np.arange(width, dtype=f) * re_step
    y = f(view["im_min"]) + (np.arange(height, dtype=f) + f(row_offset)) * im_step
    cr, ci = np.broadcast_arrays(x[None, :], y[:, None])
    zr = np.zeros(cr.shape, f)
    zi = np.zeros(cr.shape, f)
    count = np.zeros(cr.shape, np.int32)
    for _ in range(max_iter):
        zr2, zi2 = zr * zr, zi * zi
        alive = (zr2 + zi2) <= f(4.0)
        nzr = (zr2 - zi2) + cr
        nzi = (f(2.0) * zr) * zi + ci
        zr = np.where(alive, nzr, zr)
        zi = np.where(alive, nzi, zi)
        count += alive
    return count


@pytest.mark.parametrize("h,w,it", [(8, 128, 16), (16, 256, 64), (24, 128, 100)])
@pytest.mark.parametrize("impl", ["auto", "ref"])
def test_mandelbrot_matches_pallas(h, w, it, impl):
    kw = dict(height=h, width=w, max_iter=it, **VIEW)
    want = np.asarray(jops.mandelbrot(impl="pallas", **kw))
    got = ops.mandelbrot(impl=impl, device="cpu", **kw)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("width", [128, 100])
def test_row_offset_slices_tile_the_frame(width):
    """Fractional offload slices tile to the whole frame (paper §5.4), and
    match the JAX package's slices (interpreted Pallas where the width is
    a multiple of 128, its oracle otherwise)."""
    kw = dict(width=width, max_iter=32, re_min=-2.0, re_max=1.0,
              im_min=-1.5, im_max=1.5)
    full = ops.mandelbrot(height=32, total_height=32, device="cpu", **kw)
    parts = [ops.mandelbrot(height=n, row_offset=s, total_height=32,
                            device="cpu", **kw)
             for s, n in ((0, 16), (16, 11), (27, 5))]
    assert torch.equal(torch.cat(parts), full)
    want = np.asarray(jops.mandelbrot(height=32, total_height=32,
                                      impl="pallas", **kw))
    np.testing.assert_array_equal(full.numpy(), want)
    top = np.asarray(jops.mandelbrot(height=16, row_offset=16,
                                     total_height=32, impl="pallas", **kw))
    np.testing.assert_array_equal(
        ops.mandelbrot(height=16, row_offset=16, total_height=32,
                       device="cpu", **kw).numpy(), top)


def test_offload_frame_strict_f32_and_jax_within_its_benchmark_bound():
    kw = dict(height=128, width=256, max_iter=100, **VIEW)
    got = ops.mandelbrot(device="cpu", **kw).numpy()
    np.testing.assert_array_equal(got, _strict_numpy(**kw))
    # XLA:CPU contracts/reorders f32 at this size (JAX's own oracle leaves
    # the strict loop at ~11 pixels), so JAX is held to its benchmark's
    # bound, bench_offload.py:53-59
    assert np.mean(got == np.asarray(jops.mandelbrot(impl="ref", **kw))) > 0.98


def test_kernel_wrapper_takes_the_plain_version_on_the_cpu():
    view = ref.mandelbrot_view(130, 40, **VIEW)
    before = {k.name: k.launches for k in KERNELS}
    got = mandelbrot_kernel(height=7, width=130, max_iter=50, view=view,
                            row_offset=11, device=torch.device("cpu"))
    assert {k.name: k.launches for k in KERNELS} == before
    want = _strict_numpy(7, 130, 50, row_offset=11, total_height=40, **VIEW)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        mandelbrot_kernel(height=-1, width=8, max_iter=1, view=view,
                          device="cpu")


def test_view_is_rounded_to_f32_once():
    view = ref.mandelbrot_view(1920, 1080, **VIEW)
    assert view.re_step == float(np.float32(0.6 / 1919))
    assert view.im_min == float(np.float32(-0.7375))
    assert all(float(np.float32(v)) == v for v in view)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(LookupError):
        ops.mandelbrot(height=8, width=8, max_iter=4, **VIEW)


def test_offload_example_frames_equal_on_the_cpu():
    frame = Frame(width=96, height=40, max_iter=40, **VIEW)
    with ActorSystem(max_workers=4, device="cpu") as system:
        out = run(system, frame, shares=(1.0, 0.9, 0.5, 0.0), chunks=6)
    assert set(out["walls"]) == {"100%", "90%", "50%", "0%", "scheduled"}
    np.testing.assert_array_equal(
        out["frame"].numpy(),
        _strict_numpy(40, 96, 40, re_min=frame.re_min, re_max=frame.re_max,
                      im_min=frame.im_min, im_max=frame.im_max))

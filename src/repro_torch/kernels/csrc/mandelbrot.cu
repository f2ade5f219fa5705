// Escape-time iteration counts of a row slice of a Mandelbrot frame.
//
// Replaces the JAX package's kernels/mandelbrot.py::pallas_mandelbrot
// (body _mandelbrot_kernel): one (8, 128) VPU tile per grid step, the
// coordinates derived from the tile's iota plus the grid offsets, and a
// masked fori_loop of max_iter steps over the whole tile.
//
// Rows [row_offset, row_offset + height) of a total_height x width frame
// are written to an int32 [height, width] array; a worker of the paper's
// fractional offload (section 5.4) renders its rows with coordinates
// consistent with the whole frame.
//
// What bounds it on an H100: it reads nothing and writes 4 bytes a
// pixel, while each pixel runs up to max_iter iterations of 9 f32 ops
// (4 products, 4 sums, 1 compare) plus the loop. It is bound by
// operations on the SIMT f32 pipes (67 TFLOP/s), and the work depends on
// the data: a pixel inside the set runs all max_iter iterations, one far
// outside stops after a few.
//
// Design: one thread per pixel, 128-thread blocks along a row. The TPU
// runs every pixel for max_iter steps under a mask; here a thread leaves
// its loop when its pixel escapes, and a warp retires once all 32 lanes
// have. That gives the same counts: once |z|^2 > 4 the TPU's mask freezes
// z, so the pixel stays escaped and its count stops growing.
//
// Numerics: the result must equal the plain PyTorch version (and the JAX
// oracle at the test shapes) bit for bit. Every product and sum is
// rounded on its own, in the order of mandelbrot.py:36-42, with the _rn
// intrinsics, which nvcc never contracts into an FMA; the coordinate steps
// and origins arrive already rounded to f32 by the wrapper. The row index
// is converted to f32 exactly (frames are far below 2^24 rows).
#include "common.cuh"

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
    mandelbrot_kernel(int* __restrict__ out, int height, int width,
                      int row_offset, int max_iter, float re_min,
                      float im_min, float re_step, float im_step) {
  const int col = blockIdx.x * THREADS + threadIdx.x;
  const int row = blockIdx.y;
  if (col >= width) return;
  const float cr = __fadd_rn(re_min, __fmul_rn(static_cast<float>(col), re_step));
  const float ci = __fadd_rn(
      im_min, __fmul_rn(static_cast<float>(row + row_offset), im_step));
  float zr = 0.f;
  float zi = 0.f;
  int count = 0;
  for (; count < max_iter; ++count) {
    const float zr2 = __fmul_rn(zr, zr);
    const float zi2 = __fmul_rn(zi, zi);
    if (!(__fadd_rn(zr2, zi2) <= 4.f)) break;
    const float nzr = __fadd_rn(__fsub_rn(zr2, zi2), cr);
    const float nzi = __fadd_rn(__fmul_rn(__fmul_rn(2.f, zr), zi), ci);
    zr = nzr;
    zi = nzi;
  }
  out[static_cast<size_t>(row) * width + col] = count;
}

}  // namespace

extern "C" int mandelbrot(void* out, int height, int width, int row_offset,
                          int max_iter, float re_min, float im_min,
                          float re_step, float im_step, void* stream) {
  const dim3 grid((width + THREADS - 1) / THREADS, height);
  mandelbrot_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(out), height, width, row_offset, max_iter, re_min,
      im_min, re_step, im_step);
  REPRO_LAUNCH_RESULT();
}

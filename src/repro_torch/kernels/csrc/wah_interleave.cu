// WAH prepare_index: out[2i] = fills[i], out[2i+1] = literals[i].
//
// Replaces the JAX package's kernels/wah.py::pallas_wah_interleave, which
// writes one interleaved double-width VMEM block per grid step.
//
// What bounds it on an H100: a pure layout transform, 8 bytes read and 8
// bytes written a pair and no arithmetic, so it is bound by bytes.
//
// Design: one thread a pair in a grid-stride loop. The two 32-bit words of
// a pair go out as one 64-bit (uint2) store, so neighbouring threads write
// neighbouring 8-byte slots and every warp writes 256 contiguous bytes;
// the loads of fills and literals are coalesced 4-byte reads.
#include "common.cuh"

namespace {

__global__ void wah_interleave_kernel(const uint32_t* __restrict__ fills,
                                      const uint32_t* __restrict__ literals,
                                      uint2* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = make_uint2(fills[i], literals[i]);
  }
}

}  // namespace

extern "C" int wah_interleave(const void* fills, const void* literals,
                              void* out, long long n, void* stream) {
  constexpr int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > (1ll << 20)) blocks = 1ll << 20;
  wah_interleave_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(fills), static_cast<const uint32_t*>(literals),
      static_cast<uint2*>(out), n);
  REPRO_LAUNCH_RESULT();
}

// One LSD radix-sort digit pass: per block of bs keys, the histogram of
// one digit of at most 8 bits and each key's stable rank among the
// block's keys with the same digit.
//
// Replaces the JAX package's kernels/radix_sort.py::pallas_radix_pass.
// The TPU has no warp shuffles, so the Pallas kernel builds a one-hot
// (bs x nbins) matrix and gets the histogram and the ranks from two matrix
// products on the MXU. On a GPU that is wasted work: warps vote directly.
//
// What bounds it on an H100: it reads 4 bytes a key and writes a 4-byte
// rank plus nbins*4 bytes of histogram a block (another 4 bytes a key at
// bs = nbins = 256), with a few integer operations a key, so it is bound
// by bytes.
//
// Design: one thread a key, one block per bs keys (bs a multiple of 32, at
// most 1024). __match_any_sync groups the lanes of a warp holding the same
// digit; the key's rank inside its warp is the popcount of its peers in
// lower lanes, which is stable by construction. The lowest peer writes the
// group's size into a per-warp, per-digit count table in shared memory;
// after one barrier each key adds the counts of the warps before its own,
// and each bin's histogram is the column sum of that table. No atomics,
// so the result does not depend on scheduling. Lanes past the end of the
// input carry the digit nbins, which lies outside every bin: they count
// nowhere and get rank 0.
#include "common.cuh"

namespace {

__global__ void radix_pass_kernel(const uint32_t* __restrict__ x, long long n,
                                  int shift, int bits,
                                  int32_t* __restrict__ hist,
                                  int32_t* __restrict__ rank) {
  extern __shared__ int warp_counts[];  // [nwarps][nbins]
  const int bs = blockDim.x;
  const int nwarps = bs >> 5;
  const int nbins = 1 << bits;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * bs + threadIdx.x;

  for (int t = threadIdx.x; t < nwarps * nbins; t += bs) warp_counts[t] = 0;
  const bool valid = i < n;
  const unsigned digit =
      valid ? (x[i] >> shift) & static_cast<unsigned>(nbins - 1)
            : static_cast<unsigned>(nbins);
  __syncthreads();

  const unsigned peers = __match_any_sync(0xffffffffu, digit);
  const int in_warp = __popc(peers & lanemask_lt(lane));
  if (valid && in_warp == 0) warp_counts[warp * nbins + digit] = __popc(peers);
  __syncthreads();

  int r = 0;
  if (valid) {
    r = in_warp;
    for (int w = 0; w < warp; ++w) r += warp_counts[w * nbins + digit];
  }
  rank[i] = r;
  for (int t = threadIdx.x; t < nbins; t += bs) {
    int s = 0;
    for (int w = 0; w < nwarps; ++w) s += warp_counts[w * nbins + t];
    hist[(long long)blockIdx.x * nbins + t] = s;
  }
}

}  // namespace

extern "C" int radix_pass(const void* x, long long n, int shift, int bits,
                          int bs, void* hist, void* rank, void* stream) {
  const long long nb = (n + bs - 1) / bs;
  const size_t smem = static_cast<size_t>(bs / 32) * (1u << bits) * sizeof(int);
  radix_pass_kernel<<<static_cast<unsigned>(nb), bs, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), n, shift, bits,
      static_cast<int32_t*>(hist), static_cast<int32_t*>(rank));
  REPRO_LAUNCH_RESULT();
}

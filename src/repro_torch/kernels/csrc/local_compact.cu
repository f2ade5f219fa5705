// Per-block stream compaction: for each block of bs words, the words that
// differ from drop_value in their input order, then a zero tail, and the
// block's survivor count.
//
// Replaces the JAX package's kernels/stream_compact.py::pallas_local_compact.
// The TPU has no warp shuffles, so the Pallas kernel moves each block with
// a (bs x bs) one-hot permutation matrix on the MXU (split into 16-bit
// halves to stay exact in f32). This is the GPU algorithm that design
// replaced: Billeter, Olsson and Assarsson, "Efficient stream compaction
// on wide SIMD many-core architectures" (HPG 2009).
//
// What bounds it on an H100: it reads 4 bytes and writes 4 bytes a word,
// with a handful of integer operations, so it is bound by bytes.
//
// Design: one thread a word, one block per bs words (bs a multiple of 32,
// at most 1024). __ballot_sync gives each warp the mask of its survivors;
// a survivor's place inside its warp is the popcount of the mask below its
// lane. Warp 0 scans the per-warp counts with shuffles, which gives every
// warp its base. Each survivor then writes itself once, every slot at or
// past the block's count is written with zero, and thread 0 writes the
// count. The two sets of slots are disjoint, so no second barrier is
// needed. Lanes past the end of the input count as dropped.
#include "common.cuh"

namespace {

__global__ void local_compact_kernel(const uint32_t* __restrict__ x,
                                     long long n, uint32_t drop,
                                     uint32_t* __restrict__ blocks,
                                     int32_t* __restrict__ counts) {
  __shared__ int warp_base[33];  // exclusive base per warp, then the total
  const int bs = blockDim.x;
  const int nwarps = bs >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * bs + threadIdx.x;

  const bool in_range = i < n;
  const uint32_t v = in_range ? x[i] : 0u;
  const bool keep = in_range && v != drop;
  const unsigned ballot = __ballot_sync(0xffffffffu, keep);
  const int before = __popc(ballot & lanemask_lt(lane));
  if (lane == 0) warp_base[warp] = __popc(ballot);
  __syncthreads();

  if (warp == 0) {
    const int own = lane < nwarps ? warp_base[lane] : 0;
    int incl = own;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += up;
    }
    if (lane < nwarps) warp_base[lane] = incl - own;
    if (lane == 31) warp_base[32] = incl;
  }
  __syncthreads();

  const int total = warp_base[32];
  uint32_t* out = blocks + (long long)blockIdx.x * bs;
  if (keep) out[warp_base[warp] + before] = v;
  if (threadIdx.x >= total) out[threadIdx.x] = 0u;
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

}  // namespace

extern "C" int local_compact(const void* x, long long n, unsigned drop, int bs,
                             void* blocks, void* counts, void* stream) {
  const long long nb = (n + bs - 1) / bs;
  local_compact_kernel<<<static_cast<unsigned>(nb), bs, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), n, drop, static_cast<uint32_t*>(blocks),
      static_cast<int32_t*>(counts));
  REPRO_LAUNCH_RESULT();
}

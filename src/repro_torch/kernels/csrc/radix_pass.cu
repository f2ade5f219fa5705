// B3, the LSD radix sort of uint32 keys: three launch functions that share
// one device function, warp_rank.
//
// Replaces the JAX package's kernels/radix_sort.py::pallas_radix_pass and
// the digit offsets and scatter that kernels/ops.py::radix_sort leaves to
// XLA around it. The TPU has no warp shuffles, so the Pallas kernel builds
// a one-hot (bs x nbins) matrix and gets a block's histogram and ranks from
// two matrix products on the MXU. On a GPU warps vote directly, and a block
// can find its place among the others while it runs.
//
// * radix_pass: the TPU kernel's own contract. Per block of bs keys, the
//   histogram of one digit of at most 8 bits and each key's stable rank
//   among the block's keys with the same digit. No sort launches it; it
//   stays the direct counterpart of pallas_radix_pass.
// * radix_histogram: one read of the keys gives the digit counts of every
//   pass, int32[32/bits][2^bits], summed in shared memory and then into
//   device memory by atomics. Integer sums do not depend on their order,
//   so the result is deterministic.
// * radix_onesweep: one digit pass of a onesweep sort (Adinets and
//   Merrill, 2022): keys and an int32 payload in, both out in stable digit
//   order. A block takes a tile of kTile keys in the order of a global
//   counter, ranks its keys, finds each digit's offset among the earlier
//   tiles by a decoupled look-back, and scatters through shared memory.
//
// What bounds them on an H100: bytes. A onesweep pass reads 8 and writes 8
// bytes a key with a few integer operations a key; the histogram reads 4.
// The designs touch each byte once: ranks and counts stay in registers and
// shared memory, and a tile's keys leave in digit runs, so neighbouring
// threads write neighbouring addresses.
#include "common.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxBins = 256;
// threads of a radix_histogram and a radix_onesweep block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKeysPerThread = 16;
// keys of a onesweep tile; each warp ranks kWarpKeys neighbouring keys
constexpr int kTile = kThreads * kKeysPerThread;
constexpr int kWarpKeys = kTile / kWarps;
static_assert(kWarpKeys <= 1 << 16 && kKeysPerThread % 2 == 0,
              "two ranks share a register");
// keys a radix_histogram warp loads before it counts them
constexpr int kHistUnroll = 4;
// a look-back status word: the flag in the high half, a count in the low
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kInclusive = 2ull << 32;
// predecessors' status words a look-back thread reads at once
constexpr int kLookback = 8;
// look-back reads that find nothing new before it gives up: seconds, where
// a running predecessor publishes within microseconds. Only scratch that
// was not zeroed leaves a word unpublished, and the kernel then traps (a
// launch failure) instead of spinning on the card for ever.
constexpr int kSpinLimit = 1 << 24;

__device__ __forceinline__ unsigned digit_of(uint32_t key, int shift,
                                             unsigned mask) {
  return (key >> shift) & mask;
}

// The stable rank of this lane's key among the lanes of its warp that hold
// the same digit, plus counts[digit], the warp's count of that digit from
// its earlier rounds; adds this round's keys to counts. __match_any_sync
// groups the lanes by digit, the lowest lane of a group updates the count
// and hands the old value to its peers. Lanes with valid == false carry a
// digit outside counts: they count nowhere and get rank 0. Every lane of
// the warp calls it.
__device__ __forceinline__ int warp_rank(unsigned digit, bool valid,
                                         int* counts, int lane) {
  const unsigned peers = __match_any_sync(kFullMask, digit);
  const int leader = __ffs(peers) - 1;
  int base = 0;
  if (valid && lane == leader) {
    base = counts[digit];
    counts[digit] = base + __popc(peers);
  }
  base = __shfl_sync(kFullMask, base, leader);
  __syncwarp();
  return valid ? base + __popc(peers & lanemask_lt(lane)) : 0;
}

// Exclusive prefix sum of v over the block's threads in thread order;
// scratch holds one int a warp. Every thread of the block calls it.
__device__ __forceinline__ int block_exclusive_scan(int v, int* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int inclusive = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFullMask, inclusive, o);
    if (lane >= o) inclusive += t;
  }
  if (lane == 31) scratch[warp] = inclusive;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += scratch[w];
  __syncthreads();
  return before + inclusive - v;
}

// A look-back status word carries its flag and its count together, written
// by one 64-bit store and read by one 64-bit load, and a reader uses
// nothing else that the publishing block wrote. So neither side needs
// release or acquire ordering: gpu-scope relaxed accesses are enough, and
// they skip the fences and the in-order completion that those would cost.
__device__ __forceinline__ void store_relaxed(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

// Relaxed reads at gpu scope are not served from a stale L1 line, and
// unlike acquire reads they need not complete in order, so a look-back
// window of them is in flight at once.
__device__ __forceinline__ unsigned long long load_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

// ---------------------------------------------------------------------------
// radix_pass: one thread a key, one block per bs keys (bs a multiple of 32,
// at most 1024). Each warp ranks its keys in one round; after one barrier a
// key adds the counts of the warps before its own, and each bin's histogram
// is the column sum of the per-warp table. Lanes past the end carry the
// digit nbins, which lies outside every bin.
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
      valid ? digit_of(x[i], shift, nbins - 1) : static_cast<unsigned>(nbins);
  __syncthreads();

  int r = warp_rank(digit, valid, warp_counts + warp * nbins, lane);
  __syncthreads();
  if (valid)
    for (int w = 0; w < warp; ++w) r += warp_counts[w * nbins + digit];
  rank[i] = r;
  for (int t = threadIdx.x; t < nbins; t += bs) {
    int s = 0;
    for (int w = 0; w < nwarps; ++w) s += warp_counts[w * nbins + t];
    hist[(long long)blockIdx.x * nbins + t] = s;
  }
}

// ---------------------------------------------------------------------------
// radix_histogram: a grid-stride loop over the keys, kHistUnroll rounds of
// 32 neighbouring keys a warp at a time. One warp-wide OR of each key's
// difference from lane 0's key shows the passes in which the warp's 32 keys
// share a digit (every pass that sees one digit): there lane 0 adds 32 with
// one shared atomic; in the others each lane adds 1. hist must be zeroed
// by the caller.
__global__ void __launch_bounds__(kThreads)
radix_histogram_kernel(const uint32_t* __restrict__ x, long long n, int bits,
                       int32_t* __restrict__ hist) {
  __shared__ int counts[32 * kMaxBins / 8];  // [passes][nbins], at most 1024
  const int nbins = 1 << bits;
  const int passes = 32 / bits;
  const unsigned mask = nbins - 1;
  const int lane = threadIdx.x & 31;
  for (int t = threadIdx.x; t < passes * nbins; t += kThreads) counts[t] = 0;
  __syncthreads();

  const long long step = (long long)gridDim.x * kWarps * 32 * kHistUnroll;
  for (long long base =
           ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * 32 *
           kHistUnroll;
       base < n; base += step) {
    uint32_t key[kHistUnroll];
    bool valid[kHistUnroll];
#pragma unroll
    for (int u = 0; u < kHistUnroll; ++u) {
      const long long i = base + u * 32 + lane;
      valid[u] = i < n;
      key[u] = valid[u] ? x[i] : 0u;
    }
#pragma unroll
    for (int u = 0; u < kHistUnroll; ++u) {
      // the bits in which some key of the warp differs from lane 0's (all
      // of them when a lane lies past the end)
      const uint32_t first = __shfl_sync(kFullMask, key[u], 0);
      const unsigned differ =
          __reduce_or_sync(kFullMask, valid[u] ? key[u] ^ first : kFullMask);
      for (int p = 0; p < passes; ++p) {
        const unsigned d = digit_of(key[u], p * bits, mask);
        if (digit_of(differ, p * bits, mask) == 0) {
          if (lane == 0) atomicAdd(&counts[p * nbins + d], 32);
        } else if (valid[u]) {
          atomicAdd(&counts[p * nbins + d], 1);
        }
      }
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < passes * nbins; t += kThreads)
    if (counts[t]) atomicAdd(&hist[t], counts[t]);
}

// ---------------------------------------------------------------------------
// radix_onesweep: one block a tile of kTile keys (n < 2^31, so every index
// fits an int). The payload is vals_in, or each key's position where
// vals_in is null (a sort's first pass). digit_counts is the pass's row of
// radix_histogram; status holds one zeroed word per (tile, digit) and
// tile_counter one zeroed int.
//
// 1. The block's tile is the next number of tile_counter, not blockIdx, so
//    every earlier tile belongs to a block that is already running and the
//    look-back below always makes progress.
// 2. Warp w loads the tile's keys [w * kWarpKeys, (w + 1) * kWarpKeys) and
//    their payload at once, then ranks them in kKeysPerThread rounds of 32,
//    in input order, with its digit counts carried across rounds in its row
//    of warp_counts. Keys, payload and ranks (two a register) stay in
//    registers, 3 blocks an SM.
// 3. Thread d sums digit d over the warps (turning the row into each warp's
//    offset) and publishes the tile's count: as the inclusive prefix in
//    tile 0, as an aggregate elsewhere.
// 4. Two block scans give each digit's start inside the tile and its global
//    base (the exclusive scan of digit_counts).
// 5. Keys and payload go into shared memory in digit order.
// 6. Only then does thread d walk back over the earlier tiles, adding
//    aggregates until it meets an inclusive prefix, and publish its own
//    inclusive prefix: the local work of steps 4-5 gives the predecessors
//    time to publish theirs, which shortens the walk.
// 7. The tile goes out in digit runs: the key at tile position i with digit
//    d goes to base[d] + prefix[d] + i - start[d]. A destination at or past
//    n (only a digit_counts that is not the keys' histogram gives one) is
//    dropped, not written.
__global__ void __launch_bounds__(kThreads, 3)
radix_onesweep_kernel(const uint32_t* __restrict__ keys_in,
                      const int32_t* __restrict__ vals_in,
                      uint32_t* __restrict__ keys_out,
                      int32_t* __restrict__ vals_out, int n, int shift,
                      int bits, const int32_t* __restrict__ digit_counts,
                      unsigned long long* status,
                      int* __restrict__ tile_counter) {
  __shared__ uint32_t s_keys[kTile];
  __shared__ int32_t s_vals[kTile];
  __shared__ int warp_counts[kWarps][kMaxBins];
  __shared__ int s_start[kMaxBins];  // a digit's first position in the tile
  __shared__ int s_dest[kMaxBins];   // its global base + prefix - start
  __shared__ int s_scan[kWarps];
  __shared__ int s_tile;

  const int nbins = 1 << bits;
  const unsigned mask = nbins - 1;
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;

  if (t == 0) s_tile = atomicAdd(tile_counter, 1);
  for (int d = lane; d < nbins; d += 32) warp_counts[warp][d] = 0;
  __syncthreads();
  const int tile = s_tile;
  const int tile_start = tile * kTile;

  // 2. ranks within the warp's keys
  const int warp_start = tile_start + warp * kWarpKeys;
  uint32_t key[kKeysPerThread];
  int32_t val[kKeysPerThread];
  // ranks inside a warp's keys are below kWarpKeys: two a register
  uint32_t rank2[kKeysPerThread / 2];
#pragma unroll
  for (int j = 0; j < kKeysPerThread; ++j) {
    const int i = warp_start + j * 32 + lane;
    key[j] = i < n ? keys_in[i] : 0u;
    val[j] = i < n ? (vals_in ? vals_in[i] : i) : 0;
  }
#pragma unroll
  for (int j = 0; j < kKeysPerThread; ++j) {
    const bool valid = warp_start + j * 32 + lane < n;
    const unsigned d =
        valid ? digit_of(key[j], shift, mask) : static_cast<unsigned>(nbins);
    const uint32_t r = warp_rank(d, valid, warp_counts[warp], lane);
    rank2[j / 2] = j % 2 ? rank2[j / 2] | r << 16 : r;
  }
  __syncthreads();

  // 3. the tile's digit counts, published as soon as they are known
  int count = 0;
  unsigned long long* mine = status + (size_t)tile * nbins + t;
  if (t < nbins) {
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_counts[w][t];
      warp_counts[w][t] = count;
      count += c;
    }
    store_relaxed(mine, (tile == 0 ? kInclusive : kAggregate) |
                            static_cast<uint32_t>(count));
  }

  // 4. each digit's start in the tile and its global base
  const int start = block_exclusive_scan(count, s_scan);
  const int base = block_exclusive_scan(t < nbins ? digit_counts[t] : 0, s_scan);
  if (t < nbins) s_start[t] = start;
  __syncthreads();

  // 5. keys and payload into shared memory in digit order
#pragma unroll
  for (int j = 0; j < kKeysPerThread; ++j) {
    if (warp_start + j * 32 + lane < n) {
      const unsigned d = digit_of(key[j], shift, mask);
      const int at = s_start[d] + warp_counts[warp][d] +
                     static_cast<int>(rank2[j / 2] >> (j % 2 * 16) & 0xffffu);
      s_keys[at] = key[j];
      s_vals[at] = val[j];
    }
  }

  // 6. the decoupled look-back, kLookback tiles at a time: the window's
  //    words are read together, then added in order up to the first
  //    inclusive prefix; a word not yet published ends the window, and the
  //    next one starts there
  if (t < nbins) {
    int prefix = 0;
    if (tile > 0) {
      int spins = 0;
      for (int p = tile - 1;;) {
        unsigned long long w[kLookback];
#pragma unroll
        for (int k = 0; k < kLookback; ++k)
          w[k] = p >= k ? load_relaxed(status + (size_t)(p - k) * nbins + t)
                        : kInclusive;
        int taken = 0;
        bool open = true, found = false;
#pragma unroll
        for (int k = 0; k < kLookback; ++k) {
          if (open && w[k] >= kAggregate) {
            prefix += static_cast<int>(static_cast<uint32_t>(w[k]));
            ++taken;
            found = w[k] >= kInclusive;
            open = !found;
          } else {
            open = false;
          }
        }
        if (found) break;
        if (taken == 0 && ++spins == kSpinLimit) __trap();
        p -= taken;
      }
      store_relaxed(mine, kInclusive | static_cast<uint32_t>(prefix + count));
    }
    s_dest[t] = base + prefix - start;
  }
  __syncthreads();

  // 7. out in digit runs
  const int tile_n = min(kTile, n - tile_start);
  for (int i = t; i < tile_n; i += kThreads) {
    const uint32_t k = s_keys[i];
    const int dest = s_dest[digit_of(k, shift, mask)] + i;
    if (static_cast<unsigned>(dest) < static_cast<unsigned>(n)) {
      keys_out[dest] = k;
      vals_out[dest] = s_vals[i];
    }
  }
}

int attributes(const void* fn, int* regs, int* local_bytes, int* smem_bytes) {
  cudaFuncAttributes at;
  const cudaError_t err = cudaFuncGetAttributes(&at, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = at.numRegs;
  *local_bytes = static_cast<int>(at.localSizeBytes);
  *smem_bytes = static_cast<int>(at.sharedSizeBytes);
  return 0;
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

// hist: int32[32 / bits][2^bits], zeroed; bits divides 32; blocks > 0.
extern "C" int radix_histogram(const void* x, long long n, int bits,
                               void* hist, int blocks, void* stream) {
  if (bits < 1 || bits > 8 || 32 % bits || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  radix_histogram_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), n, bits, static_cast<int32_t*>(hist));
  REPRO_LAUNCH_RESULT();
}

// 0 < n < 2^31; vals_in may be null (the payload is then the position);
// tile: the keys of a tile the caller sized status for,
// which must be kTile; status: ceil(n / tile) * 2^bits zeroed 64-bit words;
// tile_counter: one zeroed int. The outputs must not overlap the inputs.
extern "C" int radix_onesweep(const void* keys_in, const void* vals_in,
                              void* keys_out, void* vals_out, long long n,
                              int shift, int bits, const void* digit_counts,
                              int tile, void* status, void* tile_counter,
                              void* stream) {
  if (n < 1 || n >= (1ll << 31) || bits < 1 || bits > 8 || shift < 0 ||
      shift > 32 - bits || tile != kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned tiles = static_cast<unsigned>((n + kTile - 1) / kTile);
  radix_onesweep_kernel<<<tiles, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys_in),
      static_cast<const int32_t*>(vals_in), static_cast<uint32_t*>(keys_out),
      static_cast<int32_t*>(vals_out), static_cast<int>(n), shift, bits,
      static_cast<const int32_t*>(digit_counts),
      static_cast<unsigned long long*>(status),
      static_cast<int*>(tile_counter));
  REPRO_LAUNCH_RESULT();
}

// Registers a thread, local (spill) bytes a thread and static shared memory
// a block of one kernel; launches nothing. which: 0 radix_histogram, 1
// radix_onesweep.
extern "C" int radix_info(int which, int* regs, int* local_bytes,
                          int* smem_bytes) {
  switch (which) {
    case 0:
      return attributes(reinterpret_cast<const void*>(radix_histogram_kernel),
                        regs, local_bytes, smem_bytes);
    case 1:
      return attributes(reinterpret_cast<const void*>(radix_onesweep_kernel),
                        regs, local_bytes, smem_bytes);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// C = A * B for row-major f32 or bf16 matrices, accumulated in f32 and
// cast to A's type.
//
// Replaces the JAX package's kernels/matmul.py::pallas_matmul (body
// _matmul_kernel): 128x128x128 VMEM tiles fed to the TPU's matrix unit,
// with the f32 accumulator carried in scratch across the sequential K
// grid axis. Here the sequential K axis becomes a loop inside one block
// per output tile, over a ring of shared-memory stages that is filled
// ahead of the math. No split-K: every output element is one f32 chain
// over k = 0 .. K-1.
//
// What bounds it on an H100: at the main path's 4096^3 the product does
// 2*M*N*K = 137 GFLOP against 201 MB (f32) or 101 MB (bf16) of operands,
// far above the card's ridge point, so both dtypes are bound by
// operations, each on its own pipes.
//
// f32 (matmul_f32): the contract is IEEE f32 (tests hold it to 2e-5), and
// the tensor cores take f32 only as TF32, so the ceiling is the 67 TFLOP/s
// of the SIMT FMA pipes. The design keeps those pipes fed:
//   * one 256-thread block per 128x128 tile of C (64x64 when a 128x128
//     grid would not give every one of the 132 SMs a block); each thread
//     keeps 8x8 (4x4) of C in registers as 2x2 (1x1) sub-tiles of 4x4 at
//     a stride of 64 rows and columns, so 16 lanes read 16 neighbouring
//     float4 of a B row and the two rows of A a warp reads land in
//     different banks;
//   * K walks in steps of 32 through a ring of three shared-memory stages
//     filled by cp.async: two steps' copies are in flight while the FMAs
//     run on the third, with one __syncthreads per step. One block an SM
//     (about 167 registers a thread): two blocks at 128 registers spilled
//     or ran slower on the H100, as did BK = 16 and 64, four stages, and
//     A stored transposed with double-buffered register fragments;
//   * A is kept as it lies in memory, [BM][BK + 4] (row pitch 144 bytes):
//     a thread reads float4 of 4 consecutive k for each of its rows, and
//     the two rows 4 apart that one warp instruction touches start 16
//     banks apart, so no read conflicts. B is kept as [BK][BN];
//   * operands whose base is 16-byte aligned with a row pitch that is a
//     multiple of 4 floats are copied 16 bytes a thread (cp.async.cg, a
//     short source size zero-fills the ragged edge); any other operand
//     takes the same template with 4-byte copies (cp.async.ca). The
//     wrapper picks the variant per operand from its pointer and stride.
//
// bf16 (matmul_bf16): the tensor cores' 989 TFLOP/s need wgmma, fed from
// shared memory by TMA. FA3/CUTLASS-style warp specialisation:
//   * one 384-thread block per 128x256 tile of C (128x128 when a grid of
//     128x256 tiles would not give every SM a block); warpgroup 2 is the
//     producer: it gives up registers (setmaxnreg) and one thread loads
//     A (K-major, box 64 x 128 rows) and B (MN-major, 64-column panels,
//     like B6's V) per K step of 64 by 2-D TMA with a 128-byte swizzle
//     into a four-stage ring, each stage with a full and an empty
//     mbarrier;
//   * warpgroups 0 and 1 own 64 rows each: per k16 step one wgmma
//     m64n128k16 for each 128 columns, from shared memory (B with the
//     transpose bit) into f32 registers, one wgmma group kept in flight
//     while the previous stage is released to the producer;
//   * epilogue: f32 -> bf16 round-to-nearest, stores masked at the ragged
//     edge. TMA zero-fills rows and columns past M, N and K, so any shape
//     reaches the kernel; an operand off TMA's 16-byte rules is first
//     copied by the wrapper to a 16-byte row pitch.
#include "common.cuh"
#include "hopper.cuh"

#include <cuda_bf16.h>

namespace {

using namespace hopper;

// ---------------------------------------------------------------------------
// f32: pipelined, warp-tiled SIMT
// ---------------------------------------------------------------------------
namespace simt {

constexpr int THREADS = 256;  // 16 x 16 threads, tx along N, ty along M
constexpr int BK = 32;
constexpr int STAGES = 3;
constexpr int AP = BK + 4;  // row pitch of the A tile, floats

template <int BM, int BN>
struct Tile {
  static constexpr int SUB_M = BM / 64;  // 4x4 sub-tiles a thread holds
  static constexpr int SUB_N = BN / 64;
  static constexpr int TM = 4 * SUB_M;   // rows of C a thread holds
  static constexpr int TN = 4 * SUB_N;
  static constexpr int A_FLOATS = BM * AP;
  static constexpr int STAGE_FLOATS = A_FLOATS + BK * BN;
  static constexpr int SMEM = STAGES * STAGE_FLOATS * 4;
  static_assert(BM * BK % (4 * THREADS) == 0 && BK * BN % (4 * THREADS) == 0,
                "every thread copies whole 16-byte chunks of each tile");
};

// Bytes of a 16-byte chunk at column c of a row with `len` columns.
__device__ __forceinline__ int chunk_bytes(int c, int len) {
  return min(max(len - c, 0), 4) * 4;
}

// One K step of A (rows m0.., cols k0..) and B (rows k0.., cols n0..)
// into the stage at shared address st; what lies outside the matrices is
// zero-filled.
template <int BM, int BN, bool VA, bool VB>
__device__ __forceinline__ void load_stage(uint32_t st, const float* a,
                                           const float* b, int m, int n,
                                           int k, long long lda,
                                           long long ldb, int m0, int n0,
                                           int k0) {
  using T = Tile<BM, BN>;
  const int tid = threadIdx.x;
  const uint32_t bs = st + T::A_FLOATS * 4;
  if constexpr (VA) {
#pragma unroll
    for (int i = 0; i < BM * BK / 4 / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / (BK / 4);
      const int c = (e % (BK / 4)) * 4;
      const int bytes = (m0 + r < m) ? chunk_bytes(k0 + c, k) : 0;
      const float* src = bytes ? a + (m0 + r) * lda + k0 + c : a;
      cp_async16(st + (r * AP + c) * 4, src, bytes);
    }
  } else {
#pragma unroll
    for (int i = 0; i < BM * BK / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / BK;
      const int c = e % BK;
      const bool in = m0 + r < m && k0 + c < k;
      cp_async4(st + (r * AP + c) * 4, in ? a + (m0 + r) * lda + k0 + c : a,
                in ? 4 : 0);
    }
  }
  if constexpr (VB) {
#pragma unroll
    for (int i = 0; i < BK * BN / 4 / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / (BN / 4);
      const int c = (e % (BN / 4)) * 4;
      const int bytes = (k0 + r < k) ? chunk_bytes(n0 + c, n) : 0;
      const float* src = bytes ? b + (k0 + r) * ldb + n0 + c : b;
      cp_async16(bs + (r * BN + c) * 4, src, bytes);
    }
  } else {
#pragma unroll
    for (int i = 0; i < BK * BN / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / BN;
      const int c = e % BN;
      const bool in = k0 + r < k && n0 + c < n;
      cp_async4(bs + (r * BN + c) * 4, in ? b + (k0 + r) * ldb + n0 + c : b,
                in ? 4 : 0);
    }
  }
}

template <int BM, int BN, bool VA, bool VB>
__global__ void __launch_bounds__(THREADS, 1)
    sgemm_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 float* __restrict__ c, int m, int n, int k, long long lda,
                 long long ldb) {
  using T = Tile<BM, BN>;
  extern __shared__ float4 smem_f4[];
  const float* smem = reinterpret_cast<const float*>(smem_f4);
  const uint32_t smem_s = smem_addr(smem_f4);

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int kt = (k + BK - 1) / BK;

  float acc[T::TM][T::TN];
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int j = 0; j < T::TN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < kt)
      load_stage<BM, BN, VA, VB>(smem_s + s * T::STAGE_FLOATS * 4, a, b, m, n,
                                 k, lda, ldb, m0, n0, s * BK);
    cp_async_commit();
  }

  for (int t = 0; t < kt; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step t has landed; step t - 1's stage is free
    const int tn = t + STAGES - 1;
    if (tn < kt)
      load_stage<BM, BN, VA, VB>(
          smem_s + (tn % STAGES) * T::STAGE_FLOATS * 4, a, b, m, n, k, lda,
          ldb, m0, n0, tn * BK);
    cp_async_commit();

    const float* as = smem + (t % STAGES) * T::STAGE_FLOATS;
    const float* bs = as + T::A_FLOATS;
#pragma unroll
    for (int kq = 0; kq < BK / 4; ++kq) {
      float4 av[T::TM];  // k = 4 kq .. 4 kq + 3 of this thread's rows
#pragma unroll
      for (int s = 0; s < T::SUB_M; ++s)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          av[4 * s + i] = *reinterpret_cast<const float4*>(
              as + (s * 64 + ty * 4 + i) * AP + kq * 4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float bv[T::TN];
#pragma unroll
        for (int s = 0; s < T::SUB_N; ++s) {
          const float4 v = *reinterpret_cast<const float4*>(
              bs + (kq * 4 + kk) * BN + s * 64 + tx * 4);
          bv[4 * s] = v.x;
          bv[4 * s + 1] = v.y;
          bv[4 * s + 2] = v.z;
          bv[4 * s + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < T::TM; ++i) {
          const float x = part(av[i], kk);
#pragma unroll
          for (int j = 0; j < T::TN; ++j) acc[i][j] = fmaf(x, bv[j], acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // C is the wrapper's fresh [m, n] tensor: float4 stores when n % 4 == 0
  const bool vec_c = (n % 4) == 0;
#pragma unroll
  for (int s = 0; s < T::SUB_M; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = m0 + s * 64 + ty * 4 + i;
      if (r >= m) continue;
      float* crow = c + static_cast<long long>(r) * n;
#pragma unroll
      for (int s2 = 0; s2 < T::SUB_N; ++s2) {
        const int col = n0 + s2 * 64 + tx * 4;
        const float* v = &acc[4 * s + i][4 * s2];
        if (vec_c) {
          if (col < n)
            *reinterpret_cast<float4*>(crow + col) =
                make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (col + j < n) crow[col + j] = v[j];
        }
      }
    }
}

template <int BM, int BN, bool VA, bool VB>
int launch_v(const float* a, const float* b, float* c, int m, int n, int k,
             long long lda, long long ldb, cudaStream_t stream) {
  static SmemOptIn opt_in;
  const cudaError_t err = opt_in(
      reinterpret_cast<const void*>(sgemm_kernel<BM, BN, VA, VB>),
      Tile<BM, BN>::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  sgemm_kernel<BM, BN, VA, VB>
      <<<grid, THREADS, Tile<BM, BN>::SMEM, stream>>>(a, b, c, m, n, k, lda,
                                                      ldb);
  REPRO_LAUNCH_RESULT();
}

template <int BM, int BN>
int launch_t(const float* a, const float* b, float* c, int m, int n, int k,
             long long lda, long long ldb, bool va, bool vb,
             cudaStream_t stream) {
  if (va && vb) return launch_v<BM, BN, true, true>(a, b, c, m, n, k, lda, ldb, stream);
  if (va) return launch_v<BM, BN, true, false>(a, b, c, m, n, k, lda, ldb, stream);
  if (vb) return launch_v<BM, BN, false, true>(a, b, c, m, n, k, lda, ldb, stream);
  return launch_v<BM, BN, false, false>(a, b, c, m, n, k, lda, ldb, stream);
}

template <int BM, int BN, bool VA, bool VB>
int info_v(int* regs, int* local_bytes, int* smem_bytes) {
  cudaFuncAttributes at;
  const cudaError_t err =
      cudaFuncGetAttributes(&at, sgemm_kernel<BM, BN, VA, VB>);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = at.numRegs;
  *local_bytes = static_cast<int>(at.localSizeBytes);
  *smem_bytes = Tile<BM, BN>::SMEM;
  return 0;
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma, warp-specialised
// ---------------------------------------------------------------------------
namespace tc {

constexpr int BM = 128;  // two consumer warpgroups of 64 rows
constexpr int BK = 64;   // one 128-byte swizzle row of bf16
constexpr int STAGES = 4;
constexpr int THREADS = 384;
constexpr int PRODUCER_WG = 2;
constexpr int PRODUCER_REGS = 40;  // 128 x 40 + 256 x 232 <= 65536
constexpr int CONSUMER_REGS = 232;
constexpr int SW = 128;               // bytes of a swizzled row
constexpr int A_BYTES = BM * BK * 2;  // [BM rows][64 k], K-major
constexpr int B_PANEL = BK * SW;      // [64 k][64 n], MN-major
static_assert(A_BYTES % 1024 == 0 && B_PANEL % 1024 == 0,
              "swizzled tiles must stay 1024-byte aligned");

// A tile of BN columns of C: NH wgmma m64n128k16 side by side.
template <int BN>
struct Cfg {
  static constexpr int NH = BN / 128;
  static constexpr int B_BYTES = (BN / 64) * B_PANEL;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int BAR_OFF = STAGES * STAGE_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * 2 * STAGES + 1024;  // + align
};

struct Params {
  CUtensorMap amap;  // A [m, k]: dims (k, m), box (64, BM)
  CUtensorMap bmap;  // B [k, n]: dims (n, k), box (64, BK)
  __nv_bfloat16* c;  // [m, n], contiguous
  int m, n, k;
};

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
    hgemm_kernel(const __grid_constant__ Params p) {
  using C = Cfg<BN>;
  constexpr int NH = C::NH;
  constexpr int STAGE_BYTES = C::STAGE_BYTES;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle needs 1024-byte aligned tiles
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = base + C::BAR_OFF;
  const uint32_t empty = full + 8 * STAGES;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int kt = (p.k + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * 128);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == PRODUCER_WG) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == PRODUCER_WG * 128) {
      for (int t = 0; t < kt; ++t) {
        const int s = t % STAGES;
        const uint32_t as = base + s * STAGE_BYTES;
        mbar_wait(empty + 8 * s, ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, STAGE_BYTES);
        tma_load(as, &p.amap, full + 8 * s, t * BK, m0);
#pragma unroll
        for (int pn = 0; pn < BN / 64; ++pn)
          tma_load(as + A_BYTES + pn * B_PANEL, &p.bmap, full + 8 * s,
                   n0 + pn * 64, t * BK);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    float acc[NH][64];
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;

    for (int t = 0; t < kt; ++t) {
      const int s = t % STAGES;
      const uint32_t as = base + s * STAGE_BYTES;
      const uint32_t bs = as + A_BYTES;
      mbar_wait(full + 8 * s, (t / STAGES) & 1);
#pragma unroll
      for (int h = 0; h < NH; ++h) pin(acc[h]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int h = 0; h < NH; ++h)
          wgmma_ss<1>(acc[h],
                      make_desc(as + wg * 64 * SW + kk * 32, 16, 8 * SW, 1),
                      make_desc(bs + 2 * h * B_PANEL + kk * 16 * SW, B_PANEL,
                                8 * SW, 1),
                      1);
      wgmma_commit();
      wgmma_wait<1>();  // step t - 1's products are done with its stage
#pragma unroll
      for (int h = 0; h < NH; ++h) pin(acc[h]);
      if (t > 0) mbar_arrive(empty + 8 * ((t - 1) % STAGES));
    }
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < NH; ++h) pin(acc[h]);

    // accumulator element (c, i, j) of this thread: row row0 + 8 i of the
    // tile, column 8 c + col0 + j, register 4 c + 2 i + j
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int row0 = m0 + wg * 64 + (tid / 32) * 16 + lane / 4;
    const int col00 = n0 + 2 * (lane % 4);
    const bool pairs = (p.n % 2) == 0;  // bf16x2 stores stay 4-byte aligned
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row >= p.m) continue;
      __nv_bfloat16* crow = p.c + static_cast<long long>(row) * p.n;
#pragma unroll
      for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int cc = 0; cc < 16; ++cc) {
        const int col = col00 + 128 * h + 8 * cc;
        const float v0 = acc[h][4 * cc + 2 * i];
        const float v1 = acc[h][4 * cc + 2 * i + 1];
        if (pairs) {
          if (col < p.n)
            *reinterpret_cast<__nv_bfloat162*>(crow + col) =
                __floats2bfloat162_rn(v0, v1);
        } else {
          if (col < p.n) crow[col] = __float2bfloat16(v0);
          if (col + 1 < p.n) crow[col + 1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

// A rank-2 map over a row-major bf16 matrix [rows, cols] with row pitch
// ld elements; boxes of 64 columns (one 128-byte swizzle row) by box_rows.
// The pitch of a single row is never used, and is replaced by a valid
// one. The Python wrapper has already checked TMA's rules (16-byte base
// and pitch); the encoder checks them again.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int cols,
            int rows, long long ld, int box_rows) {
  long long pitch = ld * 2;
  if (rows == 1) pitch = (cols * 2LL + 15) / 16 * 16;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(pitch)};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN>
int launch_n(const void* a, const void* b, void* c, int m, int n, int k,
             long long lda, long long ldb, cudaStream_t stream) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  Params p;
  if (k > 0) {
    if (!encode(fn, &p.amap, a, k, m, lda, BM) ||
        !encode(fn, &p.bmap, b, n, k, ldb, BK))
      return static_cast<int>(cudaErrorInvalidValue);
  } else {  // no K step is loaded; any valid map will do
    if (!encode(fn, &p.amap, c, 1, 1, 8, BM))
      return static_cast<int>(cudaErrorInvalidValue);
    p.bmap = p.amap;
  }
  p.c = static_cast<__nv_bfloat16*>(c);
  p.m = m;
  p.n = n;
  p.k = k;
  static SmemOptIn opt_in;
  const cudaError_t err = opt_in(
      reinterpret_cast<const void*>(hgemm_kernel<BN>), Cfg<BN>::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  hgemm_kernel<BN><<<grid, THREADS, Cfg<BN>::SMEM, stream>>>(p);
  REPRO_LAUNCH_RESULT();
}

template <int BN>
int info(int* regs, int* local_bytes, int* smem_bytes) {
  cudaFuncAttributes at;
  const cudaError_t err = cudaFuncGetAttributes(&at, hgemm_kernel<BN>);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = at.numRegs;
  *local_bytes = static_cast<int>(at.localSizeBytes);
  *smem_bytes = Cfg<BN>::SMEM;
  return 0;
}

}  // namespace tc

}  // namespace

// f32: tile is 128 (128x128 blocks) or 64 (64x64); vec_a / vec_b pick
// 16-byte copies for an operand whose base is 16-byte aligned and whose
// row pitch is a multiple of 4 floats (the launcher refuses any other).
extern "C" int matmul_f32(const void* a, const void* b, void* c, int m, int n,
                          int k, long long lda, long long ldb, int vec_a,
                          int vec_b, int tile, void* stream) {
  const auto aligned = [](const void* p, long long ld) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && ld % 4 == 0;
  };
  if ((vec_a && !aligned(a, lda)) || (vec_b && !aligned(b, ldb)))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* fa = static_cast<const float*>(a);
  const float* fb = static_cast<const float*>(b);
  float* fc = static_cast<float*>(c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 128:
      return simt::launch_t<128, 128>(fa, fb, fc, m, n, k, lda, ldb, vec_a,
                                      vec_b, s);
    case 64:
      return simt::launch_t<64, 64>(fa, fb, fc, m, n, k, lda, ldb, vec_a,
                                    vec_b, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// bf16: A [m, k] and B [k, n] row-major with row pitches lda, ldb whose
// bytes, like the base addresses, are multiples of 16 (TMA's rules);
// tile is the width of a block's tile of C, 256 or 128 (128 rows).
extern "C" int matmul_bf16(const void* a, const void* b, void* c, int m, int n,
                           int k, long long lda, long long ldb, int tile,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 256: return tc::launch_n<256>(a, b, c, m, n, k, lda, ldb, s);
    case 128: return tc::launch_n<128>(a, b, c, m, n, k, lda, ldb, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Registers a thread, local (spill) bytes a thread and dynamic shared
// memory a block of one instantiation; launches nothing. which: 0-7 the
// f32 kernels (bit 2: 64x64 tile, bit 1: 16-byte copies of A, bit 0: of
// B), 8 and 9 the bf16 kernels with 128x256 and 128x128 tiles.
extern "C" int matmul_info(int which, int* regs, int* local_bytes,
                           int* smem_bytes) {
  using namespace simt;
  switch (which) {
    case 0: return info_v<128, 128, false, false>(regs, local_bytes, smem_bytes);
    case 1: return info_v<128, 128, false, true>(regs, local_bytes, smem_bytes);
    case 2: return info_v<128, 128, true, false>(regs, local_bytes, smem_bytes);
    case 3: return info_v<128, 128, true, true>(regs, local_bytes, smem_bytes);
    case 4: return info_v<64, 64, false, false>(regs, local_bytes, smem_bytes);
    case 5: return info_v<64, 64, false, true>(regs, local_bytes, smem_bytes);
    case 6: return info_v<64, 64, true, false>(regs, local_bytes, smem_bytes);
    case 7: return info_v<64, 64, true, true>(regs, local_bytes, smem_bytes);
    case 8: return tc::info<256>(regs, local_bytes, smem_bytes);
    case 9: return tc::info<128>(regs, local_bytes, smem_bytes);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

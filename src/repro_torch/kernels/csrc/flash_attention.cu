// Attention forward with an online softmax (flash attention): bf16 on the
// Hopper tensor cores, f32 on the SIMT pipes.
//
// Replaces the JAX package's kernels/flash_attention.py::
// pallas_flash_attention (body _fa_kernel): grid (B, H, Sq/bq, Skv/bk)
// with the key axis innermost, so the running max m, sum l and the
// output accumulator live in VMEM scratch carried across sequential grid
// steps; GQA by indexing the K/V head h // group; causal and local-window
// masks on right-aligned query positions (pos_offset = Skv - Sq); key
// blocks wholly outside the mask skipped.
//
// What bounds it on an H100: 4*Sq*Skv*D operations per (batch, head)
// (halved when causal) against about 4*S*D*bytes moved, so at prefill
// lengths it is bound by operations, which only the tensor cores (wgmma)
// run at the card's rate. Both kernels below share the TPU kernel's plan:
// the sequential key axis becomes a loop inside one block per (batch,
// head, query tile), between the first and last key tile the masks reach.
// Fully masked rows: m stays -inf, exp is taken against 0, so P and l
// stay 0 and the row's output is 0 (the TPU kernel's l == 0 rule; the JAX
// oracle would give NaN). Ragged Sq and Skv are masked in the kernels, so
// every shape reaches them, and q, k, v are read through their strides
// (last axis contiguous): the model's [B, S, H, D] projections need no
// copy.
//
// bf16 (flash_attention_bf16), FA3-style, for sm_90a:
//   * one 384-thread block per (head, batch, 128-query tile); the tiles
//     are launched last-first, so under the causal mask the longest run
//     first and do not form a tail;
//   * warpgroup 2 is the producer: one thread loads the Q tile once and
//     then K and V tiles of 128 keys by TMA (rank-4 tensor maps over the
//     tensors' own strides, 128-byte swizzle, 32-byte where a row of D is
//     narrower; rows past Skv or Sq come back as zeros) into a two-stage
//     ring, each stage with an mbarrier for K, one for V and one that the
//     consumers release it on, so copies run under the consumers' math;
//   * warpgroups 0 and 1 consume 64 query rows each, with the registers
//     the producer gave up (setmaxnreg): S = Q K^T by wgmma from shared
//     memory into f32 registers; the online softmax in registers (row max
//     over a quad of lanes by shuffles, exp2 with log2(e) folded into the
//     scale, masks only on tiles that cross the diagonal, the window edge
//     or Skv, l summed from the f32 P); O += P V by wgmma with P from
//     registers and V from shared memory (transposed operand);
//   * precision: the TPU kernel and the plain version keep P in f32, so P
//     goes into P V as two bf16 halves, hi = bf16(P) and lo = bf16(P -
//     hi), both into the one f32 accumulator: about 16 bits of P, at one
//     more wgmma per k16 step. P rounded once to bf16 (FA3's choice) was
//     about 1.4x faster on an H100 but read four times the error at the
//     qwen3-1.7b layer shape, so it is not built.
//
// f32 (flash_attention_f32): IEEE f32 on the SIMT pipes (tests hold it to
// 2e-4; wgmma has no IEEE f32 mode). One 256-thread block per (batch,
// head, 64-query tile) over 64-key tiles. Per tile:
//   1. K^T is staged in shared memory (f32), Q^T stays there all along;
//   2. each thread computes a 4x4 tile of S = Q K^T * scale and masks it
//      (-inf), writing it transposed to shared memory;
//   3. four threads per query row reduce the row's max and sum with warp
//      shuffles and turn S into P = exp(S - m_new); while they do, V
//      replaces K in the same buffer;
//   4. each thread rescales its 4 x D/16 slice of the accumulator by
//      alpha = exp(m_prev - m_new) and adds P V.
#include "common.cuh"
#include "hopper.cuh"

#include <cuda_bf16.h>

#include <cmath>

namespace {

using namespace hopper;

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int QPAD = BQ + 4;  // keeps float4 alignment, spreads banks
constexpr int KPAD = BK + 4;

template <int D>
struct Smem {
  static constexpr int CD = D / 16;                 // output cols a thread owns
  static constexpr int VPAD = D + 4;
  static constexpr int Q = D * QPAD;                // Q^T [D][QPAD]
  static constexpr int KV = (D * KPAD > BK * VPAD) ? D * KPAD : BK * VPAD;
  static constexpr int P = BK * QPAD;               // P^T [BK][QPAD]
  static constexpr int FLOATS = Q + KV + P + 3 * BQ;
  static constexpr int BYTES = FLOATS * 4;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  long long qs[3];  // strides of q over (batch, head, seq), in elements
  long long ks[3];
  long long vs[3];
  int h, group, sq, skv;
  int causal, window;  // window <= 0: none
  float scale;
};

template <int D>
__global__ void __launch_bounds__(THREADS) flash_attention_kernel(Params p) {
  using S = Smem<D>;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                // [D][QPAD]
  float* kv = qs + S::Q;           // K^T [D][KPAD], then V [BK][VPAD]
  float* ps = kv + S::KV;          // [BK][QPAD]
  float* m_s = ps + S::P;
  float* l_s = m_s + BQ;
  float* a_s = l_s + BQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * BQ;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int hk = hh / p.group;
  const int pos_offset = p.skv - p.sq;

  const float* qg =
      static_cast<const float*>(p.q) + bb * p.qs[0] + hh * p.qs[1];
  const float* kg =
      static_cast<const float*>(p.k) + bb * p.ks[0] + hk * p.ks[1];
  const float* vg =
      static_cast<const float*>(p.v) + bb * p.vs[0] + hk * p.vs[1];

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D;
    const int d = e % D;
    qs[d * QPAD + r] =
        (q0 + r < p.sq) ? qg[(q0 + r) * p.qs[2] + d] : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  float acc[4][S::CD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < S::CD; ++c) acc[i][c] = 0.f;

  // key tiles the masks can reach from this query tile
  const int q_first = q0 + pos_offset;
  const int q_last = min(q0 + BQ, p.sq) - 1 + pos_offset;
  int k_end = p.skv;
  if (p.causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, q_first - p.window + 1);
  k_begin = (k_begin / BK) * BK;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    // 1. K^T tile
    for (int e = tid; e < BK * D; e += THREADS) {
      const int j = e / D;
      const int d = e % D;
      kv[d * KPAD + j] =
          (k0 + j < p.skv) ? kg[(k0 + j) * p.ks[2] + d] : 0.f;
    }
    __syncthreads();

    // 2. S = Q K^T * scale, masked, stored transposed
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&qs[d * QPAD + ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&kv[d * KPAD + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kpos = k0 + tx * 4 + j;
      float col[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qpos = q0 + ty * 4 + i + pos_offset;
        bool keep = kpos < p.skv;
        if (p.causal) keep = keep && kpos <= qpos;
        if (p.window > 0) keep = keep && kpos > qpos - p.window;
        col[i] = keep ? s[i][j] * p.scale : -INFINITY;
      }
      *reinterpret_cast<float4*>(&ps[(tx * 4 + j) * QPAD + ty * 4]) =
          make_float4(col[0], col[1], col[2], col[3]);
    }
    __syncthreads();

    // 3a. V tile into the K buffer (K is no longer read)
    for (int e = tid; e < BK * D; e += THREADS) {
      const int j = e / D;
      const int d = e % D;
      kv[j * S::VPAD + d] =
          (k0 + j < p.skv) ? vg[(k0 + j) * p.vs[2] + d] : 0.f;
    }
    // 3b. online softmax: four neighbouring lanes per row
    {
      const int r = tid / 4;
      const int part = tid % 4;
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < BK / 4; ++jj)
        mx = fmaxf(mx, ps[(jj * 4 + part) * QPAD + r]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float m_use = (m_new == -INFINITY) ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < BK / 4; ++jj) {
        float* at = &ps[(jj * 4 + part) * QPAD + r];
        const float e = expf(*at - m_use);
        *at = e;
        sum += e;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_prev - m_use);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // 4. acc = acc * alpha + P V
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) alpha[i] = a_s[ty * 4 + i];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < S::CD; ++c) acc[i][c] *= alpha[i];
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float4 pv = *reinterpret_cast<const float4*>(&ps[j * QPAD + ty * 4]);
      const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
      float vv[S::CD];
      const float* vrow = &kv[j * S::VPAD + tx * S::CD];
      if constexpr (S::CD % 4 == 0) {
#pragma unroll
        for (int c = 0; c < S::CD; c += 4) {
          const float4 t = *reinterpret_cast<const float4*>(vrow + c);
          vv[c] = t.x;
          vv[c + 1] = t.y;
          vv[c + 2] = t.z;
          vv[c + 3] = t.w;
        }
      } else {
#pragma unroll
        for (int c = 0; c < S::CD; ++c) vv[c] = vrow[c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < S::CD; ++c) acc[i][c] = fmaf(pr[i], vv[c], acc[i][c]);
    }
    __syncthreads();
  }

  float* og = static_cast<float*>(p.out) +
              (static_cast<long long>(bb) * p.h + hh) *
                  static_cast<long long>(p.sq) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r >= p.sq) continue;
    const float l = l_s[r];
    const float inv = (l == 0.f) ? 0.f : 1.f;
    const float denom = (l == 0.f) ? 1.f : l;
#pragma unroll
    for (int c = 0; c < S::CD; ++c)
      og[static_cast<long long>(q0 + r) * D + tx * S::CD + c] =
          inv * (acc[i][c] / denom);
  }
}

template <int D>
int launch_d(const Params& p, int batch, cudaStream_t stream) {
  static SmemOptIn opt_in;
  const cudaError_t err = opt_in(
      reinterpret_cast<const void*>(flash_attention_kernel<D>), Smem<D>::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.sq + BQ - 1) / BQ, p.h, batch);
  flash_attention_kernel<D><<<grid, THREADS, Smem<D>::BYTES, stream>>>(p);
  REPRO_LAUNCH_RESULT();
}

int launch(const void* q, const void* k, const void* v, void* out,
           const long long* qs, const long long* ks, const long long* vs,
           int batch, int h, int hkv, int sq, int skv, int d, int causal,
           int window, float scale, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = qs[i];
    p.ks[i] = ks[i];
    p.vs[i] = vs[i];
  }
  p.h = h;
  p.group = h / hkv;
  p.sq = sq;
  p.skv = skv;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch_d<16>(p, batch, s);  // the CPU-test config
    case 64: return launch_d<64>(p, batch, s);
    case 128: return launch_d<128>(p, batch, s);  // qwen3-1.7b
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------
namespace tc {

constexpr int BQ = 128;      // query rows per block: two consumer warpgroups
constexpr int BK = 128;      // keys per tile
constexpr int STAGES = 2;    // K/V ring depth
constexpr int THREADS = 384;
constexpr int PRODUCER_WG = 2;
constexpr int PRODUCER_REGS = 40;   // 128 x 40 + 256 x 232 <= 65536
constexpr int CONSUMER_REGS = 232;

template <int D>
struct Cfg {
  // A row of a shared-memory panel is one swizzle span: 128 bytes (64
  // bf16), or the whole row of D where that is narrower (D = 16: 32 B).
  static constexpr int SW = D * 2 >= 128 ? 128 : D * 2;
  static constexpr int PW = SW / 2;             // panel width, elements
  static constexpr int PANELS = D / PW;
  static constexpr int KSTEPS = PW / 16;        // k16 steps in a panel
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : (SW == 64 ? 2 : 3);
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;   // one K or one V tile
  static constexpr int K_OFF = Q_BYTES;         // + stage * KV_BYTES
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // barriers: Q, then full K, full V and empty for each stage
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 3 * STAGES) + 1024;
  static_assert(Q_BYTES % 1024 == 0 && KV_BYTES % 1024 == 0,
                "swizzled tiles must stay 1024-byte aligned");
};

struct Params {
  CUtensorMap qmap, kmap, vmap;  // [B, H, S, D] as rank 4, D innermost
  void* out;                     // [B, H, Sq, D], contiguous
  int h, group, sq, skv;
  int causal, window;            // window <= 0: none
  float scale_log2;              // scale * log2(e)
};

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[64xN] += A[64x16] B[16xN]: A from registers, B from shared memory
// (MN-major: the transpose bit is set)
__device__ __forceinline__ void wgmma_rs(float (&d)[8], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// D[64xN] += A[64x16] B[16xN]: A from registers, B from shared memory
// (MN-major: the transpose bit is set)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// D[64xN] += A[64x16] B[16xN]: A from registers, B from shared memory
// (MN-major: the transpose bit is set)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}


template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_attention_tc_kernel(const __grid_constant__ Params p) {
  using C = Cfg<D>;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle needs 1024-byte aligned tiles
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = base + C::K_OFF;
  const uint32_t v_s = base + C::V_OFF;
  const uint32_t q_bar = base + C::BAR_OFF;
  const uint32_t full_k = q_bar + 8;
  const uint32_t full_v = full_k + 8 * STAGES;
  const uint32_t empty = full_v + 8 * STAGES;

  const int hh = blockIdx.x;
  const int bb = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // longest tiles first
  const int hk = hh / p.group;
  const int pos_offset = p.skv - p.sq;

  // key tiles the masks can reach from this query tile
  const int q_first = q0 + pos_offset;
  const int q_last = min(q0 + BQ, p.sq) - 1 + pos_offset;
  int k_end = p.skv;
  if (p.causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, q_first - p.window + 1);
  k_begin = (k_begin / BK) * BK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * 128);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == PRODUCER_WG) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == PRODUCER_WG * 128 && n_tiles > 0) {
      mbar_expect_tx(q_bar, C::Q_BYTES);
#pragma unroll
      for (int pn = 0; pn < C::PANELS; ++pn)
        tma_load(q_s + pn * BQ * C::SW, &p.qmap, q_bar, pn * C::PW, q0, hh,
                 bb);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        const int k0 = k_begin + t * BK;
        mbar_wait(empty + 8 * s, ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(full_k + 8 * s, C::KV_BYTES);
#pragma unroll
        for (int pn = 0; pn < C::PANELS; ++pn)
          tma_load(k_s + s * C::KV_BYTES + pn * BK * C::SW, &p.kmap,
                   full_k + 8 * s, pn * C::PW, k0, hk, bb);
        mbar_expect_tx(full_v + 8 * s, C::KV_BYTES);
#pragma unroll
        for (int pn = 0; pn < C::PANELS; ++pn)
          tma_load(v_s + s * C::KV_BYTES + pn * BK * C::SW, &p.vmap,
                   full_v + 8 * s, pn * C::PW, k0, hk, bb);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    // accumulator element (c, i, j) of this thread: row row0 + 8 i of the
    // tile, column 8 c + col0 + j, register 4 c + 2 i + j
    const int row0 = wg * 64 + (tid / 32) * 16 + lane / 4;
    const int col0 = 2 * (lane % 4);
    const int wg_qmin = q0 + wg * 64 + pos_offset;  // this warpgroup's rows
    const int wg_qmax = wg_qmin + 63;

    float o[D / 2];
    float s[BK / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};  // this thread's columns only, until the end

    if (n_tiles > 0) mbar_wait(q_bar, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % STAGES;
      const uint32_t parity = (t / STAGES) & 1;
      const int k0 = k_begin + t * BK;

      // S = Q K^T, both K-major in shared memory
      mbar_wait(full_k + 8 * st, parity);
      const uint32_t kt = k_s + st * C::KV_BYTES;
      pin(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % C::KSTEPS) * 32;
        const int pn = kk / C::KSTEPS;
        wgmma_ss<0>(s,
                 make_desc(q_s + pn * BQ * C::SW + wg * 64 * C::SW + off, 16,
                           8 * C::SW, C::LAYOUT),
                 make_desc(kt + pn * BK * C::SW + off, 16, 8 * C::SW,
                           C::LAYOUT),
                 kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(s);

#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] *= p.scale_log2;
      // masks, only where the tile crosses Skv, the diagonal or the window
      const bool edge = k0 + BK > p.skv ||
                        (p.causal && k0 + BK - 1 > wg_qmin) ||
                        (p.window > 0 && k0 <= wg_qmax - p.window);
      if (edge) {
#pragma unroll
        for (int c = 0; c < BK / 8; ++c)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int kpos = k0 + 8 * c + col0 + j;
              const int qpos = q0 + row0 + 8 * i + pos_offset;
              bool keep = kpos < p.skv;
              if (p.causal) keep = keep && kpos <= qpos;
              if (p.window > 0) keep = keep && kpos > qpos - p.window;
              if (!keep) s[4 * c + 2 * i + j] = -INFINITY;
            }
      }

      // online softmax in base 2: rows are shared by the 4 lanes of a quad
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int c = 0; c < BK / 8; ++c)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            mx[i] = fmaxf(mx[i], s[4 * c + 2 * i + j]);
      float m_use[2], alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        m_use[i] = (m_new == -INFINITY) ? 0.f : m_new;
        alpha[i] = exp2f(m[i] - m_use[i]);
        m[i] = m_new;
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          o[4 * c + 2 * i] *= alpha[i];
          o[4 * c + 2 * i + 1] *= alpha[i];
        }
      // P in the A-operand layout of wgmma: register 2 c + i holds the
      // pair (c, i, 0..1), so k16 step kk reads registers 4 kk .. 4 kk + 3
      uint32_t p_hi[BK / 4];
      uint32_t p_lo[BK / 4];
#pragma unroll
      for (int c = 0; c < BK / 8; ++c)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float e0 = exp2f(s[4 * c + 2 * i] - m_use[i]);
          const float e1 = exp2f(s[4 * c + 2 * i + 1] - m_use[i]);
          l[i] += e0 + e1;
          const __nv_bfloat16 h0 = __float2bfloat16_rn(e0);
          const __nv_bfloat16 h1 = __float2bfloat16_rn(e1);
          p_hi[2 * c + i] = pack(h0, h1);
          p_lo[2 * c + i] = pack(__float2bfloat16_rn(e0 - __bfloat162float(h0)),
                                 __float2bfloat16_rn(e1 - __bfloat162float(h1)));
        }

      // O += P_hi V + P_lo V, V MN-major in shared memory
      mbar_wait(full_v + 8 * st, parity);
      const uint32_t vt = v_s + st * C::KV_BYTES;
      pin(o);
      pin(p_hi);
      pin(p_lo);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs(o, p_hi[4 * kk], p_hi[4 * kk + 1], p_hi[4 * kk + 2],
                 p_hi[4 * kk + 3],
                 make_desc(vt + kk * 16 * C::SW, BK * C::SW, 8 * C::SW,
                           C::LAYOUT));
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs(o, p_lo[4 * kk], p_lo[4 * kk + 1], p_lo[4 * kk + 2],
                 p_lo[4 * kk + 3],
                 make_desc(vt + kk * 16 * C::SW, BK * C::SW, 8 * C::SW,
                           C::LAYOUT));
      wgmma_commit();
      wgmma_wait_all();
      pin(o);
      pin(p_hi);
      pin(p_lo);
      mbar_arrive(empty + 8 * st);
    }

    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.out) +
                        (static_cast<long long>(bb) * p.h + hh) *
                            static_cast<long long>(p.sq) * D;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      const int row = q0 + row0 + 8 * i;
      if (row >= p.sq) continue;
      const float inv = (l[i] == 0.f) ? 0.f : 1.f / l[i];
      __nv_bfloat16* orow = og + static_cast<long long>(row) * D + col0;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c) =
            __floats2bfloat162_rn(o[4 * c + 2 * i] * inv,
                                  o[4 * c + 2 * i + 1] * inv);
    }
  }
}

// A rank-4 map over a [batch, heads, rows, d] bf16 tensor with element
// strides st = (batch, head, row); boxes of (panel width, box_rows).
// The stride of an axis of length 1 is never used, and is replaced by a
// valid one. The Python wrapper has already checked TMA's rules (16-byte
// base and strides, last axis contiguous); the encoder checks them again.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int d,
            int rows, int heads, int batch, const long long* st, int box_rows,
            int sw) {
  long long row_b = st[2] * 2, head_b = st[1] * 2, batch_b = st[0] * 2;
  if (rows == 1) row_b = d * 2LL;
  if (heads == 1) head_b = row_b * rows;
  if (batch == 1) batch_b = head_b * heads;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(row_b),
                                 static_cast<cuuint64_t>(head_b),
                                 static_cast<cuuint64_t>(batch_b)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(sw / 2),
                             static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      sw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                : (sw == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                            : CU_TENSOR_MAP_SWIZZLE_32B);
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, void* out,
             const long long* qs, const long long* ks, const long long* vs,
             int batch, int h, int hkv, int sq, int skv, int causal,
             int window, float scale, cudaStream_t stream) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  Params p;
  if (!encode(fn, &p.qmap, q, D, sq, h, batch, qs, BQ, Cfg<D>::SW))
    return static_cast<int>(cudaErrorInvalidValue);
  if (skv > 0) {
    if (!encode(fn, &p.kmap, k, D, skv, hkv, batch, ks, BK, Cfg<D>::SW) ||
        !encode(fn, &p.vmap, v, D, skv, hkv, batch, vs, BK, Cfg<D>::SW))
      return static_cast<int>(cudaErrorInvalidValue);
  } else {  // no key tile is loaded; any valid map will do
    p.kmap = p.qmap;
    p.vmap = p.qmap;
  }
  p.out = out;
  p.h = h;
  p.group = h / hkv;
  p.sq = sq;
  p.skv = skv;
  p.causal = causal;
  p.window = window;
  p.scale_log2 = scale * 1.4426950408889634f;
  static SmemOptIn opt_in;
  const cudaError_t err =
      opt_in(reinterpret_cast<const void*>(flash_attention_tc_kernel<D>),
             Cfg<D>::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(h, batch, (sq + BQ - 1) / BQ);
  flash_attention_tc_kernel<D><<<grid, THREADS, Cfg<D>::SMEM, stream>>>(p);
  REPRO_LAUNCH_RESULT();
}

template <int D>
int info_d(int* regs, int* local_bytes, int* smem_bytes) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, flash_attention_tc_kernel<D>);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  *smem_bytes = Cfg<D>::SMEM;
  return 0;
}

}  // namespace tc

}  // namespace

extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* out,
                                   const long long* qs, const long long* ks,
                                   const long long* vs, int batch, int h,
                                   int hkv, int sq, int skv, int d, int causal,
                                   int window, float scale, void* stream) {
  return launch(q, k, v, out, qs, ks, vs, batch, h, hkv, sq, skv, d, causal,
                window, scale, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out,
                                    const long long* qs, const long long* ks,
                                    const long long* vs, int batch, int h,
                                    int hkv, int sq, int skv, int d,
                                    int causal, int window, float scale,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16:
      return tc::launch_d<16>(q, k, v, out, qs, ks, vs, batch, h, hkv, sq,
                              skv, causal, window, scale, s);
    case 64:
      return tc::launch_d<64>(q, k, v, out, qs, ks, vs, batch, h, hkv, sq,
                              skv, causal, window, scale, s);
    case 128:
      return tc::launch_d<128>(q, k, v, out, qs, ks, vs, batch, h, hkv, sq,
                               skv, causal, window, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Registers a thread, local (spill) bytes a thread and dynamic shared
// memory a block of the bf16 kernel for head dim d; launches nothing.
extern "C" int flash_attention_bf16_info(int d, int* regs, int* local_bytes,
                                         int* smem_bytes) {
  switch (d) {
    case 16: return tc::info_d<16>(regs, local_bytes, smem_bytes);
    case 64: return tc::info_d<64>(regs, local_bytes, smem_bytes);
    case 128: return tc::info_d<128>(regs, local_bytes, smem_bytes);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Attention forward with an online softmax (flash attention): bf16 on the
// Hopper tensor cores, f32 on the SIMT FMA pipes.
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
// run at the card's rate (f32 is held to the SIMT pipes: below). Both
// kernels below share the TPU kernel's plan: the sequential key axis
// becomes a loop inside one block per (batch, head, query tile), between
// the first and last key tile the masks reach.
// Fully masked rows: m stays -inf, exp is taken against 0, so P and l
// stay 0 and the row's output is 0 (the TPU kernel's l == 0 rule; the JAX
// oracle would give NaN). Ragged Sq and Skv are masked in the kernels, so
// every shape reaches them, and q, k, v are read through their strides
// (last axis contiguous): the model's [B, S, H, D] projections need no
// copy. Like the TPU kernel they take any head dim. Up to 256 each is
// built for the widths 16, 32, 64, 96, 128, 160, 192 and 256, and a head
// dim d runs on the next width up, its tiles zero-filled past d in shared
// memory, so O's columns past d come out 0; O is stored in rows of the
// width, of which the wrapper returns the first d columns. The padding
// costs up to width / d of the math and of O's bytes, none of the inputs'.
// Above 256 neither O of the whole head dim a thread nor Q and K/V tiles
// of it in shared memory fit, so O is cut into n slabs of one width W of
// 128, 160, 192 and 256 (n W >= d in the fewest columns, at most 1.25 d
// up to d = 4096), each slab its own block: it computes S = Q K^T over all
// of d, in panels or chunks of Q and K streamed through shared memory, and
// O for its W columns of V (flash_attention_{tc,f32}_slab_kernel below).
// S is computed once a slab: n times in all, 1.5x the least operations at
// d = 512 and 2.5x at 1024.
//
// bf16 (flash_attention_bf16), FA3-style, for sm_90a:
//   * one 384-thread block per (head, batch, 128-query tile); the tiles
//     are launched last-first, so under the causal mask the longest run
//     first and do not form a tail;
//   * warpgroup 2 is the producer: one thread loads the Q tile once and
//     then K and V tiles of 128 keys (64 above D = 128) by TMA (rank-4
//     tensor maps over the tensors' own strides, 128-byte swizzle, 64- or
//     32-byte where 64 columns do not tile the width; rows past Skv or Sq
//     and columns past the head dim come back as zeros) into a two-stage
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
// f32 (flash_attention_f32): IEEE f32 on the SIMT FMA pipes (tests hold it
// to 2e-4; wgmma has no IEEE f32 mode), so the ceiling is their 67
// TFLOP/s. The design keeps them fed:
//   * one 256-thread block per (head, batch, query tile), tiles launched
//     last-first; the tile is 128 rows, or 64 where a grid of 128-row
//     tiles would not give every SM a block (the wrapper's
//     f32_query_tile: the 1 x 16-head x 512 f32 prefill), and always 64
//     above D = 128, where a 128-row tile does not fit in shared memory
//     (D = 192, 256) or its O in registers (D = 160);
//   * Q, K and V stay as they lie in memory, rows of D at a pitch of D + 4
//     floats: both operands of S = Q K^T run along D, so no transposing
//     scatter. Q is copied once; K and V tiles of 64 keys by cp.async,
//     16 bytes a thread (4 bytes a thread for an operand whose base or
//     strides are off 16 bytes), issued a phase ahead: V(t) lands under
//     S(t), K(t + 1) under P V(t). One K and one V buffer: two of each
//     would not fit beside Q and P at D = 128;
//   * register tiles: thread (ty, tx) of 16 x 16 holds rows ty + 16 i of
//     the tile (8, or 4 at 64 rows), keys tx + 16 j of S (4) and columns
//     64 g + 4 tx + c of O (8 at D = 128; 32 g + 2 tx + c at D = 32, 96
//     and 160), so a row's keys lie in the 16
//     lanes of one half-warp, each warp load is a broadcast or 16
//     neighbouring float4, and a key tile costs a thread 8192 FFMAs
//     against 640 shared-memory loads;
//   * the online softmax in registers: row max and sum by shuffles in
//     the half-warp, exp2 with log2(e) folded into the scale, masks only
//     on tiles that cross the diagonal, the window edge or Skv; P goes to
//     shared memory once (pitch 80, so two rows of a warp's stores land
//     in disjoint banks) and is read as float4 for P V. Two barriers a
//     key tile;
//   * one block an SM (254 registers a thread at D = 128). Tried on the
//     H100 and dropped: unrolling the S loop by 2, 4, 8 or 32 and the P V
//     loop by 2, 8 or 16 (the same or up to 5 % slower than 16 and 4), and
//     512 threads with 4 rows a thread (128 registers, 13 % slower).
// Tests: on the CPU, tests/test_torch_flash_layout.py holds the wrapper's
// choices (copy width, query tile) on meta tensors; on the card,
// tests/test_torch_cuda.py holds the kernel to the plain version within
// 2e-4 (ragged, masked, GQA, unaligned, both tiles, every head dim), bit
// for bit from one launch to the next, and without spills.
#include "common.cuh"
#include "hopper.cuh"

#include <cuda_bf16.h>

#include <cmath>
#include <type_traits>

namespace {

using namespace hopper;

// ---------------------------------------------------------------------------
// f32: cp.async ring, register-tiled S and O, softmax in registers
// ---------------------------------------------------------------------------
namespace simt {

constexpr int THREADS = 256;  // 16 x 16: ty picks rows, tx keys or columns
constexpr int BK = 64;        // keys a tile
constexpr int KJ = BK / 16;   // keys of S a thread holds: tx + 16 j

// D is the width the kernel is built for; a head dim d < D runs on the
// next width up with columns d .. D - 1 of Q, K and V zero-filled in
// shared memory: they add nothing to S and give zero columns of O.
template <int D, int BQ>
struct Cfg {
  static constexpr int R = BQ / 16;  // rows a thread: ty + 16 i
  // columns of O in a group: a float4, or a float2 where 64 does not
  // divide D (D = 32, 96, 160), or a float at D = 16
  static constexpr int CW = D % 64 == 0 ? 4 : (D % 32 == 0 ? 2 : 1);
  static constexpr int CG = D / (16 * CW);         // groups, 16 CW apart
  static constexpr int NC = CW * CG;               // columns of O a thread
  static constexpr int RP = D + 4;                 // row pitch of Q, K, V
  static constexpr int PP = BK + 16;               // row pitch of P
  static constexpr int Q_FLOATS = BQ * RP;
  static constexpr int KV_FLOATS = BK * RP;
  static constexpr int SMEM = (Q_FLOATS + 2 * KV_FLOATS + BQ * PP) * 4;
  static_assert(CW * CG * 16 == D, "the column groups tile D");
  static_assert(BQ * D % (4 * THREADS) == 0 && BK * D % (4 * THREADS) == 0,
                "every thread copies whole 16-byte chunks of each tile");
};

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* out;          // [B, H, Sq, D], contiguous
  long long qs[3];     // strides of q over (batch, head, seq), in elements
  long long ks[3];
  long long vs[3];
  int d;               // the head dim, 1 .. D
  int h, group, sq, skv;
  int causal, window;  // window <= 0: none
  int vec;             // bit 0: q, 1: k, 2: v are copied 16 bytes a thread
  float scale_log2;    // scale * log2(e)
};

// Rows r0 .. r0 + ROWS - 1, columns 0 .. COLS - 1 of an operand whose rows
// lie `ld` elements apart from g (at the block's first column), into
// shared memory at dst with a row pitch of PITCH floats; rows at or past n
// and columns at or past d (what is left of the row from g) are
// zero-filled. vec: 16-byte copies, else 4-byte copies.
template <int COLS, int PITCH, int ROWS>
__device__ __forceinline__ void load_block(uint32_t dst, const float* g,
                                           long long ld, int r0, int n,
                                           int d, bool vec) {
  if (vec) {
    constexpr int CH = COLS / 4;
#pragma unroll
    for (int it = 0; it < ROWS * CH / THREADS; ++it) {
      const int e = threadIdx.x + it * THREADS;
      const int r = e / CH;
      const int c = (e % CH) * 4;
      const bool in = r0 + r < n && c < d;
      cp_async16(dst + (r * PITCH + c) * 4, in ? g + (r0 + r) * ld + c : g,
                 in ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int it = 0; it < ROWS * COLS / THREADS; ++it) {
      const int e = threadIdx.x + it * THREADS;
      const int r = e / COLS;
      const int c = e % COLS;
      const bool in = r0 + r < n && c < d;
      cp_async4(dst + (r * PITCH + c) * 4, in ? g + (r0 + r) * ld + c : g,
                in ? 4 : 0);
    }
  }
}

template <int D, int BQ>
__global__ void __launch_bounds__(THREADS, 1)
    flash_attention_f32_kernel(const Params p) {
  using C = Cfg<D, BQ>;
  extern __shared__ float4 smem_f4[];
  float* qs = reinterpret_cast<float*>(smem_f4);  // [BQ][RP]
  float* ks = qs + C::Q_FLOATS;                   // [BK][RP]
  float* vs = ks + C::KV_FLOATS;                  // [BK][RP]
  float* ps = vs + C::KV_FLOATS;                  // [BQ][PP]
  const uint32_t qs_a = smem_addr(qs);
  const uint32_t ks_a = smem_addr(ks);
  const uint32_t vs_a = smem_addr(vs);

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
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

  const float* qg = p.q + bb * p.qs[0] + hh * p.qs[1];
  const float* kg = p.k + bb * p.ks[0] + hk * p.ks[1];
  const float* vg = p.v + bb * p.vs[0] + hk * p.vs[1];
  if (n_tiles > 0) {
    load_block<D, C::RP, BQ>(qs_a, qg, p.qs[2], q0, p.sq, p.d, p.vec & 1);
    load_block<D, C::RP, BK>(ks_a, kg, p.ks[2], k_begin, p.skv, p.d,
                             p.vec & 2);
    cp_async_commit();
  }

  float o[C::R][C::NC];
  float m[C::R];
  float l[C::R];  // this thread's keys only, until the end
#pragma unroll
  for (int i = 0; i < C::R; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C::NC; ++c) o[i][c] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_begin + t * BK;
    cp_async_wait<0>();
    __syncthreads();  // K(t) (and Q) have landed; V and P are free
    load_block<D, C::RP, BK>(vs_a, vg, p.vs[2], k0, p.skv, p.d, p.vec & 4);
    cp_async_commit();  // V(t) lands under S(t)

    // S = Q K^T: rows ty + 16 i, keys tx + 16 j, both along D in shared
    // memory as they lie
    float s[C::R][KJ];
#pragma unroll
    for (int i = 0; i < C::R; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = 0.f;
#pragma unroll 16
    for (int d = 0; d < D; d += 4) {
      float4 kf[KJ];
#pragma unroll
      for (int j = 0; j < KJ; ++j)
        kf[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * C::RP +
                                                 d);
#pragma unroll
      for (int i = 0; i < C::R; ++i) {
        const float4 qf =
            *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * C::RP + d);
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          s[i][j] = fmaf(qf.x, kf[j].x, s[i][j]);
          s[i][j] = fmaf(qf.y, kf[j].y, s[i][j]);
          s[i][j] = fmaf(qf.z, kf[j].z, s[i][j]);
          s[i][j] = fmaf(qf.w, kf[j].w, s[i][j]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < C::R; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] *= p.scale_log2;
    // masks, only where the tile crosses Skv, the diagonal or the window
    const bool edge = k0 + BK > p.skv || (p.causal && k0 + BK - 1 > q_first) ||
                      (p.window > 0 && k0 <= q_last - p.window);
    if (edge) {
#pragma unroll
      for (int i = 0; i < C::R; ++i) {
        const int qpos = q0 + ty + 16 * i + pos_offset;
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          const int kpos = k0 + tx + 16 * j;
          bool keep = kpos < p.skv;
          if (p.causal) keep = keep && kpos <= qpos;
          if (p.window > 0) keep = keep && kpos > qpos - p.window;
          if (!keep) s[i][j] = -INFINITY;
        }
      }
    }

    // online softmax in base 2: a row's keys lie in the 16 lanes of one
    // half-warp; P goes to shared memory once
#pragma unroll
    for (int i = 0; i < C::R; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < KJ; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
      for (int off = 1; off < 16; off *= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float m_use = (m_new == -INFINITY) ? 0.f : m_new;
      const float alpha = exp2f(m[i] - m_use);
      m[i] = m_new;
      l[i] *= alpha;
#pragma unroll
      for (int c = 0; c < C::NC; ++c) o[i][c] *= alpha;
      float* prow = ps + (ty + 16 * i) * C::PP + tx;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const float e = exp2f(s[i][j] - m_use);
        l[i] += e;
        prow[16 * j] = e;
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // V(t) has landed and P is written; K(t) is free
    if (t + 1 < n_tiles)
      load_block<D, C::RP, BK>(ks_a, kg, p.ks[2], k0 + BK, p.skv, p.d,
                               p.vec & 2);
    cp_async_commit();  // K(t + 1) lands under P V(t)

    // O += P V: rows ty + 16 i, columns 16 CW g + CW tx + c
#pragma unroll 4
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pf[C::R];
#pragma unroll
      for (int i = 0; i < C::R; ++i)
        pf[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * C::PP +
                                                 kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = vs + (kk + u) * C::RP + tx * C::CW;
        float vv[C::NC];
#pragma unroll
        for (int g = 0; g < C::CG; ++g) {
          if constexpr (C::CW == 4) {
            const float4 w =
                *reinterpret_cast<const float4*>(vrow + g * 16 * C::CW);
            vv[4 * g] = w.x;
            vv[4 * g + 1] = w.y;
            vv[4 * g + 2] = w.z;
            vv[4 * g + 3] = w.w;
          } else if constexpr (C::CW == 2) {
            const float2 w =
                *reinterpret_cast<const float2*>(vrow + g * 16 * C::CW);
            vv[2 * g] = w.x;
            vv[2 * g + 1] = w.y;
          } else {
            vv[g] = vrow[g * 16];
          }
        }
#pragma unroll
        for (int i = 0; i < C::R; ++i) {
          const float pv = part(pf[i], u);
#pragma unroll
          for (int c = 0; c < C::NC; ++c) o[i][c] = fmaf(pv, vv[c], o[i][c]);
        }
      }
    }
  }

  float* og = p.out + (static_cast<long long>(bb) * p.h + hh) *
                          static_cast<long long>(p.sq) * D;
#pragma unroll
  for (int i = 0; i < C::R; ++i) {
#pragma unroll
    for (int off = 1; off < 16; off *= 2)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    const int row = q0 + ty + 16 * i;
    if (row >= p.sq) continue;
    const float inv = (l[i] == 0.f) ? 0.f : 1.f / l[i];
    float* orow = og + static_cast<long long>(row) * D + tx * C::CW;
#pragma unroll
    for (int g = 0; g < C::CG; ++g) {
      if constexpr (C::CW == 4) {
        *reinterpret_cast<float4*>(orow + g * 16 * C::CW) =
            make_float4(o[i][4 * g] * inv, o[i][4 * g + 1] * inv,
                        o[i][4 * g + 2] * inv, o[i][4 * g + 3] * inv);
      } else if constexpr (C::CW == 2) {
        *reinterpret_cast<float2*>(orow + g * 16 * C::CW) =
            make_float2(o[i][2 * g] * inv, o[i][2 * g + 1] * inv);
      } else {
        orow[g * 16] = o[i][g] * inv;
      }
    }
  }
}

template <int D, int BQ>
int launch_d(const Params& p, int batch, cudaStream_t stream) {
  using C = Cfg<D, BQ>;
  static SmemOptIn opt_in;
  const cudaError_t err = opt_in(
      reinterpret_cast<const void*>(flash_attention_f32_kernel<D, BQ>),
      C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.h, batch, (p.sq + BQ - 1) / BQ);
  flash_attention_f32_kernel<D, BQ><<<grid, THREADS, C::SMEM, stream>>>(p);
  REPRO_LAUNCH_RESULT();
}

// The 128-row tile is built where it fits in an SM's 227 KB: at D = 256
// its Q and P would take 170 KB beside 130 KB of K and V, so D = 256 has
// the 64-row tile only (Q 65 KB, K and V 130 KB, P 20 KB: 215 KB); at
// D = 192 the 128-row tile would take 242 KB, the 64-row one 171 KB. At
// D = 160 it would fit (204 KB), but a thread would hold 80 f32 of O where
// D = 128's 64 already take it to 254 registers.
template <int D>
constexpr bool kLargeTile = D <= 128;

template <int D>
int launch_tile(const Params& p, int batch, int bq, cudaStream_t stream) {
  if (bq == 64) return launch_d<D, 64>(p, batch, stream);  // small grids
  if constexpr (kLargeTile<D>) {
    if (bq == 128) return launch_d<D, 128>(p, batch, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int D, int BQ>
int info_d(int* regs, int* local_bytes, int* smem_bytes) {
  cudaFuncAttributes a;
  const cudaError_t err =
      cudaFuncGetAttributes(&a, flash_attention_f32_kernel<D, BQ>);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  *smem_bytes = Cfg<D, BQ>::SMEM;
  return 0;
}

template <int D>
int info_tile(int bq, int* regs, int* local_bytes, int* smem_bytes) {
  if (bq == 64) return info_d<D, 64>(regs, local_bytes, smem_bytes);
  if constexpr (kLargeTile<D>) {
    if (bq == 128) return info_d<D, 128>(regs, local_bytes, smem_bytes);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// -- head dims above 256: O in slabs of W columns, one block a slab ---------
// A block computes S = Q K^T over the whole head dim d, in chunks of
// SLAB_DC columns of Q and K double-buffered by cp.async (rows of d do not
// fit in shared memory above 256), and O for its W columns of V only.
constexpr int SLAB_DC = 128;  // columns of a Q or K chunk

template <int W>
struct SlabCfg {
  static constexpr int BQ = 64;   // query rows a block (R = 4 a thread)
  static constexpr int R = BQ / 16;
  static constexpr int CW = W % 64 == 0 ? 4 : 2;   // 160: float2 groups
  static constexpr int CG = W / (16 * CW);
  static constexpr int NC = CW * CG;               // columns of O a thread
  static constexpr int CP = SLAB_DC + 4;           // row pitch of a chunk
  static constexpr int VP = W + 4;                 // row pitch of V
  static constexpr int PP = BK + 16;               // row pitch of P
  static constexpr int QC_FLOATS = BQ * CP;
  static constexpr int KC_FLOATS = BK * CP;
  static constexpr int V_FLOATS = BK * VP;
  // two Q and two K chunks, V and P: 222,208 bytes at W = 256
  static constexpr int SMEM =
      (2 * (QC_FLOATS + KC_FLOATS) + V_FLOATS + BQ * PP) * 4;
  static_assert(CW * CG * 16 == W, "the column groups tile W");
  static_assert(BK * W % (4 * THREADS) == 0, "whole 16-byte chunks of V");
};

struct SlabParams : Params {
  int slabs;  // n: out is [B, H, Sq, n W], slab blockIdx.x % n its columns
};

template <int W>
__global__ void __launch_bounds__(THREADS, 1)
    flash_attention_f32_slab_kernel(const SlabParams p) {
  using C = SlabCfg<W>;
  constexpr int BQ = C::BQ;
  extern __shared__ float4 smem_f4[];
  float* qs = reinterpret_cast<float*>(smem_f4);  // [2][BQ][CP]
  float* ks = qs + 2 * C::QC_FLOATS;              // [2][BK][CP]
  float* vs = ks + 2 * C::KC_FLOATS;              // [BK][VP]
  float* ps = vs + C::V_FLOATS;                   // [BQ][PP]
  const uint32_t qs_a = smem_addr(qs);
  const uint32_t ks_a = smem_addr(ks);
  const uint32_t vs_a = smem_addr(vs);

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int hh = blockIdx.x / p.slabs;
  const int slab = blockIdx.x % p.slabs;
  const int bb = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // longest tiles first
  const int hk = hh / p.group;
  const int pos_offset = p.skv - p.sq;

  const int q_first = q0 + pos_offset;
  const int q_last = min(q0 + BQ, p.sq) - 1 + pos_offset;
  int k_end = p.skv;
  if (p.causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, q_first - p.window + 1);
  k_begin = (k_begin / BK) * BK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
  const int chunks = (p.d + SLAB_DC - 1) / SLAB_DC;
  const int v0 = slab * W;  // this slab's first column

  const float* qg = p.q + bb * p.qs[0] + hh * p.qs[1];
  const float* kg = p.k + bb * p.ks[0] + hk * p.ks[1];
  const float* vg = p.v + bb * p.vs[0] + hk * p.vs[1] + v0;
  // chunk c of Q and of the key tile at k0 into buffer c % 2
  auto load_chunk = [&](int c, int k0) {
    const int c0 = c * SLAB_DC;
    const uint32_t buf = c & 1;
    load_block<SLAB_DC, C::CP, BQ>(qs_a + buf * C::QC_FLOATS * 4, qg + c0,
                                   p.qs[2], q0, p.sq, p.d - c0, p.vec & 1);
    load_block<SLAB_DC, C::CP, BK>(ks_a + buf * C::KC_FLOATS * 4, kg + c0,
                                   p.ks[2], k0, p.skv, p.d - c0, p.vec & 2);
  };
  if (n_tiles > 0) {
    load_chunk(0, k_begin);
    cp_async_commit();
  }

  float o[C::R][C::NC];
  float m[C::R];
  float l[C::R];  // this thread's keys only, until the end
#pragma unroll
  for (int i = 0; i < C::R; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C::NC; ++c) o[i][c] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_begin + t * BK;
    float s[C::R][KJ];
#pragma unroll
    for (int i = 0; i < C::R; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = 0.f;

    // S = Q K^T, chunk by chunk: chunk c + 1 (and V(t) under chunk 0)
    // lands under chunk c's FMAs
    for (int c = 0; c < chunks; ++c) {
      cp_async_wait<0>();
      __syncthreads();  // chunk c has landed; the other buffer, V, P free
      if (c == 0)
        load_block<W, C::VP, BK>(vs_a, vg, p.vs[2], k0, p.skv, p.d - v0,
                                 p.vec & 4);
      if (c + 1 < chunks) load_chunk(c + 1, k0);
      cp_async_commit();
      const float* qc = qs + (c & 1) * C::QC_FLOATS;
      const float* kc = ks + (c & 1) * C::KC_FLOATS;
#pragma unroll 16
      for (int d = 0; d < SLAB_DC; d += 4) {
        float4 kf[KJ];
#pragma unroll
        for (int j = 0; j < KJ; ++j)
          kf[j] = *reinterpret_cast<const float4*>(kc + (tx + 16 * j) * C::CP +
                                                   d);
#pragma unroll
        for (int i = 0; i < C::R; ++i) {
          const float4 qf = *reinterpret_cast<const float4*>(
              qc + (ty + 16 * i) * C::CP + d);
#pragma unroll
          for (int j = 0; j < KJ; ++j) {
            s[i][j] = fmaf(qf.x, kf[j].x, s[i][j]);
            s[i][j] = fmaf(qf.y, kf[j].y, s[i][j]);
            s[i][j] = fmaf(qf.z, kf[j].z, s[i][j]);
            s[i][j] = fmaf(qf.w, kf[j].w, s[i][j]);
          }
        }
      }
    }

#pragma unroll
    for (int i = 0; i < C::R; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] *= p.scale_log2;
    const bool edge = k0 + BK > p.skv || (p.causal && k0 + BK - 1 > q_first) ||
                      (p.window > 0 && k0 <= q_last - p.window);
    if (edge) {
#pragma unroll
      for (int i = 0; i < C::R; ++i) {
        const int qpos = q0 + ty + 16 * i + pos_offset;
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          const int kpos = k0 + tx + 16 * j;
          bool keep = kpos < p.skv;
          if (p.causal) keep = keep && kpos <= qpos;
          if (p.window > 0) keep = keep && kpos > qpos - p.window;
          if (!keep) s[i][j] = -INFINITY;
        }
      }
    }

#pragma unroll
    for (int i = 0; i < C::R; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < KJ; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
      for (int off = 1; off < 16; off *= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float m_use = (m_new == -INFINITY) ? 0.f : m_new;
      const float alpha = exp2f(m[i] - m_use);
      m[i] = m_new;
      l[i] *= alpha;
#pragma unroll
      for (int c = 0; c < C::NC; ++c) o[i][c] *= alpha;
      float* prow = ps + (ty + 16 * i) * C::PP + tx;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const float e = exp2f(s[i][j] - m_use);
        l[i] += e;
        prow[16 * j] = e;
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // V(t) has landed and P is written; the chunks are free
    if (t + 1 < n_tiles) load_chunk(0, k0 + BK);
    cp_async_commit();  // chunk 0 of tile t + 1 lands under P V(t)

    // O += P V over this slab's W columns
#pragma unroll 4
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pf[C::R];
#pragma unroll
      for (int i = 0; i < C::R; ++i)
        pf[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * C::PP +
                                                 kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = vs + (kk + u) * C::VP + tx * C::CW;
        float vv[C::NC];
#pragma unroll
        for (int g = 0; g < C::CG; ++g) {
          if constexpr (C::CW == 4) {
            const float4 w =
                *reinterpret_cast<const float4*>(vrow + g * 16 * C::CW);
            vv[4 * g] = w.x;
            vv[4 * g + 1] = w.y;
            vv[4 * g + 2] = w.z;
            vv[4 * g + 3] = w.w;
          } else {
            const float2 w =
                *reinterpret_cast<const float2*>(vrow + g * 16 * C::CW);
            vv[2 * g] = w.x;
            vv[2 * g + 1] = w.y;
          }
        }
#pragma unroll
        for (int i = 0; i < C::R; ++i) {
          const float pv = part(pf[i], u);
#pragma unroll
          for (int c = 0; c < C::NC; ++c) o[i][c] = fmaf(pv, vv[c], o[i][c]);
        }
      }
    }
  }

  const long long pitch = static_cast<long long>(p.slabs) * W;
  float* og = p.out + (static_cast<long long>(bb) * p.h + hh) *
                          static_cast<long long>(p.sq) * pitch + v0;
#pragma unroll
  for (int i = 0; i < C::R; ++i) {
#pragma unroll
    for (int off = 1; off < 16; off *= 2)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    const int row = q0 + ty + 16 * i;
    if (row >= p.sq) continue;
    const float inv = (l[i] == 0.f) ? 0.f : 1.f / l[i];
    float* orow = og + row * pitch + tx * C::CW;
#pragma unroll
    for (int g = 0; g < C::CG; ++g) {
      if constexpr (C::CW == 4) {
        *reinterpret_cast<float4*>(orow + g * 16 * C::CW) =
            make_float4(o[i][4 * g] * inv, o[i][4 * g + 1] * inv,
                        o[i][4 * g + 2] * inv, o[i][4 * g + 3] * inv);
      } else {
        *reinterpret_cast<float2*>(orow + g * 16 * C::CW) =
            make_float2(o[i][2 * g] * inv, o[i][2 * g + 1] * inv);
      }
    }
  }
}

template <int W>
int launch_slabs(const SlabParams& p, int batch, cudaStream_t stream) {
  using C = SlabCfg<W>;
  static SmemOptIn opt_in;
  const cudaError_t err = opt_in(
      reinterpret_cast<const void*>(flash_attention_f32_slab_kernel<W>),
      C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.h * p.slabs, batch, (p.sq + C::BQ - 1) / C::BQ);
  flash_attention_f32_slab_kernel<W><<<grid, THREADS, C::SMEM, stream>>>(p);
  REPRO_LAUNCH_RESULT();
}

template <int W>
int info_slabs(int* regs, int* local_bytes, int* smem_bytes) {
  cudaFuncAttributes a;
  const cudaError_t err =
      cudaFuncGetAttributes(&a, flash_attention_f32_slab_kernel<W>);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  *smem_bytes = SlabCfg<W>::SMEM;
  return 0;
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------
namespace tc {

constexpr int BQ = 128;      // query rows per block: two consumer warpgroups
constexpr int STAGES = 2;    // K/V ring depth
constexpr int THREADS = 384;
constexpr int PRODUCER_WG = 2;
constexpr int PRODUCER_REGS = 40;   // 128 x 40 + 256 x 232 <= 65536
constexpr int CONSUMER_REGS = 232;

// D is the width the kernel is built for (flash_attention.py's
// HEAD_DIMS); a head dim d < D runs on the next width up: the tensor maps
// span d, so TMA fills columns d .. D - 1 of every tile with zeros, which
// add nothing to S = Q K^T and give zero columns of O.
template <int D>
struct Cfg {
  // Keys a tile: 128, or 64 above D = 128, where the Q tile (64 KB at
  // D = 256, 48 KB at 192) and a two-stage ring of 128-key K and V tiles
  // (256 KB, 192 KB) would not fit in the 227 KB of an SM; at 64 keys the
  // ring is 128 KB (96 KB). A consumer thread then holds D / 2 f32 of O
  // (128 at D = 256, 96 at 192), 32 of S and 32 registers of P's two bf16
  // halves. O += P V takes N = D in one wgmma (m64n256k16, m64n192k16),
  // V's panels BK * SW bytes apart. D = 160 takes 64 keys too: 128-key
  // tiles would fit (200 KB), but S and P's halves (128 registers) beside
  // 80 of O would not fit a consumer's 232.
  static constexpr int BK = D > 128 ? 64 : 128;
  // A row of a shared-memory panel is one swizzle span, the widest of
  // 128, 64 and 32 bytes whose panels tile D: 128 (64 bf16) where 64
  // divides D, 64 at D = 32, 96 and 160 (1, 3 and 5 panels of 32
  // columns), 32 at D = 16.
  static constexpr int SW = D % 64 == 0 ? 128 : (D % 32 == 0 ? 64 : 32);
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
  CUtensorMap qmap, kmap, vmap;  // [B, H, S, d] as rank 4, d innermost
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
__device__ __forceinline__ void wgmma_rs(float (&d)[16], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
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
__device__ __forceinline__ void wgmma_rs(float (&d)[48], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
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
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
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

// D[64xN] += A[64x16] B[16xN]: A from registers, B from shared memory
// (MN-major: the transpose bit is set)
__device__ __forceinline__ void wgmma_rs(float (&d)[80], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79}, "
      "{%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// D[64xN] += A[64x16] B[16xN]: A from registers, B from shared memory
// (MN-major: the transpose bit is set)
__device__ __forceinline__ void wgmma_rs(float (&d)[96], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// D[64xN] += A[64x16] B[16xN]: A from registers, B from shared memory
// (MN-major: the transpose bit is set)
__device__ __forceinline__ void wgmma_rs(float (&d)[128], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107,"
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
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
  k_begin = (k_begin / C::BK) * C::BK;
  const int n_tiles =
      k_end > k_begin ? (k_end - k_begin + C::BK - 1) / C::BK : 0;

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
        const int k0 = k_begin + t * C::BK;
        mbar_wait(empty + 8 * s, ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(full_k + 8 * s, C::KV_BYTES);
#pragma unroll
        for (int pn = 0; pn < C::PANELS; ++pn)
          tma_load(k_s + s * C::KV_BYTES + pn * C::BK * C::SW, &p.kmap,
                   full_k + 8 * s, pn * C::PW, k0, hk, bb);
        mbar_expect_tx(full_v + 8 * s, C::KV_BYTES);
#pragma unroll
        for (int pn = 0; pn < C::PANELS; ++pn)
          tma_load(v_s + s * C::KV_BYTES + pn * C::BK * C::SW, &p.vmap,
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
    float s[C::BK / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < C::BK / 2; ++i) s[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};  // this thread's columns only, until the end

    if (n_tiles > 0) mbar_wait(q_bar, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % STAGES;
      const uint32_t parity = (t / STAGES) & 1;
      const int k0 = k_begin + t * C::BK;

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
                 make_desc(kt + pn * C::BK * C::SW + off, 16, 8 * C::SW,
                           C::LAYOUT),
                 kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(s);

#pragma unroll
      for (int i = 0; i < C::BK / 2; ++i) s[i] *= p.scale_log2;
      // masks, only where the tile crosses Skv, the diagonal or the window
      const bool edge = k0 + C::BK > p.skv ||
                        (p.causal && k0 + C::BK - 1 > wg_qmin) ||
                        (p.window > 0 && k0 <= wg_qmax - p.window);
      if (edge) {
#pragma unroll
        for (int c = 0; c < C::BK / 8; ++c)
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
      for (int c = 0; c < C::BK / 8; ++c)
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
      uint32_t p_hi[C::BK / 4];
      uint32_t p_lo[C::BK / 4];
#pragma unroll
      for (int c = 0; c < C::BK / 8; ++c)
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
      for (int kk = 0; kk < C::BK / 16; ++kk)
        wgmma_rs(o, p_hi[4 * kk], p_hi[4 * kk + 1], p_hi[4 * kk + 2],
                 p_hi[4 * kk + 3],
                 make_desc(vt + kk * 16 * C::SW, C::BK * C::SW, 8 * C::SW,
                           C::LAYOUT));
#pragma unroll
      for (int kk = 0; kk < C::BK / 16; ++kk)
        wgmma_rs(o, p_lo[4 * kk], p_lo[4 * kk + 1], p_lo[4 * kk + 2],
                 p_lo[4 * kk + 3],
                 make_desc(vt + kk * 16 * C::SW, C::BK * C::SW, 8 * C::SW,
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
// strides st = (batch, head, row); boxes of (panel width, box_rows), so
// a box's columns at or past d, like its rows past the end, come back as
// zeros. The stride of an axis of length 1 is never used, and is replaced
// by a valid one (a row's, rounded up to 16 bytes). The Python wrapper has
// already checked TMA's rules (16-byte base and strides, last axis
// contiguous); the encoder checks them again.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int d,
            int rows, int heads, int batch, const long long* st, int box_rows,
            int sw) {
  long long row_b = st[2] * 2, head_b = st[1] * 2, batch_b = st[0] * 2;
  if (rows == 1) row_b = (d * 2LL + 15) / 16 * 16;
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
             int batch, int h, int hkv, int sq, int skv, int d, int causal,
             int window, float scale, cudaStream_t stream) {
  if (d < 1 || d > D) return static_cast<int>(cudaErrorInvalidValue);
  EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  Params p;
  if (!encode(fn, &p.qmap, q, d, sq, h, batch, qs, BQ, Cfg<D>::SW))
    return static_cast<int>(cudaErrorInvalidValue);
  if (skv > 0) {
    constexpr int BK = Cfg<D>::BK;
    if (!encode(fn, &p.kmap, k, d, skv, hkv, batch, ks, BK, Cfg<D>::SW) ||
        !encode(fn, &p.vmap, v, d, skv, hkv, batch, vs, BK, Cfg<D>::SW))
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

// -- head dims above 256: O in slabs of W columns, one block a slab ---------
// Neither Q and a K/V ring of the whole head dim nor O of it a thread fit
// above 256, so a block computes S = Q K^T over d in panels of 64 columns
// (128-byte swizzle), K's panels streaming through a ring, and O for its
// W columns only: the consumers hold W / 2 f32 of O, as the kernel of
// width W does. Q stays in shared memory up to Q_RESIDENT panels (d <=
// 512); above that its panels stream through the ring beside K's.
template <int W>
struct SlabCfg {
  static constexpr int BK = 64;          // keys a tile
  static constexpr int QK_SW = 128;      // Q and K panels: 64 columns
  static constexpr int QK_PW = QK_SW / 2;
  static constexpr int Q_PANEL = BQ * QK_SW;   // 16 KB
  static constexpr int K_PANEL = BK * QK_SW;   // 8 KB
  static constexpr int Q_RESIDENT = 8;   // panels of Q kept: 128 KB
  static constexpr int K_STAGES = 4;     // panel ring (K, and Q streamed)
  static constexpr int V_STAGES = 2;
  // V's slab as the kernel of width W lays V out: panels of one swizzle
  // span, 128 bytes where 64 divides W, 64 at W = 160
  static constexpr int SW = W % 64 == 0 ? 128 : 64;
  static constexpr int PW = SW / 2;
  static constexpr int V_PANELS = W / PW;
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : 2;
  static constexpr int V_BYTES = BK * W * 2;
  static constexpr int K_OFF = Q_RESIDENT * Q_PANEL;
  static constexpr int V_OFF = K_OFF + K_STAGES * K_PANEL;
  static constexpr int BAR_OFF = V_OFF + V_STAGES * V_BYTES;
  // barriers: Q, full and empty for each panel stage and each V stage
  // (230,504 bytes at W = 256)
  static constexpr int SMEM =
      BAR_OFF + 8 * (1 + 2 * K_STAGES + 2 * V_STAGES) + 1024;
  static_assert(V_BYTES % 1024 == 0, "swizzled tiles stay 1024-byte aligned");
  static_assert(SMEM <= 232448, "one block fits in an SM's shared memory");
};

struct SlabParams {
  CUtensorMap qmap, kmap;  // [B, H, S, d], boxes of 64 columns
  CUtensorMap vmap;        // boxes of V's panel width
  void* out;               // [B, H, Sq, slabs * W], contiguous
  int h, group, sq, skv;
  int causal, window;      // window <= 0: none
  int d;                   // the head dim, 257 and up
  int slabs;               // blockIdx.x = head * slabs + slab
  int panels;              // 64-column panels of d
  float scale_log2;        // scale * log2(e)
};

template <int W>
__global__ void __launch_bounds__(THREADS, 1)
    flash_attention_tc_slab_kernel(const __grid_constant__ SlabParams p) {
  using C = SlabCfg<W>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = base + C::K_OFF;
  const uint32_t v_s = base + C::V_OFF;
  const uint32_t q_bar = base + C::BAR_OFF;
  const uint32_t full_k = q_bar + 8;
  const uint32_t empty_k = full_k + 8 * C::K_STAGES;
  const uint32_t full_v = empty_k + 8 * C::K_STAGES;
  const uint32_t empty_v = full_v + 8 * C::V_STAGES;

  const int hh = blockIdx.x / p.slabs;
  const int slab = blockIdx.x % p.slabs;
  const int bb = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // longest tiles first
  const int hk = hh / p.group;
  const int pos_offset = p.skv - p.sq;
  const bool q_stream = p.panels > C::Q_RESIDENT;

  const int q_first = q0 + pos_offset;
  const int q_last = min(q0 + BQ, p.sq) - 1 + pos_offset;
  int k_end = p.skv;
  if (p.causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, q_first - p.window + 1);
  k_begin = (k_begin / C::BK) * C::BK;
  const int n_tiles =
      k_end > k_begin ? (k_end - k_begin + C::BK - 1) / C::BK : 0;
  // V panels of this slab that reach into d; the others (in the last slab)
  // are zeroed once here and never loaded, so no TMA box lies wholly
  // outside the tensor and O's columns past d come out 0
  const int v_panels =
      min(C::V_PANELS, (p.d - slab * W + C::PW - 1) / C::PW);
  if (v_panels < C::V_PANELS) {
    uint8_t* vz = smem_raw + (v_s - smem_addr(smem_raw));
    constexpr int CHUNKS = C::V_BYTES / 16;  // 16-byte chunks a stage
    for (int i = v_panels * C::BK * C::SW / 16 + threadIdx.x; i < CHUNKS;
         i += THREADS)
#pragma unroll
      for (int st = 0; st < C::V_STAGES; ++st)
        reinterpret_cast<uint4*>(vz + st * C::V_BYTES)[i] =
            make_uint4(0, 0, 0, 0);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < C::K_STAGES; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(empty_k + 8 * s, 2 * 128);  // every consumer thread
    }
    for (int s = 0; s < C::V_STAGES; ++s) {
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_v + 8 * s, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == PRODUCER_WG) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == PRODUCER_WG * 128 && n_tiles > 0) {
      if (!q_stream) {
        mbar_expect_tx(q_bar, p.panels * C::Q_PANEL);
        for (int pn = 0; pn < p.panels; ++pn)
          tma_load(q_s + pn * C::Q_PANEL, &p.qmap, q_bar, pn * C::QK_PW, q0,
                   hh, bb);
      }
      int g = 0;  // panels through the ring so far
      for (int t = 0; t < n_tiles; ++t) {
        const int k0 = k_begin + t * C::BK;
        for (int pn = 0; pn < p.panels; ++pn, ++g) {
          const int s = g % C::K_STAGES;
          mbar_wait(empty_k + 8 * s, ((g / C::K_STAGES) & 1) ^ 1);
          mbar_expect_tx(full_k + 8 * s,
                         C::K_PANEL + (q_stream ? C::Q_PANEL : 0));
          tma_load(k_s + s * C::K_PANEL, &p.kmap, full_k + 8 * s,
                   pn * C::QK_PW, k0, hk, bb);
          if (q_stream)
            tma_load(q_s + s * C::Q_PANEL, &p.qmap, full_k + 8 * s,
                     pn * C::QK_PW, q0, hh, bb);
        }
        const int vs = t % C::V_STAGES;
        mbar_wait(empty_v + 8 * vs, ((t / C::V_STAGES) & 1) ^ 1);
        mbar_expect_tx(full_v + 8 * vs, v_panels * C::BK * C::SW);
        for (int pn = 0; pn < v_panels; ++pn)
          tma_load(v_s + vs * C::V_BYTES + pn * C::BK * C::SW, &p.vmap,
                   full_v + 8 * vs, slab * W + pn * C::PW, k0, hk, bb);
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
    const int wg_qmin = q0 + wg * 64 + pos_offset;
    const int wg_qmax = wg_qmin + 63;

    float o[W / 2];
    float s[C::BK / 2];
#pragma unroll
    for (int i = 0; i < W / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < C::BK / 2; ++i) s[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};  // this thread's columns only, until the end

    if (n_tiles > 0 && !q_stream) mbar_wait(q_bar, 0);
    int g = 0;
    for (int t = 0; t < n_tiles; ++t) {
      const int vs = t % C::V_STAGES;
      const int k0 = k_begin + t * C::BK;

      // S = Q K^T panel by panel; a panel's stage is released once the
      // next panel's products are issued and its own are done
      for (int pn = 0; pn < p.panels; ++pn, ++g) {
        const int st = g % C::K_STAGES;
        mbar_wait(full_k + 8 * st, (g / C::K_STAGES) & 1);
        const uint32_t qp =
            q_s + (q_stream ? st : pn) * C::Q_PANEL + wg * 64 * C::QK_SW;
        const uint32_t kp = k_s + st * C::K_PANEL;
        pin(s);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < C::QK_PW / 16; ++kk)
          wgmma_ss<0>(s, make_desc(qp + kk * 32, 16, 8 * C::QK_SW, 1),
                      make_desc(kp + kk * 32, 16, 8 * C::QK_SW, 1),
                      pn > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
        pin(s);
        if (pn > 0) mbar_arrive(empty_k + 8 * ((g - 1) % C::K_STAGES));
      }
      wgmma_wait_all();
      pin(s);
      mbar_arrive(empty_k + 8 * ((g - 1) % C::K_STAGES));

#pragma unroll
      for (int i = 0; i < C::BK / 2; ++i) s[i] *= p.scale_log2;
      const bool edge = k0 + C::BK > p.skv ||
                        (p.causal && k0 + C::BK - 1 > wg_qmin) ||
                        (p.window > 0 && k0 <= wg_qmax - p.window);
      if (edge) {
#pragma unroll
        for (int c = 0; c < C::BK / 8; ++c)
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

      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int c = 0; c < C::BK / 8; ++c)
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
      for (int c = 0; c < W / 8; ++c)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          o[4 * c + 2 * i] *= alpha[i];
          o[4 * c + 2 * i + 1] *= alpha[i];
        }
      uint32_t p_hi[C::BK / 4];
      uint32_t p_lo[C::BK / 4];
#pragma unroll
      for (int c = 0; c < C::BK / 8; ++c)
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

      // O += P_hi V + P_lo V over this slab's W columns of V
      mbar_wait(full_v + 8 * vs, (t / C::V_STAGES) & 1);
      const uint32_t vt = v_s + vs * C::V_BYTES;
      pin(o);
      pin(p_hi);
      pin(p_lo);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::BK / 16; ++kk)
        wgmma_rs(o, p_hi[4 * kk], p_hi[4 * kk + 1], p_hi[4 * kk + 2],
                 p_hi[4 * kk + 3],
                 make_desc(vt + kk * 16 * C::SW, C::BK * C::SW, 8 * C::SW,
                           C::LAYOUT));
#pragma unroll
      for (int kk = 0; kk < C::BK / 16; ++kk)
        wgmma_rs(o, p_lo[4 * kk], p_lo[4 * kk + 1], p_lo[4 * kk + 2],
                 p_lo[4 * kk + 3],
                 make_desc(vt + kk * 16 * C::SW, C::BK * C::SW, 8 * C::SW,
                           C::LAYOUT));
      wgmma_commit();
      wgmma_wait_all();
      pin(o);
      pin(p_hi);
      pin(p_lo);
      mbar_arrive(empty_v + 8 * vs);
    }

    const long long pitch = static_cast<long long>(p.slabs) * W;
    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.out) +
                        (static_cast<long long>(bb) * p.h + hh) *
                            static_cast<long long>(p.sq) * pitch +
                        slab * W;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      const int row = q0 + row0 + 8 * i;
      if (row >= p.sq) continue;
      const float inv = (l[i] == 0.f) ? 0.f : 1.f / l[i];
      __nv_bfloat16* orow = og + row * pitch + col0;
#pragma unroll
      for (int c = 0; c < W / 8; ++c)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c) =
            __floats2bfloat162_rn(o[4 * c + 2 * i] * inv,
                                  o[4 * c + 2 * i + 1] * inv);
    }
  }
}

template <int W>
int launch_slabs(const void* q, const void* k, const void* v, void* out,
                 const long long* qs, const long long* ks, const long long* vs,
                 int batch, int h, int hkv, int sq, int skv, int d, int slabs,
                 int causal, int window, float scale, cudaStream_t stream) {
  using C = SlabCfg<W>;
  if (slabs < 1 || d <= (slabs - 1) * W || d > slabs * W)
    return static_cast<int>(cudaErrorInvalidValue);
  EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  SlabParams p;
  if (!encode(fn, &p.qmap, q, d, sq, h, batch, qs, BQ, C::QK_SW))
    return static_cast<int>(cudaErrorInvalidValue);
  if (skv > 0) {
    if (!encode(fn, &p.kmap, k, d, skv, hkv, batch, ks, C::BK, C::QK_SW) ||
        !encode(fn, &p.vmap, v, d, skv, hkv, batch, vs, C::BK, C::SW))
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
  p.d = d;
  p.slabs = slabs;
  p.panels = (d + C::QK_PW - 1) / C::QK_PW;
  p.scale_log2 = scale * 1.4426950408889634f;
  static SmemOptIn opt_in;
  const cudaError_t err = opt_in(
      reinterpret_cast<const void*>(flash_attention_tc_slab_kernel<W>),
      C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(h * slabs, batch, (sq + BQ - 1) / BQ);
  flash_attention_tc_slab_kernel<W><<<grid, THREADS, C::SMEM, stream>>>(p);
  REPRO_LAUNCH_RESULT();
}

template <int W>
int info_slabs(int* regs, int* local_bytes, int* smem_bytes) {
  cudaFuncAttributes a;
  cudaError_t err =
      cudaFuncGetAttributes(&a, flash_attention_tc_slab_kernel<W>);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  *smem_bytes = SlabCfg<W>::SMEM;
  return 0;
}

}  // namespace tc

// Calls f(std::integral_constant<int, D>{}) for the width D == width that
// the kernels are built for (flash_attention.py's HEAD_DIMS: the smoke
// configs' 16, whisper-tiny's 64, the 128 of the dense, moe and vlm
// configs, nemotron-4-340b's 192, recurrentgemma-9b's 256, and 32, 96 and
// 160, so that a head dim above 16 runs less than 2x wide and one above 64
// less than 1.5x); cudaErrorInvalidValue for any other.
template <class F>
int by_width(int width, F&& f) {
  switch (width) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 96: return f(std::integral_constant<int, 96>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 160: return f(std::integral_constant<int, 160>{});
    case 192: return f(std::integral_constant<int, 192>{});
    case 256: return f(std::integral_constant<int, 256>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The same for the slab widths of head dims above 256 (flash_attention.py's
// SLAB_WIDTHS): with n slabs of the fewest columns n W >= d, no head dim
// from 257 to 4096 runs more than 1.25x wide.
template <class F>
int by_slab_width(int width, F&& f) {
  switch (width) {
    case 128: return f(std::integral_constant<int, 128>{});
    case 160: return f(std::integral_constant<int, 160>{});
    case 192: return f(std::integral_constant<int, 192>{});
    case 256: return f(std::integral_constant<int, 256>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Attention at head dim d on the kernel built for `width` (d <= width):
// out is [B, H, Sq, width], its columns past d zero.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* out,
                                   const long long* qs, const long long* ks,
                                   const long long* vs, int batch, int h,
                                   int hkv, int sq, int skv, int d, int width,
                                   int causal, int window, float scale,
                                   int bq, int vec, void* stream) {
  if (d < 1 || d > width) return static_cast<int>(cudaErrorInvalidValue);
  simt::Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.out = static_cast<float*>(out);
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = qs[i];
    p.ks[i] = ks[i];
    p.vs[i] = vs[i];
  }
  p.d = d;
  p.h = h;
  p.group = h / hkv;
  p.sq = sq;
  p.skv = skv;
  p.causal = causal;
  p.window = window;
  p.vec = vec;
  p.scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_width(width, [&](auto w) {
    return simt::launch_tile<decltype(w)::value>(p, batch, bq, s);
  });
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out,
                                    const long long* qs, const long long* ks,
                                    const long long* vs, int batch, int h,
                                    int hkv, int sq, int skv, int d,
                                    int width, int causal, int window,
                                    float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_width(width, [&](auto w) {
    return tc::launch_d<decltype(w)::value>(q, k, v, out, qs, ks, vs, batch,
                                            h, hkv, sq, skv, d, causal,
                                            window, scale, s);
  });
}

// Registers a thread, local (spill) bytes a thread and dynamic shared
// memory a block of the bf16 kernel built for `width`; launches nothing.
extern "C" int flash_attention_bf16_info(int width, int* regs,
                                         int* local_bytes, int* smem_bytes) {
  return by_width(width, [&](auto w) {
    return tc::info_d<decltype(w)::value>(regs, local_bytes, smem_bytes);
  });
}

// The same for the f32 kernel with query tile bq (128 or 64; 64 only
// above width 128).
extern "C" int flash_attention_f32_info(int width, int bq, int* regs,
                                        int* local_bytes, int* smem_bytes) {
  return by_width(width, [&](auto w) {
    return simt::info_tile<decltype(w)::value>(bq, regs, local_bytes,
                                               smem_bytes);
  });
}

// Attention at a head dim d above 256 in `slabs` slabs of `width` columns
// ((slabs - 1) width < d <= slabs width), one block a slab: out is
// [B, H, Sq, slabs * width], its columns past d zero.
extern "C" int flash_attention_f32_slabs(const void* q, const void* k,
                                         const void* v, void* out,
                                         const long long* qs,
                                         const long long* ks,
                                         const long long* vs, int batch,
                                         int h, int hkv, int sq, int skv,
                                         int d, int width, int slabs,
                                         int causal, int window, float scale,
                                         int vec, void* stream) {
  if (slabs < 1 || d <= (slabs - 1) * width || d > slabs * width)
    return static_cast<int>(cudaErrorInvalidValue);
  simt::SlabParams p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.out = static_cast<float*>(out);
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = qs[i];
    p.ks[i] = ks[i];
    p.vs[i] = vs[i];
  }
  p.d = d;
  p.h = h;
  p.group = h / hkv;
  p.sq = sq;
  p.skv = skv;
  p.causal = causal;
  p.window = window;
  p.vec = vec;
  p.scale_log2 = scale * 1.4426950408889634f;
  p.slabs = slabs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_slab_width(width, [&](auto w) {
    return simt::launch_slabs<decltype(w)::value>(p, batch, s);
  });
}

extern "C" int flash_attention_bf16_slabs(const void* q, const void* k,
                                          const void* v, void* out,
                                          const long long* qs,
                                          const long long* ks,
                                          const long long* vs, int batch,
                                          int h, int hkv, int sq, int skv,
                                          int d, int width, int slabs,
                                          int causal, int window, float scale,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_slab_width(width, [&](auto w) {
    return tc::launch_slabs<decltype(w)::value>(q, k, v, out, qs, ks, vs,
                                                batch, h, hkv, sq, skv, d,
                                                slabs, causal, window, scale,
                                                s);
  });
}

// Registers a thread, local (spill) bytes a thread and dynamic shared
// memory a block of the slab kernels of `width`; launches nothing.
extern "C" int flash_attention_bf16_slabs_info(int width, int* regs,
                                               int* local_bytes,
                                               int* smem_bytes) {
  return by_slab_width(width, [&](auto w) {
    return tc::info_slabs<decltype(w)::value>(regs, local_bytes, smem_bytes);
  });
}

extern "C" int flash_attention_f32_slabs_info(int width, int* regs,
                                              int* local_bytes,
                                              int* smem_bytes) {
  return by_slab_width(width, [&](auto w) {
    return simt::info_slabs<decltype(w)::value>(regs, local_bytes,
                                                smem_bytes);
  });
}

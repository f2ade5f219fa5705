// Attention forward with an online softmax (flash attention), f32 or bf16
// in, f32 arithmetic, output in the input's type.
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
// lengths it is bound by operations. This first version does them on the
// SIMT f32 pipes (67 TFLOP/s), not the tensor cores: the f32 path must be
// IEEE f32 (tests hold it to 2e-4), and wgmma/TMA tiles are later work.
//
// Design: one 256-thread block per (batch, head, 64-query tile). The
// TPU's sequential key axis becomes a loop inside the block over 64-key
// tiles between the first and last tile the masks can reach. Per tile:
//   1. K^T is staged in shared memory (f32), Q^T stays there all along;
//   2. each thread computes a 4x4 tile of S = Q K^T * scale and masks it
//      (-inf), writing it transposed to shared memory;
//   3. four threads per query row reduce the row's max and sum with warp
//      shuffles and turn S into P = exp(S - m_new); while they do, V
//      replaces K in the same buffer;
//   4. each thread rescales its 4 x D/16 slice of the accumulator by
//      alpha = exp(m_prev - m_new) and adds P V.
// Fully masked rows: m stays -inf, exp is taken against 0, so P and l
// stay 0 and the row's output is 0 (the TPU kernel's l == 0 rule; the
// JAX oracle would give NaN). Ragged Sq and Skv are masked, not padded by
// the caller: every shape reaches this kernel. Q, K and V are read
// through strides (the last axis contiguous), so the model's
// [B, S, H, D] projections need no copy.
#include "common.cuh"

#include <cuda_bf16.h>

#include <cmath>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int QPAD = BQ + 4;  // keeps float4 alignment, spreads banks
constexpr int KPAD = BK + 4;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

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

template <typename T, int D>
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

  const T* qg = static_cast<const T*>(p.q) + bb * p.qs[0] + hh * p.qs[1];
  const T* kg = static_cast<const T*>(p.k) + bb * p.ks[0] + hk * p.ks[1];
  const T* vg = static_cast<const T*>(p.v) + bb * p.vs[0] + hk * p.vs[1];

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D;
    const int d = e % D;
    qs[d * QPAD + r] =
        (q0 + r < p.sq) ? load_f(qg + (q0 + r) * p.qs[2] + d) : 0.f;
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
          (k0 + j < p.skv) ? load_f(kg + (k0 + j) * p.ks[2] + d) : 0.f;
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
          (k0 + j < p.skv) ? load_f(vg + (k0 + j) * p.vs[2] + d) : 0.f;
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

  T* og = static_cast<T*>(p.out) + (static_cast<long long>(bb) * p.h + hh) *
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
      store_f(og + static_cast<long long>(q0 + r) * D + tx * S::CD + c,
              inv * (acc[i][c] / denom));
  }
}

template <typename T, int D>
int launch_d(const Params& p, int batch, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<D>::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.sq + BQ - 1) / BQ, p.h, batch);
  kernel<<<grid, THREADS, Smem<D>::BYTES, stream>>>(p);
  REPRO_LAUNCH_RESULT();
}

template <typename T>
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
    case 16: return launch_d<T, 16>(p, batch, s);  // the CPU-test config
    case 64: return launch_d<T, 64>(p, batch, s);
    case 128: return launch_d<T, 128>(p, batch, s);  // qwen3-1.7b
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* out,
                                   const long long* qs, const long long* ks,
                                   const long long* vs, int batch, int h,
                                   int hkv, int sq, int skv, int d, int causal,
                                   int window, float scale, void* stream) {
  return launch<float>(q, k, v, out, qs, ks, vs, batch, h, hkv, sq, skv, d,
                       causal, window, scale, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out,
                                    const long long* qs, const long long* ks,
                                    const long long* vs, int batch, int h,
                                    int hkv, int sq, int skv, int d,
                                    int causal, int window, float scale,
                                    void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, qs, ks, vs, batch, h, hkv, sq,
                               skv, d, causal, window, scale, stream);
}

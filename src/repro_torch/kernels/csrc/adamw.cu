// Multi-tensor AdamW: the train step's optimizer update over every leaf of
// the parameter tree, in three launches whatever the number of leaves.
//
// Replaces no TPU kernel: the JAX package has no Pallas kernel for AdamW.
// Under jit, XLA fused src/repro/optim/adamw.py's update into one loop
// over the leaves. The port's eager version (optim/adamw.py, kept as the
// plain version for CPU leaves and DTensors) lost that fusion: about 23
// elementwise launches a leaf, each writing a full f32 intermediate.
//
// What bounds it on an H100: bytes. The norm pass reads g; the update
// reads g, m, v and p (2 + 4 + 4 + 2) and writes p, m and v (2 + 4 + 4).
// With bf16 parameters and gradients and f32 state that is 2 + 22 = 24
// bytes a parameter, a handful of f32 operations each: far below the
// card's 295 operations a byte.
//
// Design: the wrapper hands one table of leaves in device memory (seven
// pointers, the element count and the dtypes of each leaf) and the first
// chunk of each leaf (a prefix sum, one entry past the last leaf). Every
// leaf is cut into chunks of `chunk` elements (kernels/adamw.py's CHUNK,
// a multiple of VEC); one block takes one chunk and finds its leaf by a
// binary search of the prefix sum, so the grid
// covers every leaf in one launch. A thread moves VEC = 8 elements at a
// time with 16-byte loads and stores (two for an f32 operand) where all
// seven pointers of the leaf are 16-byte aligned, and one element at a
// time for the ragged tail of a leaf or an unaligned leaf. Loads and
// stores carry the streaming hint (each byte is touched once).
//
// The global norm needs every gradient before any update, so it is a
// pass of its own: adamw_norm_chunks writes each chunk's f64 sum of the
// f32 squares to a scratch array, and adamw_norm_leaves sums each leaf's
// chunks in order, one warp a leaf. No float atomics: the order is fixed,
// so the same inputs give the same bits on every call (RecoverableTrainer
// replays a step and expects its bits). The wrapper takes the f32 leaf
// sums on with PyTorch's 0-d operations (the norm, the clip scale, the
// bias corrections and the learning rate) into a four-float array that
// adamw_update reads on the device: nothing goes back to the host.
//
// Numerics: adamw_update gives the eager loop's bits for the same
// scalars. Every operation is one of the loop's PyTorch launches, in its
// order and rounded as it rounds: the clip g * scale.to(g.dtype) in g's
// dtype, then m' = m·b1 + g·(1−b1), v' = v·b2 + g²·(1−b2),
// step = (m'/bc1) / (sqrt(v'/bc2) + eps) + wd·p, p' = p − lr·step in f32,
// each product, sum, quotient and root rounded on its own with the _rn
// intrinsics, which nvcc never contracts into an FMA; Python's scalars
// (b1, 1 − b1, eps, wd, ...) arrive rounded to f32, as PyTorch rounds a
// scalar operand. p' is rounded to p's dtype, m' and v' to the state's.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;

// One leaf as the wrapper lays it out: 9 words.
struct Leaf {
  const void* g;
  const void* m;
  const void* v;
  const void* p;
  void* p_out;
  void* m_out;
  void* v_out;
  long long n;
  long long dtypes;  // bit 0: g is bf16, bit 1: p is bf16, bit 2: m, v are bf16
};

// The leaf whose chunks hold chunk c: the last l with first[l] <= c
// (first has n_leaves + 1 entries; empty leaves share their start).
__device__ __forceinline__ int leaf_of(const long long* __restrict__ first,
                                       int n_leaves, long long c) {
  int lo = 0, hi = n_leaves;  // first[lo] <= c < first[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (first[mid] <= c) lo = mid; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back: what a PyTorch result of dtype T holds
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// VEC elements from a 16-byte aligned address, as floats
__device__ __forceinline__ void load_vec(const float* src, float* out) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(src));
  const float4 b = __ldcs(reinterpret_cast<const float4*>(src) + 1);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* src,
                                         float* out) {
  const uint4 u = __ldcs(reinterpret_cast<const uint4*>(src));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // a bf16 is the top half of the f32 with the same bits
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store_vec(float* dst, const float* in) {
  __stcs(reinterpret_cast<float4*>(dst), make_float4(in[0], in[1], in[2], in[3]));
  __stcs(reinterpret_cast<float4*>(dst) + 1,
         make_float4(in[4], in[5], in[6], in[7]));
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* dst, const float* in) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(in[2 * i]));
    const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(in[2 * i + 1]));
    w[i] = lo | (hi << 16);
  }
  __stcs(reinterpret_cast<uint4*>(dst), make_uint4(w[0], w[1], w[2], w[3]));
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Sum of a block's values in a fixed order: each warp by xor shuffles,
// then thread 0 over the warps in order. Returns the sum on thread 0.
__device__ __forceinline__ double block_sum(double x) {
  __shared__ double warp_sums[THREADS / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = x;
  __syncthreads();
  double total = 0.0;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) total += warp_sums[w];
  }
  return total;
}

// ---------------------------------------------------------------------------
// the norm: f64 sum of the f32 squares of each chunk of g

template <typename G>
__device__ double chunk_squares(const G* __restrict__ g, long long len,
                                bool vec) {
  double acc = 0.0;
  long long tail = 0;
  if (vec) {
    const long long groups = len / VEC;
    for (long long j = threadIdx.x; j < groups; j += THREADS) {
      float x[VEC];
      load_vec(g + j * VEC, x);
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) s = __fadd_rn(s, __fmul_rn(x[i], x[i]));
      acc += static_cast<double>(s);
    }
    tail = groups * VEC;
  }
  for (long long i = tail + threadIdx.x; i < len; i += THREADS) {
    const float x = to_float(g[i]);
    acc += static_cast<double>(__fmul_rn(x, x));
  }
  return acc;
}

__global__ void __launch_bounds__(THREADS)
    adamw_norm_chunks_kernel(const Leaf* __restrict__ leaves,
                             const long long* __restrict__ first,
                             int n_leaves, long long chunk,
                             double* __restrict__ partial) {
  const long long c = blockIdx.x;
  const int l = leaf_of(first, n_leaves, c);
  const Leaf& leaf = leaves[l];
  const long long base = (c - first[l]) * chunk;
  const long long len = min(chunk, leaf.n - base);
  const bool vec = aligned16(leaf.g);
  const double s =
      (leaf.dtypes & 1)
          ? chunk_squares(static_cast<const __nv_bfloat16*>(leaf.g) + base,
                          len, vec)
          : chunk_squares(static_cast<const float*>(leaf.g) + base, len, vec);
  const double total = block_sum(s);
  if (threadIdx.x == 0) partial[c] = total;
}

// One warp a leaf: its chunks' sums in order, as f32.
__global__ void adamw_norm_leaves_kernel(const long long* __restrict__ first,
                                         int n_leaves,
                                         const double* __restrict__ partial,
                                         float* __restrict__ sums) {
  const int l = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (l >= n_leaves) return;  // a whole warp leaves together
  double acc = 0.0;
  for (long long c = first[l] + lane; c < first[l + 1]; c += 32)
    acc += partial[c];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) sums[l] = static_cast<float>(acc);
}

// ---------------------------------------------------------------------------
// the update

struct Scalars {
  float scale, bc1, bc2, lr;  // on the device, worked out by the wrapper
  float b1, one_minus_b1, b2, one_minus_b2, eps, wd;
};

// One element, as optim/adamw.py's loop computes it; g is read as G,
// returned as the f32 value of the clipped gradient in G.
template <typename G>
__device__ __forceinline__ void adamw_element(float g, float m, float v,
                                              float p, const Scalars& s,
                                              float scale_g, float& p_out,
                                              float& m_out, float& v_out) {
  const float gc = round_to<G>(__fmul_rn(g, scale_g));
  const float mf = __fadd_rn(__fmul_rn(m, s.b1), __fmul_rn(gc, s.one_minus_b1));
  const float vf = __fadd_rn(__fmul_rn(v, s.b2),
                             __fmul_rn(__fmul_rn(gc, gc), s.one_minus_b2));
  const float mhat = __fdiv_rn(mf, s.bc1);
  const float vhat = __fdiv_rn(vf, s.bc2);
  const float step = __fadd_rn(
      __fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), s.eps)), __fmul_rn(s.wd, p));
  p_out = __fsub_rn(p, __fmul_rn(s.lr, step));
  m_out = mf;
  v_out = vf;
}

template <typename G, typename P, typename S>
__device__ void update_chunk(const Leaf& leaf, long long base, long long len,
                             const Scalars& s) {
  const G* g = static_cast<const G*>(leaf.g) + base;
  const S* m = static_cast<const S*>(leaf.m) + base;
  const S* v = static_cast<const S*>(leaf.v) + base;
  const P* p = static_cast<const P*>(leaf.p) + base;
  P* p_out = static_cast<P*>(leaf.p_out) + base;
  S* m_out = static_cast<S*>(leaf.m_out) + base;
  S* v_out = static_cast<S*>(leaf.v_out) + base;
  // g * scale.to(g.dtype): the scale as g's dtype holds it
  const float scale_g = round_to<G>(s.scale);
  long long tail = 0;
  if (aligned16(leaf.g) && aligned16(leaf.m) && aligned16(leaf.v) &&
      aligned16(leaf.p) && aligned16(leaf.p_out) && aligned16(leaf.m_out) &&
      aligned16(leaf.v_out)) {
    const long long groups = len / VEC;
    for (long long j = threadIdx.x; j < groups; j += THREADS) {
      const long long at = j * VEC;
      float gx[VEC], mx[VEC], vx[VEC], px[VEC];
      load_vec(g + at, gx);
      load_vec(m + at, mx);
      load_vec(v + at, vx);
      load_vec(p + at, px);
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        adamw_element<G>(gx[i], mx[i], vx[i], px[i], s, scale_g, px[i], mx[i],
                         vx[i]);
      store_vec(p_out + at, px);
      store_vec(m_out + at, mx);
      store_vec(v_out + at, vx);
    }
    tail = groups * VEC;
  }
  for (long long i = tail + threadIdx.x; i < len; i += THREADS) {
    float po, mo, vo;
    adamw_element<G>(to_float(g[i]), to_float(m[i]), to_float(v[i]),
                     to_float(p[i]), s, scale_g, po, mo, vo);
    p_out[i] = from_float<P>(po);
    m_out[i] = from_float<S>(mo);
    v_out[i] = from_float<S>(vo);
  }
}

template <typename G, typename P>
__device__ __forceinline__ void update_chunk_s(const Leaf& leaf, long long base,
                                               long long len, const Scalars& s) {
  if (leaf.dtypes & 4)
    update_chunk<G, P, __nv_bfloat16>(leaf, base, len, s);
  else
    update_chunk<G, P, float>(leaf, base, len, s);
}

template <typename G>
__device__ __forceinline__ void update_chunk_p(const Leaf& leaf, long long base,
                                               long long len, const Scalars& s) {
  if (leaf.dtypes & 2)
    update_chunk_s<G, __nv_bfloat16>(leaf, base, len, s);
  else
    update_chunk_s<G, float>(leaf, base, len, s);
}

__global__ void __launch_bounds__(THREADS)
    adamw_update_kernel(const Leaf* __restrict__ leaves,
                        const long long* __restrict__ first, int n_leaves,
                        long long chunk, const float* __restrict__ device_scalars,
                        Scalars s) {
  const long long c = blockIdx.x;
  const int l = leaf_of(first, n_leaves, c);
  const Leaf& leaf = leaves[l];
  const long long base = (c - first[l]) * chunk;
  const long long len = min(chunk, leaf.n - base);
  s.scale = device_scalars[0];
  s.bc1 = device_scalars[1];
  s.bc2 = device_scalars[2];
  s.lr = device_scalars[3];
  // the branch is the same for the whole block: no divergence
  if (leaf.dtypes & 1)
    update_chunk_p<__nv_bfloat16>(leaf, base, len, s);
  else
    update_chunk_p<float>(leaf, base, len, s);
}

}  // namespace

extern "C" int adamw_norm_chunks(const void* leaves, const void* first,
                                 int n_leaves, long long chunk,
                                 long long n_chunks, void* partial,
                                 void* stream) {
  adamw_norm_chunks_kernel<<<static_cast<unsigned>(n_chunks), THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Leaf*>(leaves), static_cast<const long long*>(first),
      n_leaves, chunk, static_cast<double*>(partial));
  REPRO_LAUNCH_RESULT();
}

extern "C" int adamw_norm_leaves(const void* first, int n_leaves,
                                 const void* partial, void* sums,
                                 void* stream) {
  constexpr int threads = 128;  // four leaves a block
  const int blocks = (n_leaves * 32 + threads - 1) / threads;
  adamw_norm_leaves_kernel<<<blocks, threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(first), n_leaves,
      static_cast<const double*>(partial), static_cast<float*>(sums));
  REPRO_LAUNCH_RESULT();
}

extern "C" int adamw_update(const void* leaves, const void* first,
                            int n_leaves, long long chunk, long long n_chunks,
                            const void* device_scalars, float b1,
                            float one_minus_b1, float b2, float one_minus_b2,
                            float eps, float wd, void* stream) {
  Scalars s{0.f, 0.f, 0.f, 0.f, b1, one_minus_b1, b2, one_minus_b2, eps, wd};
  adamw_update_kernel<<<static_cast<unsigned>(n_chunks), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Leaf*>(leaves), static_cast<const long long*>(first),
      n_leaves, chunk, static_cast<const float*>(device_scalars), s);
  REPRO_LAUNCH_RESULT();
}

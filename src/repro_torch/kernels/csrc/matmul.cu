// C = A * B for row-major f32 or bf16 matrices, accumulated in f32 and
// cast to A's type.
//
// Replaces the JAX package's kernels/matmul.py::pallas_matmul (body
// _matmul_kernel): 128x128x128 VMEM tiles fed to the TPU's matrix unit,
// with the f32 accumulator carried in scratch across the sequential K
// grid axis.
//
// What bounds it on an H100: at the main path's 4096^3 the product does
// 2*M*N*K = 137 GFLOP against 201 MB of operands, far above the card's
// ridge point, so it is bound by operations. The f32 contract is IEEE
// f32 (tests hold it to 2e-5), which rules out TF32 tensor cores: the
// ceiling is the 67 TFLOP/s of the SIMT f32 pipes.
//
// Design: a classic shared-memory tiled SIMT kernel. Each 256-thread
// block owns a 128x128 tile of C and walks K in steps of 8; each thread
// keeps an 8x8 tile of C in registers (64 FMAs per 16 shared-memory reads
// per K step), which takes the kernel off the shared-memory bandwidth
// limit. A is stored transposed in shared memory so the inner loop reads
// both operands as float4. The TPU's sequential-K carry becomes the
// in-block K loop. Ragged edges are masked on load (zero fill) and on
// store, so any M, N, K is accepted and no shape needs another path.
// bf16 inputs are widened with __bfloat162float on load; wgmma/TMA tiles
// are later work.
#include "common.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 8;
constexpr int TM = 8;
constexpr int TN = 8;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int APAD = 4;                          // keeps float4 alignment

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    matmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  T* __restrict__ c, int m, int n, int k) {
  __shared__ __align__(16) float as[BK][BM + APAD];  // A tile, transposed
  __shared__ __align__(16) float bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += BK) {
#pragma unroll
    for (int i = 0; i < (BM * BK) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / BK;
      const int cc = e % BK;
      const int gr = row0 + r;
      const int gc = k0 + cc;
      as[cc][r] = (gr < m && gc < k) ? load_f(a + (size_t)gr * k + gc) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < (BK * BN) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / BN;
      const int cc = e % BN;
      const int gr = k0 + r;
      const int gc = col0 + cc;
      bs[r][cc] = (gr < k && gc < n) ? load_f(b + (size_t)gr * n + gc) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM];
      float bv[TN];
      const float4 a0 = *reinterpret_cast<const float4*>(&as[kk][ty * TM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[kk][ty * TM + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[kk][tx * TN]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[kk][tx * TN + 4]);
      av[0] = a0.x; av[1] = a0.y; av[2] = a0.z; av[3] = a0.w;
      av[4] = a1.x; av[5] = a1.y; av[6] = a1.z; av[7] = a1.w;
      bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
      bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = col0 + tx * TN + j;
      if (col < n) store_f(c + (size_t)r * n + col, acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, void* c, int m, int n, int k,
           void* stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  matmul_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      m, n, k);
  REPRO_LAUNCH_RESULT();
}

}  // namespace

extern "C" int matmul_f32(const void* a, const void* b, void* c, int m, int n,
                          int k, void* stream) {
  return launch<float>(a, b, c, m, n, k, stream);
}

extern "C" int matmul_bf16(const void* a, const void* b, void* c, int m, int n,
                           int k, void* stream) {
  return launch<__nv_bfloat16>(a, b, c, m, n, k, stream);
}

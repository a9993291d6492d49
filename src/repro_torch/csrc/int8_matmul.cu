// W8A8 GEMM for Hopper (sm_90a): out[m][n] = float(sum_k x[m][k] * w[k][n])
// * x_scale[m] * w_scale[n], cast to fp32, bf16 or fp16.
//
// Replaces the Pallas TPU kernel src/repro/kernels/int8_matmul.py
// (int8_matmul / _kernel), computing what its oracle int8_matmul_ref does:
// the sum is carried in int32 across ALL of K (exact; the Pallas kernel adds
// per-block int32 partials in fp32), and ragged M, N and K are masked
// instead of asserted, because decode runs with M = live batch.
//
// Bound on the H100: at decode (M <= 8) the kernel streams the K x N int8
// weight once and does little arithmetic per byte, so it is bound by bytes
// (device memory at 3.35 TB/s); at prefill (M = 128) by int8 operations.
// Design: a shared-memory tiled product. Each 256-thread block owns a
// 64 x 64 output tile and walks K in 32-deep slices. A slice of x and of w
// is staged in shared memory as int32 words of four K-consecutive int8
// values (w is transposed byte-wise while staging), so each thread's 4 x 4
// outputs advance four K steps per __dp4a. Out-of-range bytes stage as 0,
// which adds nothing to the sum. mma.sync / wgmma tiles and a TMA pipeline
// are later work.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 32, THREADS = 256;
constexpr int BK4 = BK / 4;

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store_out(__half* p, float v) {
  *p = __float2half(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    int8_matmul_kernel(const int8_t* __restrict__ x,
                       const float* __restrict__ xs,
                       const int8_t* __restrict__ w,
                       const float* __restrict__ ws, T* __restrict__ out,
                       int M, int N, int K) {
  // k-major so that threads of a warp read neighbouring words
  __shared__ int As[BK4][BM];
  __shared__ int Bs[BK4][BN];
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = t; i < BK4 * BM; i += THREADS) {
      const int m = i % BM, k4 = i / BM;
      const int gm = m0 + m, gk = k0 + k4 * 4;
      unsigned word = 0;
      if (gm < M) {
        const int8_t* row = x + (size_t)gm * K;
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (gk + b < K) word |= (unsigned)(uint8_t)row[gk + b] << (8 * b);
      }
      As[k4][m] = (int)word;
    }
    for (int i = t; i < BK4 * BN; i += THREADS) {
      const int n = i % BN, k4 = i / BN;
      const int gn = n0 + n, gk = k0 + k4 * 4;
      unsigned word = 0;
      if (gn < N) {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (gk + b < K)
            word |= (unsigned)(uint8_t)w[(size_t)(gk + b) * N + gn] << (8 * b);
      }
      Bs[k4][n] = (int)word;
    }
    __syncthreads();
#pragma unroll
    for (int k4 = 0; k4 < BK4; ++k4) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k4][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k4][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N)
        store_out(out + (size_t)m * N + n, (float)acc[i][j] * xs[m] * ws[n]);
    }
  }
}

template <typename T>
void launch(const void* x, const void* xs, const void* w, const void* ws,
            void* out, int M, int N, int K, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_matmul_kernel<T><<<grid, THREADS, 0, stream>>>(
      (const int8_t*)x, (const float*)xs, (const int8_t*)w, (const float*)ws,
      (T*)out, M, N, K);
}

}  // namespace

// out_dtype: 0 = fp32, 1 = bf16, 2 = fp16. Returns cudaGetLastError().
extern "C" int int8_matmul(const void* x, const void* xs, const void* w,
                           const void* ws, void* out, int M, int N, int K,
                           int out_dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (out_dtype) {
    case 0: launch<float>(x, xs, w, ws, out, M, N, K, s); break;
    case 1: launch<__nv_bfloat16>(x, xs, w, ws, out, M, N, K, s); break;
    case 2: launch<__half>(x, xs, w, ws, out, M, N, K, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

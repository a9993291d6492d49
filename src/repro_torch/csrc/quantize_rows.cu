// Symmetric int8 quantisation of the rows of x (M, K), fp32, bf16 or fp16,
// for Hopper (sm_90a), and the gradient that reaches x from the scales:
//   s[m] = max(max_k |x[m][k]|, 1e-8) / 127,
//   q[m][k] = clamp(rint(x[m][k] / s[m]), -127, 127),
// in fp32 with IEEE division and rounding half to even: bit for bit the
// plain version, quantize_rowwise (kernels/ref.py), for finite x. The
// backward takes d s[m] to d x[m][k] with the rules autograd applies
// through those ops, op for op (kernels/quantize_rows.py
// quantize_rows_backward_plain): with a the row's largest magnitude and c
// the number of entries that reach it,
//   d x = (((a >= 1e-8 ? d s / 127 : 0) / c) * [|x| == a]) * sgn(x);
// q and the int8 cast have zero derivative.
//
// The JAX package computes this with jnp ops (src/repro/kernels/ref.py
// quantize_rowwise), which XLA fuses into the int8 product's producers and
// differentiates; it has no Pallas kernel. Eager PyTorch runs the forward
// as ten launches and the backward as a dozen, each a pass over the tensor
// and a round of the host's dispatcher, and the int8 rungs pay that on
// every product. Here each is one.
//
// Bound by bytes: x is read once and q (or d x) written once (the second
// read of a row comes from L1 / L2). One block a row: its threads take the
// row's elements in turn (neighbouring threads on neighbouring elements),
// reduce the largest magnitude (the same in any order) and, backward, the
// count of entries that reach it, through warp shuffles and shared memory.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void from_f(__half* p, float v) {
  *p = __float2half(v);
}

// The largest |x| of the block's row; every thread gets it.
template <typename T>
__device__ float row_amax(const T* __restrict__ row, int K, float* part) {
  float amax = 0.f;
  for (int k = threadIdx.x; k < K; k += THREADS)
    amax = fmaxf(amax, fabsf(to_f(row[k])));
#pragma unroll
  for (int o = 16; o > 0; o /= 2)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = amax;
  __syncthreads();
  amax = part[0];
#pragma unroll
  for (int w = 1; w < THREADS / 32; ++w) amax = fmaxf(amax, part[w]);
  return amax;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                         float* __restrict__ s, int K) {
  __shared__ float part[THREADS / 32];
  const T* row = x + (size_t)blockIdx.x * K;
  const float amax = row_amax(row, K, part);
  const float scale = (amax < 1e-8f ? 1e-8f : amax) / 127.f;
  if (threadIdx.x == 0) s[blockIdx.x] = scale;
  int8_t* qrow = q + (size_t)blockIdx.x * K;
  for (int k = threadIdx.x; k < K; k += THREADS) {
    const float v = rintf(to_f(row[k]) / scale);
    qrow[k] = (int8_t)fminf(fmaxf(v, -127.f), 127.f);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    quantize_rows_backward_kernel(const T* __restrict__ x,
                                  const float* __restrict__ ds,
                                  T* __restrict__ dx, int K) {
  __shared__ float part[THREADS / 32];
  __shared__ int counts[THREADS / 32];
  const T* row = x + (size_t)blockIdx.x * K;
  const float amax = row_amax(row, K, part);
  int c = 0;
  for (int k = threadIdx.x; k < K; k += THREADS)
    c += fabsf(to_f(row[k])) == amax;
#pragma unroll
  for (int o = 16; o > 0; o /= 2) c += __shfl_xor_sync(0xffffffffu, c, o);
  if (threadIdx.x % 32 == 0) counts[threadIdx.x / 32] = c;
  __syncthreads();
  c = 0;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) c += counts[w];
  const float g = (amax >= 1e-8f ? ds[blockIdx.x] / 127.f : 0.f) / (float)c;
  T* drow = dx + (size_t)blockIdx.x * K;
  for (int k = threadIdx.x; k < K; k += THREADS) {
    const float v = to_f(row[k]);
    const float hit = fabsf(v) == amax ? 1.f : 0.f;
    const float sgn = (float)((0.f < v) - (v < 0.f));
    from_f(drow + k, (g * hit) * sgn);
  }
}

template <typename T>
void launch(const void* x, void* q, void* s, int M, int K,
            cudaStream_t stream) {
  quantize_rows_kernel<T><<<M, THREADS, 0, stream>>>(
      (const T*)x, (int8_t*)q, (float*)s, K);
}

template <typename T>
void launch_backward(const void* x, const void* ds, void* dx, int M, int K,
                     cudaStream_t stream) {
  quantize_rows_backward_kernel<T><<<M, THREADS, 0, stream>>>(
      (const T*)x, (const float*)ds, (T*)dx, K);
}

}  // namespace

// x (M, K) -> q (M, K) int8, s (M) fp32. x_dtype: 0 = fp32, 1 = bf16,
// 2 = fp16. Returns cudaGetLastError() of the launch.
extern "C" int quantize_rows(const void* x, void* q, void* s, int M, int K,
                             int x_dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (x_dtype) {
    case 0: launch<float>(x, q, s, M, K, st); break;
    case 1: launch<__nv_bfloat16>(x, q, s, M, K, st); break;
    case 2: launch<__half>(x, q, s, M, K, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// x (M, K), ds (M) fp32 (the gradient of s) -> dx (M, K) in x's dtype.
extern "C" int quantize_rows_backward(const void* x, const void* ds, void* dx,
                                      int M, int K, int x_dtype,
                                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (x_dtype) {
    case 0: launch_backward<float>(x, ds, dx, M, K, st); break;
    case 1: launch_backward<__nv_bfloat16>(x, ds, dx, M, K, st); break;
    case 2: launch_backward<__half>(x, ds, dx, M, K, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

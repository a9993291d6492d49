// Fused paged-attention decode for Hopper (sm_90a): one query token per
// batch slot attends over its block table's K/V pages in place.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py
// (paged_attention_impl / _kernel) and computes what _kernel computes: a
// page is skipped when its physical id is 0, when it starts past the query
// position, or (window > 0) when it lies wholly below the window band;
// entries are masked by the page's ppos row (-1 empty, future, out of
// window) after the optional softcap; the softmax is online in fp32, int8
// K/V are dequantised by kv_scale in the kernel, and a slot whose pages were
// all skipped writes zeros (acc / max(l, 1e-30)).
//
// Bound on the H100: decode attention reads every live page's K and V once
// and does ~4 flops per byte, so it is bound by bytes (device memory at
// 3.35 TB/s). Design: one 128-thread block per (slot b, KV head g); the
// Pallas sequential page axis becomes a loop inside the block. Each block
// loads its own block-table row and position, stages the page's K and V
// slice for head g in shared memory as fp32 (dequantising int8 there), so
// each byte is read from device memory once per (slot, head), computes the
// R x P scores with one warp per score and shuffle reductions, and folds the
// page into the online softmax with the accumulator in registers: thread t
// owns dims t and t + 128 of every one of the R rows. Pages stream without
// double buffering; cp.async / TMA staging and splitting long tables across
// blocks are later work.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int R_MAX = 16;              // query heads per KV head
constexpr int D_PER = 2;               // head dim <= THREADS * D_PER = 256
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store_out(__half* p, float v) {
  *p = __float2half(v);
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(THREADS) paged_attention_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ kp,
    const TKV* __restrict__ vp, const int* __restrict__ ppos,
    const int* __restrict__ block, const int* __restrict__ position,
    TQ* __restrict__ out, int G, int R, int hd, int P, int M, int window,
    float kv_scale, float cap, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;                    // R * hd
  float* k_s = q_s + R * hd;            // P * hd
  float* v_s = k_s + P * hd;            // P * hd
  float* s_s = v_s + P * hd;            // R * P
  int* pp_s = (int*)(s_s + R * P);      // P
  const int b = blockIdx.x, g = blockIdx.y;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int pos = position[b];
  const TQ* qb = q + (size_t)(b * G + g) * R * hd;
  for (int i = t; i < R * hd; i += THREADS) q_s[i] = to_f(qb[i]);

  float m_r[R_MAX], l_r[R_MAX], acc[R_MAX][D_PER];
#pragma unroll
  for (int r = 0; r < R_MAX; ++r) {
    m_r[r] = NEG_INF;
    l_r[r] = 0.f;
#pragma unroll
    for (int e = 0; e < D_PER; ++e) acc[r][e] = 0.f;
  }

  for (int m = 0; m < M; ++m) {
    const int pid = block[b * M + m];
    bool run = pid != 0 && m * P <= pos;
    if (window) run = run && (m + 1) * P - 1 > pos - window;
    if (!run) continue;                 // uniform across the block
    __syncthreads();                    // previous page's readers are done
    const size_t base = (size_t)pid * P * G * hd + (size_t)g * hd;
    for (int i = t; i < P * hd; i += THREADS) {
      const int p = i / hd, d = i - p * hd;
      const size_t off = base + (size_t)p * G * hd + d;
      float kv = to_f(kp[off]), vv = to_f(vp[off]);
      if (kv_scale != 0.f) {
        kv *= kv_scale;
        vv *= kv_scale;
      }
      k_s[i] = kv;
      v_s[i] = vv;
    }
    for (int i = t; i < P; i += THREADS) pp_s[i] = ppos[(size_t)pid * P + i];
    __syncthreads();
    for (int idx = warp; idx < R * P; idx += THREADS / 32) {
      const int r = idx / P, p = idx - r * P;
      float sum = 0.f;
      for (int d = lane; d < hd; d += 32) sum += q_s[r * hd + d] * k_s[p * hd + d];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        float s = sum * scale;
        if (cap != 0.f) s = cap * tanhf(s / cap);
        const int kvp = pp_s[p];
        bool valid = kvp >= 0 && kvp <= pos;
        if (window) valid = valid && kvp > pos - window;
        s_s[r * P + p] = valid ? s : NEG_INF;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R_MAX; ++r) {
      if (r < R) {
        const float* sr = s_s + r * P;
        float mc = NEG_INF;
        for (int p = 0; p < P; ++p) mc = fmaxf(mc, sr[p]);
        const float mn = fmaxf(m_r[r], mc);
        const float alpha = expf(m_r[r] - mn);
        float lsum = 0.f, a[D_PER];
#pragma unroll
        for (int e = 0; e < D_PER; ++e) a[e] = 0.f;
        for (int p = 0; p < P; ++p) {
          const float pe = expf(sr[p] - mn);
          lsum += pe;
#pragma unroll
          for (int e = 0; e < D_PER; ++e) {
            const int d = t + e * THREADS;
            if (d < hd) a[e] += pe * v_s[p * hd + d];
          }
        }
        l_r[r] = l_r[r] * alpha + lsum;
        m_r[r] = mn;
#pragma unroll
        for (int e = 0; e < D_PER; ++e) acc[r][e] = acc[r][e] * alpha + a[e];
      }
    }
  }
  TQ* ob = out + (size_t)(b * G + g) * R * hd;
#pragma unroll
  for (int r = 0; r < R_MAX; ++r) {
    if (r < R) {
      const float l = fmaxf(l_r[r], 1e-30f);
#pragma unroll
      for (int e = 0; e < D_PER; ++e) {
        const int d = t + e * THREADS;
        if (d < hd) store_out(ob + r * hd + d, acc[r][e] / l);
      }
    }
  }
}

size_t smem_bytes(int R, int hd, int P) {
  return sizeof(float) * ((size_t)R * hd + 2 * (size_t)P * hd + (size_t)R * P)
         + sizeof(int) * (size_t)P;
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* kp, const void* vp, const int* ppos,
           const int* block, const int* position, void* out, int B, int G,
           int R, int hd, int P, int M, int window, float kv_scale, float cap,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(R, hd, P);
  auto kernel = paged_attention_kernel<TQ, TKV>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3(B, G), THREADS, smem, stream>>>(
      (const TQ*)q, (const TKV*)kp, (const TKV*)vp, ppos, block, position,
      (TQ*)out, G, R, hd, P, M, window, kv_scale, cap, scale);
  return (int)cudaGetLastError();
}

template <typename TQ>
int launch_kv(int kv_dtype, const void* q, const void* kp, const void* vp,
              const int* ppos, const int* block, const int* position,
              void* out, int B, int G, int R, int hd, int P, int M,
              int window, float kv_scale, float cap, float scale,
              cudaStream_t s) {
  switch (kv_dtype) {
    case 0: return launch<TQ, float>(q, kp, vp, ppos, block, position, out, B, G, R, hd, P, M, window, kv_scale, cap, scale, s);
    case 1: return launch<TQ, __nv_bfloat16>(q, kp, vp, ppos, block, position, out, B, G, R, hd, P, M, window, kv_scale, cap, scale, s);
    case 2: return launch<TQ, __half>(q, kp, vp, ppos, block, position, out, B, G, R, hd, P, M, window, kv_scale, cap, scale, s);
    case 3: return launch<TQ, int8_t>(q, kp, vp, ppos, block, position, out, B, G, R, hd, P, M, window, kv_scale, cap, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = fp32, 1 = bf16, 2 = fp16, 3 = int8 (K/V only).
// Returns the launch's cudaGetLastError().
extern "C" int paged_attention(const void* q, const void* kp, const void* vp,
                               const void* ppos, const void* block,
                               const void* position, void* out, int B, int G,
                               int R, int hd, int P, int M, int window,
                               float kv_scale, float cap, float scale,
                               int q_dtype, int kv_dtype, void* stream) {
  if (R < 1 || R > R_MAX || hd < 1 || hd > THREADS * D_PER)
    return (int)cudaErrorInvalidValue;
  const int* pp = (const int*)ppos;
  const int* bl = (const int*)block;
  const int* po = (const int*)position;
  cudaStream_t s = (cudaStream_t)stream;
  switch (q_dtype) {
    case 0: return launch_kv<float>(kv_dtype, q, kp, vp, pp, bl, po, out, B, G, R, hd, P, M, window, kv_scale, cap, scale, s);
    case 1: return launch_kv<__nv_bfloat16>(kv_dtype, q, kp, vp, pp, bl, po, out, B, G, R, hd, P, M, window, kv_scale, cap, scale, s);
    case 2: return launch_kv<__half>(kv_dtype, q, kp, vp, pp, bl, po, out, B, G, R, hd, P, M, window, kv_scale, cap, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Blocked online-softmax (flash) attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention / _kernel). q (B,H,Sq,hd) attends over k, v
// (B,KVH,Skv,hd); q head h reads KV head h / (H / KVH). Positions are
// start-aligned: query row r at r, key column c at c. Scores
// s = (q . k) * scale, optionally cap * tanh(s / cap), masked (causal
// kpos <= qpos, window kpos > qpos - window, the KV tail kpos < Skv) to
// -1e30; softmax and accumulation in fp32, p rounded to the input dtype
// before P.V, the output stored in the input dtype.
//
// The Pallas kernel walks a (bq, bk) grid and skips block (i, j) unless
//   causal: j*bk < (i+1)*bq;  window: i*bq - (j+1)*bk < window;
//   stride: i*bq - j*bk <= 2*bq || (i - j*bk/bq) % stride == 0.
// This kernel evaluates that rule for every entry on the caller's (bq, bk)
// grid, whatever its own tiles are: an entry of a skipped block is left out
// (score -inf, p = 0), a masked entry of a running block takes -1e30 and so
// contributes exp(-1e30 - m), 1 while its row's max is still -1e30, as in
// the Pallas body (the KV tail up to the padded grid counts, with V = 0).
//
// Bound on the H100: fp32 operations at the training shape. A causal
// (batch, head) of S = 4096, hd = 128 needs ~4.3 GFLOP (Q.K^T and P.V over
// the lower triangle) against 4 MB of q, k, v and o: far above the card's
// fp32 ridge of ~20 FLOP/byte. Design (simple and right first): one block
// of 256 threads per (query tile of 64 rows, head, batch), the heaviest
// causal tiles launched first. The block keeps its Q tile transposed in
// shared memory and walks the keys in tiles of 64: K is staged transposed,
// each thread computes a 4 x 4 register tile of scores (its 4 rows x 4
// keys, two float4 loads feed 16 FMAs), the rows' online-softmax state
// (max, sum) lives in the registers of the 16 threads that share a row and
// is combined by warp shuffles, p goes to shared memory, then V is staged
// into the same buffer and each thread accumulates its 4 rows x hd/16
// columns of the output in registers. Tiles with no kept entry are skipped
// unless a row still at -1e30 needs their masked entries. Plain FMAs on the
// CUDA cores; wgmma/TMA tiles, K/V shared by the heads of a GQA group and
// a split over long KV are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // keys per tile
constexpr int THREADS = 256;   // 16 x 16: ty owns rows 4ty.., tx keys 4tx..
constexpr int LD = BQ + 4;     // stride (floats) of the transposed tiles
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// The Pallas kernel's block-skip rule for block (i, j) of the (bq, bk) grid.
__device__ __forceinline__ bool block_runs(int i, int j, int bq, int bk,
                                           int causal, int window,
                                           int stride) {
  bool run = true;
  if (causal) run = run && (j * bk < (i + 1) * bq);
  if (window) run = run && (i * bq - (j + 1) * bk < window);
  if (stride > 1) {
    const bool near = i * bq - j * bk <= 2 * bq;
    run = run && (near || (i - (j * bk) / bq) % stride == 0);
  }
  return run;
}

size_t smem_bytes(int hd) {
  return sizeof(float) * ((size_t)2 * hd * LD + (size_t)BK * LD);
}

// NJ >= hd / 16: the output columns (tx + 16 * jj) each thread owns.
template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int KVH,
                 int Sq, int Skv, int hd, int bq, int bk, int causal,
                 int window, int stride, float cap, float scale,
                 int n_kpad) {
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // hd x LD: Qt[d][r]
  float* KV = Qt + hd * LD;   // K as Kt[d][c] (hd x LD), then V[c][d]
  float* Ps = KV + hd * LD;   // BK x LD: Ps[c][r]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / KVH);
  const int nj = hd >> 4;
  const T* qb = q + (size_t)(b * H + h) * Sq * hd;
  const T* kb = k + (size_t)(b * KVH + g) * Skv * hd;
  const T* vb = v + (size_t)(b * KVH + g) * Skv * hd;

  for (int e = tid; e < BQ * hd; e += THREADS) {
    const int r = e / hd, d = e - r * hd;
    Qt[d * LD + r] = q0 + r < Sq ? load_f(qb + (size_t)(q0 + r) * hd + d)
                                 : 0.f;
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;
  }

  // keys past the causal reach of the tile's last row never run
  int kend = n_kpad;
  if (causal) {
    const int i_last = (min(q0 + BQ, Sq) - 1) / bq;
    kend = min(kend, ((i_last + 1) * bq + bk - 1) / bk * bk);
  }

  for (int k0 = 0; k0 < kend; k0 += BK) {
    // bit 4i+j: entry (row 4ty+i, key 4tx+j) lies in a running block (inc)
    // and survives the mask (keep); rows past Sq are never stored
    unsigned inc = 0, keep = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx * 4 + j;
        if (qp < Sq && kp < n_kpad &&
            block_runs(qp / bq, kp / bk, bq, bk, causal, window, stride)) {
          inc |= 1u << (4 * i + j);
          if (kp < Skv && (!causal || kp <= qp) &&
              (!window || kp > qp - window))
            keep |= 1u << (4 * i + j);
        }
      }
    }
    bool need = keep != 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      need = need || (((inc >> (4 * i)) & 15u) && m[i] == NEG_INF);
    // also the barrier before KV and Ps are overwritten
    if (!__syncthreads_or(need)) continue;

    for (int e = tid; e < BK * hd; e += THREADS) {
      const int c = e / hd, d = e - c * hd;
      KV[d * LD + c] = k0 + c < Skv ? load_f(kb + (size_t)(k0 + c) * hd + d)
                                    : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(Qt + d * LD + ty * 4);
      const float4 ka = *reinterpret_cast<const float4*>(KV + d * LD + tx * 4);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
    }

    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned bit = 1u << (4 * i + j);
        float x;
        if (keep & bit) {
          x = s[i][j] * scale;
          if (cap != 0.f) x = cap * tanhf(x / cap);
        } else {
          x = (inc & bit) ? NEG_INF : -INFINITY;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(s[i][j] - m_new);
        sum += e;
        p[i][j] = round_to(e, vb);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) acc[i][jj] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(Ps + (tx * 4 + j) * LD + ty * 4) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    __syncthreads();  // Kt fully read, Ps written

    for (int e = tid; e < BK * hd; e += THREADS) {
      const int c = e / hd;
      KV[e] = k0 + c < Skv ? load_f(vb + (size_t)k0 * hd + e) : 0.f;
    }
    __syncthreads();

    for (int c = 0; c < BK; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(Ps + c * LD + ty * 4);
      const float* vr = KV + c * hd + tx;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        if (jj < nj) {
          const float vv = vr[16 * jj];
          acc[0][jj] += pa.x * vv;
          acc[1][jj] += pa.y * vv;
          acc[2][jj] += pa.z * vv;
          acc[3][jj] += pa.w * vv;
        }
      }
    }
  }

  T* ob = o + (size_t)(b * H + h) * Sq * hd;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
      if (jj < nj) store_out(ob + (size_t)r * hd + tx + 16 * jj,
                             acc[i][jj] / den);
  }
}

template <typename T, int NJ>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int KVH, int Sq, int Skv, int hd, int bq, int bk,
           int causal, int window, int stride, float cap, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_kpad = (Skv + bk - 1) / bk * bk;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_kernel<T, NJ><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, H, KVH, Sq, Skv, hd, bq,
      bk, causal, window, stride, cap, scale, n_kpad);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int H, int KVH, int Sq, int Skv, int hd, int bq, int bk,
             int causal, int window, int stride, float cap, float scale,
             cudaStream_t s) {
  if (hd <= 64)
    return launch<T, 4>(q, k, v, o, B, H, KVH, Sq, Skv, hd, bq, bk, causal,
                        window, stride, cap, scale, s);
  if (hd <= 128)
    return launch<T, 8>(q, k, v, o, B, H, KVH, Sq, Skv, hd, bq, bk, causal,
                        window, stride, cap, scale, s);
  return launch<T, 16>(q, k, v, o, B, H, KVH, Sq, Skv, hd, bq, bk, causal,
                       window, stride, cap, scale, s);
}

}  // namespace

// dtype (of q, k, v and o): 0 = fp32, 1 = bf16. Needs hd a multiple of 16
// up to 256, H a multiple of KVH, and bq, bk >= 1 (the caller's block grid,
// already clipped to Sq and Skv). Returns cudaGetLastError() of the launch.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int B, int H, int KVH, int Sq,
                               int Skv, int hd, int bq, int bk, int causal,
                               int window, int stride, float cap,
                               float scale, int dtype, void* stream) {
  if (hd <= 0 || hd > 256 || hd % 16 || KVH <= 0 || H % KVH || bq <= 0 ||
      bk <= 0 || Sq <= 0 || Skv <= 0 || B <= 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return dispatch<float>(q, k, v, o, B, H, KVH, Sq, Skv, hd, bq, bk,
                             causal, window, stride, cap, scale, s);
    case 1:
      return dispatch<__nv_bfloat16>(q, k, v, o, B, H, KVH, Sq, Skv, hd, bq,
                                     bk, causal, window, stride, cap, scale,
                                     s);
    default: return (int)cudaErrorInvalidValue;
  }
}

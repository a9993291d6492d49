// One hop of ring attention (chunked prefill over sequence shards) for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ring_attention.py
// (_hop / _hop_kernel). The resident queries q (B,H,Cl,hd) of one shard
// meet one visiting K/V shard k, v (B,KVH,Ll,hd); query head h reads KV
// head h / (H / KVH). The online-softmax state enters and leaves through
// m, l (B,H,Cl,1) and acc (B,H,Cl,hd), fp32, UPDATED IN PLACE. Masking is
// by explicit position: query row r sits at qp[b][r], key c at kvp[b][c],
// -1 = empty; a pair is visible when both are >= 0, kv <= q and, with a
// window, kv > q - window. Scores s = (q . k) * scale from the upcast
// inputs (K/V times kv_scale when it is nonzero: int8 dequantised here),
// optionally cap * tanh(s / cap); masked entries take -1e30 in the row max
// and weigh exactly 0 in l and acc, so a row with nothing visible keeps its
// state, as in the Pallas body. P.V is fp32 (p is not rounded).
//
// Bound on the H100: at the phi4-mini cell's hop (H 24, KVH 8, Cl 512,
// Ll 4096, hd 128, bf16) a fully visible hop is ~25.8 GFLOP against ~33 MB
// of q, K/V and the fp32 state read and written: operations, far above
// the ridge. Design (simple and right first, the structure of
// flash_attention.cu): one block of 256 threads per (query tile of 64
// rows, head, batch). The block loads its Q tile transposed into shared
// memory and its rows' (m, l, acc) into registers, walks the keys in tiles
// of 64 and skips every tile with no visible pair (which covers the tiles
// the Pallas kernel skips by position bounds); K is staged transposed and
// dequantised in shared memory, each thread computes a 4 x 4 register tile
// of scores, the rows' max and sum are combined across the 16 threads of
// a row by warp shuffles, p goes to shared memory, then V is staged into
// the same buffer and each thread accumulates its 4 rows x hd/16 columns
// of acc. Plain fp32 FMAs on the CUDA cores; wgmma tiles and K/V shared by
// the heads of a GQA group are later work.
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
__device__ __forceinline__ float load_f(const int8_t* p) {
  return (float)*p;
}

size_t smem_bytes(int hd) {
  return sizeof(float) * ((size_t)2 * hd * LD + (size_t)BK * LD);
}

// NJ >= hd / 16: the acc columns (tx + 16 * jj) each thread owns.
template <typename TQ, typename TKV, int NJ>
__global__ void __launch_bounds__(THREADS)
    hop_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
               const TKV* __restrict__ v, const int* __restrict__ qp,
               const int* __restrict__ kvp, float* __restrict__ m_io,
               float* __restrict__ l_io, float* __restrict__ acc_io, int H,
               int KVH, int Cl, int Ll, int hd, int window, float cap,
               float kvs, float scale) {
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // hd x LD: Qt[d][r]
  float* KV = Qt + hd * LD;   // K as Kt[d][c] (hd x LD), then V[c][d]
  float* Ps = KV + hd * LD;   // BK x LD: Ps[c][r]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / KVH);
  const int nj = hd >> 4;
  const TQ* qb = q + (size_t)(b * H + h) * Cl * hd;
  const TKV* kb = k + (size_t)(b * KVH + g) * Ll * hd;
  const TKV* vb = v + (size_t)(b * KVH + g) * Ll * hd;
  const int* kpb = kvp + (size_t)b * Ll;
  const size_t row0 = (size_t)(b * H + h) * Cl;

  for (int e = tid; e < BQ * hd; e += THREADS) {
    const int r = e / hd, d = e - r * hd;
    Qt[d * LD + r] = q0 + r < Cl ? load_f(qb + (size_t)(q0 + r) * hd + d)
                                 : 0.f;
  }

  // this thread's rows: positions (-1 past Cl) and carried state
  int qpos[4];
  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    qpos[i] = r < Cl ? qp[(size_t)b * Cl + r] : -1;
    m[i] = r < Cl ? m_io[row0 + r] : NEG_INF;
    l[i] = r < Cl ? l_io[row0 + r] : 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
      acc[i][jj] = (r < Cl && jj < nj)
                       ? acc_io[(row0 + r) * hd + tx + 16 * jj]
                       : 0.f;
  }

  for (int k0 = 0; k0 < Ll; k0 += BK) {
    // bit 4i+j: pair (row 4ty+i, key 4tx+j) is visible
    int kpos[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = k0 + tx * 4 + j;
      kpos[j] = c < Ll ? kpb[c] : -1;
    }
    unsigned keep = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (qpos[i] >= 0 && kpos[j] >= 0 && kpos[j] <= qpos[i] &&
            (!window || kpos[j] > qpos[i] - window))
          keep |= 1u << (4 * i + j);
    // a tile with no visible pair changes nothing; also the barrier before
    // KV and Ps are overwritten (and after the Q tile is stored)
    if (!__syncthreads_or(keep != 0)) continue;

    for (int e = tid; e < BK * hd; e += THREADS) {
      const int c = e / hd, d = e - c * hd;
      KV[d * LD + c] =
          k0 + c < Ll ? load_f(kb + (size_t)(k0 + c) * hd + d) * kvs : 0.f;
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
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (keep & (1u << (4 * i + j))) {
          float x = s[i][j] * scale;
          if (cap != 0.f) x = cap * tanhf(x / cap);
          s[i][j] = x;
          mx = fmaxf(mx, x);
        }
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e =
            (keep & (1u << (4 * i + j))) ? expf(s[i][j] - m_new) : 0.f;
        sum += e;
        p[i][j] = e;
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
      KV[e] = k0 + c < Ll ? load_f(vb + (size_t)k0 * hd + e) * kvs : 0.f;
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

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Cl) continue;
    if (tx == 0) {
      m_io[row0 + r] = m[i];
      l_io[row0 + r] = l[i];
    }
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
      if (jj < nj) acc_io[(row0 + r) * hd + tx + 16 * jj] = acc[i][jj];
  }
}

template <typename TQ, typename TKV, int NJ>
int launch(const void* q, const void* k, const void* v, const int* qp,
           const int* kvp, float* m, float* l, float* acc, int B, int H,
           int KVH, int Cl, int Ll, int hd, int window, float cap, float kvs,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(
      hop_kernel<TQ, TKV, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Cl + BQ - 1) / BQ, H, B);
  hop_kernel<TQ, TKV, NJ><<<grid, THREADS, smem, stream>>>(
      (const TQ*)q, (const TKV*)k, (const TKV*)v, qp, kvp, m, l, acc, H, KVH,
      Cl, Ll, hd, window, cap, kvs, scale);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV>
int by_hd(const void* q, const void* k, const void* v, const int* qp,
          const int* kvp, float* m, float* l, float* acc, int B, int H,
          int KVH, int Cl, int Ll, int hd, int window, float cap, float kvs,
          float scale, cudaStream_t s) {
  if (hd <= 64)
    return launch<TQ, TKV, 4>(q, k, v, qp, kvp, m, l, acc, B, H, KVH, Cl, Ll,
                              hd, window, cap, kvs, scale, s);
  if (hd <= 128)
    return launch<TQ, TKV, 8>(q, k, v, qp, kvp, m, l, acc, B, H, KVH, Cl, Ll,
                              hd, window, cap, kvs, scale, s);
  return launch<TQ, TKV, 16>(q, k, v, qp, kvp, m, l, acc, B, H, KVH, Cl, Ll,
                             hd, window, cap, kvs, scale, s);
}

template <typename TQ>
int by_kv(int kv_dtype, const void* q, const void* k, const void* v,
          const int* qp, const int* kvp, float* m, float* l, float* acc,
          int B, int H, int KVH, int Cl, int Ll, int hd, int window,
          float cap, float kvs, float scale, cudaStream_t s) {
  switch (kv_dtype) {
    case 0:
      return by_hd<TQ, float>(q, k, v, qp, kvp, m, l, acc, B, H, KVH, Cl, Ll,
                              hd, window, cap, kvs, scale, s);
    case 1:
      return by_hd<TQ, __nv_bfloat16>(q, k, v, qp, kvp, m, l, acc, B, H, KVH,
                                      Cl, Ll, hd, window, cap, kvs, scale, s);
    case 2:
      return by_hd<TQ, int8_t>(q, k, v, qp, kvp, m, l, acc, B, H, KVH, Cl,
                               Ll, hd, window, cap, kvs, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q_dtype: 0 = fp32, 1 = bf16; kv_dtype (of k and v): 0 = fp32, 1 = bf16,
// 2 = int8. kv_scale 0 leaves K/V unscaled. Needs hd a multiple of 16 up to
// 256 and H a multiple of KVH. m, l and acc are read and written in place.
// Returns cudaGetLastError() of the launch.
extern "C" int ring_hop(const void* q, const void* k, const void* v,
                        const void* qp, const void* kvp, void* m, void* l,
                        void* acc, int B, int H, int KVH, int Cl, int Ll,
                        int hd, int window, float cap, float kv_scale,
                        float scale, int q_dtype, int kv_dtype,
                        void* stream) {
  if (hd <= 0 || hd > 256 || hd % 16 || KVH <= 0 || H % KVH || Cl <= 0 ||
      Ll <= 0 || B <= 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const float kvs = kv_scale != 0.f ? kv_scale : 1.f;
  cudaStream_t s = (cudaStream_t)stream;
  const int* qpi = (const int*)qp;
  const int* kvpi = (const int*)kvp;
  float *mf = (float*)m, *lf = (float*)l, *af = (float*)acc;
  switch (q_dtype) {
    case 0:
      return by_kv<float>(kv_dtype, q, k, v, qpi, kvpi, mf, lf, af, B, H,
                          KVH, Cl, Ll, hd, window, cap, kvs, scale, s);
    case 1:
      return by_kv<__nv_bfloat16>(kv_dtype, q, k, v, qpi, kvpi, mf, lf, af,
                                  B, H, KVH, Cl, Ll, hd, window, cap, kvs,
                                  scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

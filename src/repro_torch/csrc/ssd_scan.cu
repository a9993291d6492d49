// Mamba2 chunked SSD scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py (ssd_scan /
// _kernel). Inputs x (B,S,H,P), dt (B,S,H) fp32, a (H,) fp32 negative,
// b and c (B,S,N), one B/C group broadcast over the heads. For each
// (batch, head) the chunks of Q tokens run in order; within a chunk
//   la = dt*a, cum = inclusive cumsum(la), total = cum[Q-1],
//   y[t,p] = sum_{i<=t} (C_t . B_i) exp(cum_t - cum_i) dt_i x[i,p]
//            + exp(cum_t) (C_t . S[p,:]),
//   S[p,n] <- exp(total) S[p,n] + sum_i exp(total - cum_i) dt_i x[i,p] B[i,n],
// every product and the state in fp32, y stored in x's dtype. The state
// starts at zero, as in the Pallas kernel.
//
// Bound on the H100: fp32 operations. At Q=128, N=128, P=64 a (batch,
// head, chunk) needs ~5.3 MFLOP (the masked product with x, C.S^T and the
// state update) and a (batch, chunk) ~2.1 MFLOP more for C.B^T, shared by
// every head, against ~100 KB of input and output a (batch, head, chunk):
// far above the card's fp32 ridge of ~20 FLOP/byte. This kernel rebuilds
// C.B^T in every (head, P-tile) block, ~9.5 MFLOP a (batch, head, chunk).
// Design: the Pallas grid's sequential chunk axis becomes a loop inside
// the block, and the state stays in shared memory from chunk to chunk.
// Row p of the state touches only column p of x and y, so each block owns
// one (batch, head, P-tile): 4 x 48 x 2 = 384 blocks at mamba2-780m's
// training shape instead of 192. Shared memory (fp32, rows padded by one
// word so that column walks hit distinct banks): the chunk's B and C
// (Q x N each), dt*x for the tile (Q x PT), the tile's state (PT x N), one
// 32-row strip of the decay-weighted W = tril(C.B^T o exp(cum_t - cum_i))
// (32 x Q) and four Q-vectors: ~180 KB at Q = N = 128, PT = 32, so the
// Q x Q W is never held whole. Each strip's W is built in 4 x 4 register
// tiles, its lower triangle only, and consumed at once: y for the strip's
// rows is C.S^T scaled by exp(cum) plus W.(dt*x). After the last strip
// the state is updated in place, each thread owning PT*N/256 entries.
// Plain FMAs on the CUDA cores: wgmma tiles, a second pass that builds
// C.B^T once per (batch, chunk) for all heads, and TMA loads are later
// work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int STRIP = 32;      // rows of W per strip
constexpr int MAX_ROWS = 4;    // y rows per thread per strip
constexpr int MAX_SACC = 16;   // state entries per thread (PT * N <= 4096)

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Columns of x one block owns: a power of two <= 32 with PT * N <= 4096,
// no larger than P needs.
int p_tile(int N, int P) {
  int pt = 32;
  while (pt > 1 && (pt * N > 4096 || pt / 2 >= P)) pt /= 2;
  return pt;
}

size_t smem_bytes(int Q, int N, int PT) {
  const int strip = Q < STRIP ? Q : STRIP;
  return sizeof(float) * ((size_t)2 * Q * (N + 1) + (size_t)Q * PT +
                          (size_t)PT * (N + 1) + (size_t)strip * (Q + 1) +
                          (size_t)4 * Q);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a, const T* __restrict__ bm,
                    const T* __restrict__ cm, T* __restrict__ y, int S, int H,
                    int P, int N, int Q, int PT) {
  extern __shared__ float smem[];
  const int N1 = N + 1, Q1 = Q + 1;
  float* Bs = smem;                // Q x N1
  float* Cs = Bs + Q * N1;         // Q x N1
  float* Xs = Cs + Q * N1;         // Q x PT: dt_i * x[i, p0 + p]
  float* Ss = Xs + Q * PT;         // PT x N1: state rows p0 .. p0 + PT
  float* Ws = Ss + PT * N1;        // STRIP x Q1
  float* cum = Ws + (Q < STRIP ? Q : STRIP) * Q1;   // Q
  float* dts = cum + Q;            // Q
  float* ecum = dts + Q;           // Q: exp(cum)
  float* wdec = ecum + Q;          // Q: exp(total - cum)

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * PT, h = blockIdx.y, bb = blockIdx.z;
  const float ah = a[h];
  // y ownership: column yp, rows yt0 + k * ystride of each strip
  const int yp = tid % PT, yt0 = tid / PT, ystride = THREADS / PT;
  // state ownership: column sn, rows sp0 + k * sstride
  const int sn = tid % N, sp0 = tid / N, sstride = THREADS / N;

  for (int i = tid; i < PT * N1; i += THREADS) Ss[i] = 0.f;

  for (int s0 = 0; s0 < S; s0 += Q) {
    __syncthreads();  // the previous chunk is done with every buffer
    for (int i = tid; i < Q; i += THREADS)
      dts[i] = dt[((size_t)bb * S + s0 + i) * H + h];
    for (int idx = tid; idx < Q * N; idx += THREADS) {
      const int i = idx / N, n = idx % N;
      const size_t g = ((size_t)bb * S + s0 + i) * N + n;
      Bs[i * N1 + n] = load_f(bm + g);
      Cs[i * N1 + n] = load_f(cm + g);
    }
    __syncthreads();
    if (tid == 0) {  // inclusive scan of the log decay, in order
      float run = 0.f;
      for (int i = 0; i < Q; ++i) {
        run += dts[i] * ah;
        cum[i] = run;
      }
    }
    for (int idx = tid; idx < Q * PT; idx += THREADS) {
      const int i = idx / PT, p = idx % PT;
      const float xv =
          p0 + p < P
              ? load_f(x + (((size_t)bb * S + s0 + i) * H + h) * P + p0 + p)
              : 0.f;
      Xs[idx] = dts[i] * xv;
    }
    __syncthreads();
    const float total = cum[Q - 1];
    for (int i = tid; i < Q; i += THREADS) {
      ecum[i] = expf(cum[i]);
      wdec[i] = expf(total - cum[i]);
    }
    __syncthreads();

    for (int r0 = 0; r0 < Q; r0 += STRIP) {
      const int rows = Q - r0 < STRIP ? Q - r0 : STRIP;
      const int ncols = r0 + rows;      // W[t, i] = 0 for i > t
      const int ncg = ncols / 4;        // column groups: i = cg + m * ncg
      for (int idx = tid; idx < (rows / 4) * ncg; idx += THREADS) {
        const int cg = idx % ncg, rg = idx / ncg;
        const int tt0 = 4 * rg;
        float d[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int m = 0; m < 4; ++m) d[j][m] = 0.f;
        if (cg <= r0 + tt0 + 3) {   // else every column lies above the rows
          for (int n = 0; n < N; ++n) {
            float cv[4], bv[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) cv[j] = Cs[(r0 + tt0 + j) * N1 + n];
#pragma unroll
            for (int m = 0; m < 4; ++m) bv[m] = Bs[(cg + m * ncg) * N1 + n];
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int m = 0; m < 4; ++m) d[j][m] += cv[j] * bv[m];
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = r0 + tt0 + j;
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int i = cg + m * ncg;
            Ws[(tt0 + j) * Q1 + i] =
                i <= t ? d[j][m] * expf(cum[t] - cum[i]) : 0.f;
          }
        }
      }
      __syncthreads();
      float acc[MAX_ROWS];
#pragma unroll
      for (int k = 0; k < MAX_ROWS; ++k) acc[k] = 0.f;
      // inter-chunk: C_t . S[yp, :] for the thread's rows of the strip
      for (int n = 0; n < N; ++n) {
        const float sv = Ss[yp * N1 + n];
#pragma unroll
        for (int k = 0; k < MAX_ROWS; ++k) {
          const int tt = yt0 + k * ystride;
          if (tt < rows) acc[k] += Cs[(r0 + tt) * N1 + n] * sv;
        }
      }
#pragma unroll
      for (int k = 0; k < MAX_ROWS; ++k) {
        const int tt = yt0 + k * ystride;
        if (tt < rows) acc[k] *= ecum[r0 + tt];
      }
      // intra-chunk: W[t, :] . (dt * x)[:, yp]; W is zero above the diagonal
      for (int i = 0; i < ncols; ++i) {
        const float xv = Xs[i * PT + yp];
#pragma unroll
        for (int k = 0; k < MAX_ROWS; ++k) {
          const int tt = yt0 + k * ystride;
          if (tt < rows) acc[k] += Ws[tt * Q1 + i] * xv;
        }
      }
      if (p0 + yp < P) {
#pragma unroll
        for (int k = 0; k < MAX_ROWS; ++k) {
          const int tt = yt0 + k * ystride;
          if (tt < rows)
            store_out(y + (((size_t)bb * S + s0 + r0 + tt) * H + h) * P +
                          p0 + yp,
                      acc[k]);
        }
      }
      __syncthreads();  // Ws is rewritten by the next strip; Ss read above
    }

    // state update, in place: each entry has one owner
    float sacc[MAX_SACC];
#pragma unroll
    for (int k = 0; k < MAX_SACC; ++k) sacc[k] = 0.f;
    for (int i = 0; i < Q; ++i) {
      const float bv = Bs[i * N1 + sn] * wdec[i];
#pragma unroll
      for (int k = 0; k < MAX_SACC; ++k) {
        const int p = sp0 + k * sstride;
        if (p < PT) sacc[k] += Xs[i * PT + p] * bv;
      }
    }
    const float et = expf(total);
#pragma unroll
    for (int k = 0; k < MAX_SACC; ++k) {
      const int p = sp0 + k * sstride;
      if (p < PT) Ss[p * N1 + sn] = Ss[p * N1 + sn] * et + sacc[k];
    }
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* a, const void* b,
           const void* c, void* y, int B, int S, int H, int P, int N, int Q,
           cudaStream_t stream) {
  const int PT = p_tile(N, P);
  const size_t smem = smem_bytes(Q, N, PT);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((P + PT - 1) / PT, H, B);
  ssd_scan_kernel<T><<<grid, THREADS, smem, stream>>>(
      (const T*)x, (const float*)dt, (const float*)a, (const T*)b,
      (const T*)c, (T*)y, S, H, P, N, Q, PT);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (of x, b, c and y): 0 = fp32, 1 = bf16. Needs S % Q == 0,
// Q % 4 == 0, Q <= 128, N a power of two <= 256 and the shared memory to
// fit. Returns cudaGetLastError() of the launch.
extern "C" int ssd_scan(const void* x, const void* dt, const void* a,
                        const void* b, const void* c, void* y, int B, int S,
                        int H, int P, int N, int Q, int dtype, void* stream) {
  if (Q <= 0 || S % Q || Q % 4 || Q > 128 || N <= 0 || N > 256 ||
      (N & (N - 1)) || smem_bytes(Q, N, p_tile(N, P)) > 232448)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch<float>(x, dt, a, b, c, y, B, S, H, P, N, Q, s);
    case 1:
      return launch<__nv_bfloat16>(x, dt, a, b, c, y, B, S, H, P, N, Q, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

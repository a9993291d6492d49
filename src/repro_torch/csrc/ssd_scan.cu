// Mamba2 chunked SSD scan for Hopper (sm_90a): forward and backward.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py (ssd_scan /
// _kernel). Inputs x (B,S,H,P), dt (B,S,H) fp32, a (H,) fp32 negative,
// b and c (B,S,N), one B/C group broadcast over the heads. Per (batch,
// head, chunk of Q tokens), with la = dt*a, cum = inclusive cumsum(la),
// total = cum[Q-1], u = dt*x, G = C.B^T and L[t,i] = exp(cum_t - cum_i)
// for i <= t, 0 above the diagonal:
//   y     = (G o L).u + exp(cum) o (C.S_in^T)
//   S_out = exp(total) S_in + (exp(total - cum) o u)^T.B
// every product and the state in fp32 from a zero state (or, on the
// serving path, the caller's initial state, with the final state written
// out by pass 3), y stored in x's dtype. The backward is the closed chunked VJP of the same function
// (ssd_scan_backward_plain in kernels/ssd_scan.py spells it out).
//
// Bound on the H100: fp32 operations. Forward at Q = N = 128, P = 64: per
// (batch, head, chunk) 2QNP for the chunk state, 2QNP for C.S_in^T and
// PQ(Q+1) for the lower triangle of (G o L).u, ~5.3 MFLOP; per (batch,
// chunk) NQ(Q+1) for G, shared by every head; against ~100 KB of input and
// output a (batch, head, chunk): far above the card's fp32 ridge of ~20
// FLOP/byte. The backward needs per (batch, head, chunk) 2QNP each for the
// chunk state again, the state cotangent, S_in^T.gy, dS_out^T.u and
// dS_out.B, and PQ(Q+1) each for (G o L)^T.gy and gy.u^T; per (batch,
// chunk) G and the head-summed dG times B and C: ~12.6 MFLOP a (batch,
// head, chunk), ~2.4x the forward.
//
// Design: the Pallas grid's sequential chunk axis becomes chunk-parallel
// passes, one launch each, on the caller's stream:
//   1 cum_g        cum for every (batch, head, chunk) by a warp scan, and
//                  G (and G^T) once per (batch, chunk), lower 64-tiles only
//   2 chunk_state  each chunk's local state (or, in the backward, the
//                  local state cotangent (exp(cum) o gy)^T.C), chunks in
//                  parallel, into a (B, nc, H, N, P) fp32 scratch
//   3 state_pass   an elementwise walk over the chunks, in place: the state
//                  entering each chunk (in reverse: the cotangent leaving it),
//                  from an optional initial state, the final state out
//   4 out          y per (batch, head, chunk, 64 rows, 64 columns of P)
// and for the backward, after 1-3, 2 (mode 1) and 3 (reverse):
//   dg      the head-summed dG = L o (gy.u^T) per (batch, chunk, lower
//           tile, group of heads): the groups' partial sums
//   dx      per (batch, head, chunk, 64 rows): y again (C.S_in^T, then
//           (G o L).u) and du (B.dS_out^T, then (G o L)^T.gy), giving dx
//           and, per row, x.du, R and dcum
//   finish  a warp per (batch, head, chunk): the reverse cumsum of dcum,
//           ddt and the chunk's share of da
//   dbc     dC and dB per (batch, chunk, 64 x 64 tile, split of heads): the
//           state terms as products over (head, p), the head-summed dG
//           times B and C in one more split
//   reduce  the splits' partial sums of dB and dC, and da over (batch,
//           chunk), each added in a fixed order: no float atomics, so the
//           card's gradients repeat from run to run.
// Every product runs in one building block: a unit of 64 threads owns a
// 64 x 64 output tile, 8 x 8 fp32 registers a thread, fed by chunks of 32
// k staged in shared memory through two buffers (cp.async for fp32, through
// registers for bf16); a scale along k or the mask and decay of L is
// applied in place by the thread that staged the entries, a scale along
// the rows to the sums. An operand is staged as it lies in memory:
// k-contiguous as [row][k], k-major as [k][row] (rows padded by 4 floats so
// that a warp's float4 reads take one pass), and the unit reads its
// fragments in float4s of either layout. Chunks above the diagonal of a
// triangular product are skipped. Alone, the unit's loop runs at ~70% of
// the fp32 FMA rate; staging, barriers and epilogues take the passes to
// ~30-45%. Split precision TF32 mma.sync tiles are the way past the fp32
// FMA bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int UNIT = 64;        // threads of a unit: 8 x 8, 8 x 8 outputs each
constexpr int TILE = 64;        // a unit's outputs: TILE x TILE
constexpr int KCH = 32;         // k of a staged chunk
constexpr int KC_LD = KCH + 4;  // row stride of a k-contiguous chunk
constexpr int STAGES = 2;       // chunk buffers of a pipeline
constexpr int DG_LD = TILE + 8; // row stride of the dg pass's sums

__host__ __device__ constexpr int kc_floats(int rows) { return rows * KC_LD; }
__host__ __device__ constexpr int km_floats(int rows) {
  return KCH * (rows + 4);
}

// ------------------------------------------------------------ memory --

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// until at most STAGES - 2 of the thread's copy groups are in flight
__device__ __forceinline__ void cp_wait_chunk() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
}

// 4 consecutive elements at src + off into 16 bytes of shared memory, or
// zeros when !ok
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      size_t off, bool ok) {
  cp_async16(dst, ok ? src + off : src, ok ? 16 : 0);
}
__device__ __forceinline__ float4 bf4(uint2 raw) {
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void copy4(float* dst, const __nv_bfloat16* src,
                                      size_t off, bool ok) {
  *reinterpret_cast<float4*>(dst) =
      ok ? bf4(*reinterpret_cast<const uint2*>(src + off))
         : make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  return bf4(*reinterpret_cast<const uint2*>(p));
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&lo);
  raw.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// -------------------------------------------------- staged products --

// The 16-byte groups of a chunk: rows [r0, r0 + R) and k [k0, k0 + KCH)
// of an operand whose element (r, k) lies at g[r * ld + k] (KC: buffer
// [R][KC_LD]) or g[k * ld + r] (KM: buffer [KCH][R + 4]). Calls
// f(dst, off, r, k, ok) for the calling thread's groups: (r, k) of the
// group's first entry (KC: entries (r, k..k+3); KM: (r..r+3, k)), ok when
// it lies below rmax and kmax (both multiples of 4).
template <bool KC, int R, class F>
__device__ __forceinline__ void for_groups(float* s, int ld, int r0,
                                           int rmax, int k0, int kmax, F f) {
  constexpr int GROUPS = KC ? R * (KCH / 4) : KCH * (R / 4);
  for (int e = threadIdx.x; e < GROUPS; e += blockDim.x) {
    int r, k;
    float* dst;
    if (KC) {
      r = e / (KCH / 4);
      k = 4 * (e % (KCH / 4));
      dst = s + r * KC_LD + k;
    } else {
      k = e / (R / 4);
      r = 4 * (e % (R / 4));
      dst = s + k * (R + 4) + r;
    }
    r += r0;
    k += k0;
    const size_t off = KC ? (size_t)r * ld + k : (size_t)k * ld + r;
    f(dst, off, r, k, r < rmax && k < kmax);
  }
}

// Stages a chunk (zeros past rmax and kmax).
template <bool KC, int R, typename T>
__device__ __forceinline__ void stage(float* s, const T* g, int ld, int r0,
                                      int rmax, int k0, int kmax) {
  for_groups<KC, R>(s, ld, r0, rmax, k0, kmax,
                    [&](float* dst, size_t off, int, int, bool ok) {
                      copy4(dst, g, off, ok);
                    });
}

// Once the chunk has landed, rewrites the entries the thread staged:
// v = f(r, k, v) for every entry below rmax and kmax.
template <bool KC, int R, class F>
__device__ __forceinline__ void fix(float* s, int r0, int rmax, int k0,
                                    int kmax, F f) {
  for_groups<KC, R>(s, 0, r0, rmax, k0, kmax,
                    [&](float* dst, size_t, int r, int k, bool ok) {
                      if (!ok) return;
                      float4 v = *reinterpret_cast<float4*>(dst);
                      const int dr = KC ? 0 : 1, dk = KC ? 1 : 0;
                      v.x = f(r, k, v.x);
                      v.y = f(r + dr, k + dk, v.y);
                      v.z = f(r + 2 * dr, k + 2 * dk, v.z);
                      v.w = f(r + 3 * dr, k + 3 * dk, v.w);
                      *reinterpret_cast<float4*>(dst) = v;
                    });
}

// Row i (or column j) of a unit's fragment: k-contiguous operands give
// rows t + 8i, k-major ones rows 4t + (i & 3) + 32 (i >> 2), so that a
// warp's float4 reads of either layout hit distinct banks.
template <bool KC>
__device__ __forceinline__ int frag(int t, int i) {
  return KC ? t + 8 * i : 4 * t + (i & 3) + 32 * (i >> 2);
}

// acc[i][j] += sum over k in [kb, ke) of A(frag(ty, i), k) B(k, frag(tx, j))
// from a staged chunk: As and Bs at the unit's first row of each operand.
template <bool AKC, bool BKC>
__device__ __forceinline__ void mma(float (&acc)[8][8], const float* As,
                                    int lda, const float* Bs, int ldb,
                                    int ty, int tx, int kb, int ke) {
#pragma unroll 1
  for (int k = kb; k < ke; k += 4) {
    float a[4][8];
    if (AKC) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 v = load4(As + (ty + 8 * i) * KC_LD + k);
        a[0][i] = v.x;
        a[1][i] = v.y;
        a[2][i] = v.z;
        a[3][i] = v.w;
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          const float4 v = load4(As + (k + kk) * lda + 4 * ty + 32 * g);
          a[kk][4 * g] = v.x;
          a[kk][4 * g + 1] = v.y;
          a[kk][4 * g + 2] = v.z;
          a[kk][4 * g + 3] = v.w;
        }
    }
    if (BKC) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 v = load4(Bs + (tx + 8 * j) * KC_LD + k);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float s = acc[i][j];
          s = fmaf(a[0][i], v.x, s);
          s = fmaf(a[1][i], v.y, s);
          s = fmaf(a[2][i], v.z, s);
          acc[i][j] = fmaf(a[3][i], v.w, s);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float b[8];
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          const float4 v = load4(Bs + (k + kk) * ldb + 4 * tx + 32 * g);
          b[4 * g] = v.x;
          b[4 * g + 1] = v.y;
          b[4 * g + 2] = v.z;
          b[4 * g + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(a[kk][i], b[j], acc[i][j]);
      }
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
}

// Chunks 0 .. nq-1 through the STAGES buffers of ring (stride floats
// each): issue(q, buf) stages chunk q, fixup(q, buf) rewrites the thread's
// own entries once they have landed, use(q, buf) consumes the chunk.
// Chunks q + 1 .. q + STAGES - 1 are in flight while q is used; one
// barrier a chunk, and one at the end, after which the ring may be reused.
template <class Issue, class Fixup, class Use>
__device__ __forceinline__ void pipeline(int nq, float* ring, int stride,
                                         Issue issue, Fixup fixup, Use use) {
#pragma unroll
  for (int q = 0; q < STAGES - 1; ++q) {
    if (q < nq) issue(q, ring + q * stride);
    cp_commit();
  }
  for (int q = 0; q < nq; ++q) {
    float* cur = ring + (q % STAGES) * stride;
    cp_wait_chunk();
    fixup(q, cur);
    __syncthreads();
    const int qn = q + STAGES - 1;
    if (qn < nq) issue(qn, ring + (qn % STAGES) * stride);
    cp_commit();
    use(q, cur);
  }
  __syncthreads();
}

struct NoFix {
  __device__ void operator()(int, float*) const {}
};

// the lower 64-tile (ti, ii), ii <= ti, of index x (row by row)
__device__ __forceinline__ void lower_tile(int x, int& ti, int& ii) {
  ti = 0;
  ii = x;
  while (ii > ti) {
    ii -= ti + 1;
    ++ti;
  }
}

// exp of a difference of cumulative log decays (<= 0), for the entries of
// L: ex2.approx of x log2(e). Its relative error grows with |x| (~1e-5 at
// x = -88, where the entry is below 1e-38 and adds nothing to a sum of
// entries near 1); near the diagonal, where the entries matter, ~1e-7.
__device__ __forceinline__ float lexp(float x) { return __expf(x); }

// sum over the 8 lanes of a fragment row (lanes 8m .. 8m + 7 of a warp)
__device__ __forceinline__ float row_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  return v;
}

// ------------------------------------------------------ 1: cum and G --

template <typename T>
__global__ void __launch_bounds__(UNIT)
    cum_g_kernel(const float* __restrict__ dt, const float* __restrict__ a,
                 const T* __restrict__ bm, const T* __restrict__ cm,
                 float* __restrict__ cum, float* __restrict__ g,
                 float* __restrict__ gt, int S, int H, int N, int Q) {
  extern __shared__ __align__(16) float sm[];
  const int c = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int nc = S / Q, nt = (Q + TILE - 1) / TILE;
  if ((int)blockIdx.x == nt * (nt + 1) / 2) {
    // cum of every head: a warp a head, lane l holding tokens 4l .. 4l+3
    const int warp = tid >> 5, lane = tid & 31;
    for (int h = warp; h < H; h += UNIT / 32) {
      float v[4], run = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = 4 * lane + j;
        if (t < Q) run += dt[((size_t)b * S + c * Q + t) * H + h] * a[h];
        v[j] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += y;
      }
      const float prev = __shfl_up_sync(0xffffffffu, incl, 1);
      const float base = lane ? prev : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = 4 * lane + j;
        if (t < Q) cum[((size_t)b * H + h) * S + c * Q + t] = base + v[j];
      }
    }
    return;
  }
  int ti, ii;
  lower_tile(blockIdx.x, ti, ii);
  const int ty = tid >> 3, tx = tid & 7;
  const T* cb = cm + ((size_t)b * S + (size_t)c * Q) * N;
  const T* bb = bm + ((size_t)b * S + (size_t)c * Q) * N;
  constexpr int AF = kc_floats(TILE);
  float acc[8][8];
  zero(acc);
  pipeline(
      (N + KCH - 1) / KCH, sm, 2 * AF,
      [&](int q, float* buf) {
        stage<true, TILE>(buf, cb, N, ti * TILE, Q, q * KCH, N);
        stage<true, TILE>(buf + AF, bb, N, ii * TILE, Q, q * KCH, N);
      },
      NoFix{},
      [&](int, float* buf) {
        mma<true, true>(acc, buf, KC_LD, buf + AF, KC_LD, ty, tx, 0, KCH);
      });
  float* gb = g + ((size_t)b * nc + c) * Q * Q;
  float* gtb = gt + ((size_t)b * nc + c) * Q * Q;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = ti * TILE + frag<true>(ty, i);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int s = ii * TILE + frag<true>(tx, j);
      if (t < Q && s < Q) {
        gb[(size_t)t * Q + s] = acc[i][j];
        gtb[(size_t)s * Q + t] = acc[i][j];
      }
    }
  }
}

// ---------------------------------------------------- 2: chunk states --

// mode 0: S_loc^T[n][p] = sum_i B[i][n] exp(total - cum_i) dt_i x[i][p]
// mode 1: dS_loc^T[n][p] = sum_t C[t][n] exp(cum_t) gy[t][p]
// out (B, nc, H, N, P); a block per (64 x 64 tile, head, batch x chunk).
template <typename T>
__global__ void __launch_bounds__(UNIT)
    chunk_state_kernel(const T* __restrict__ src, const T* __restrict__ mat,
                       const float* __restrict__ dt,
                       const float* __restrict__ cum, float* __restrict__ out,
                       int S, int H, int P, int N, int Q, int mode) {
  extern __shared__ __align__(16) float sm[];
  float* w = sm;          // Q: the scale of token i
  float* ring = sm + Q;
  const int npt = (P + TILE - 1) / TILE;
  const int nt = blockIdx.x / npt, pt = blockIdx.x % npt;
  const int h = blockIdx.y, nc = S / Q, b = blockIdx.z / nc,
            c = blockIdx.z % nc;
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const float* cq = cum + ((size_t)b * H + h) * S + (size_t)c * Q;
  const float total = cq[Q - 1];
  for (int i = tid; i < Q; i += UNIT)
    w[i] = mode ? expf(cq[i])
                : expf(total - cq[i]) * dt[((size_t)b * S + c * Q + i) * H + h];
  __syncthreads();
  const int HP = H * P;
  const T* sb = src + ((size_t)b * S + (size_t)c * Q) * HP + (size_t)h * P;
  const T* mb = mat + ((size_t)b * S + (size_t)c * Q) * N;
  constexpr int AF = km_floats(TILE);
  float acc[8][8];
  zero(acc);
  pipeline(
      (Q + KCH - 1) / KCH, ring, 2 * AF,
      [&](int q, float* buf) {
        stage<false, TILE>(buf, mb, N, nt * TILE, N, q * KCH, Q);
        stage<false, TILE>(buf + AF, sb, HP, pt * TILE, P, q * KCH, Q);
      },
      [&](int q, float* buf) {
        fix<false, TILE>(buf + AF, pt * TILE, P, q * KCH, Q,
                         [&](int, int k, float v) { return v * w[k]; });
      },
      [&](int, float* buf) {
        mma<false, false>(acc, buf, TILE + 4, buf + AF, TILE + 4, ty, tx, 0,
                          KCH);
      });
  float* ob = out + (((size_t)b * nc + c) * H + h) * (size_t)N * P;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int n = nt * TILE + frag<false>(ty, i);
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int p = pt * TILE + 4 * tx + 32 * g;
      if (n < N && p < P)
        store4(ob + (size_t)n * P + p,
               make_float4(acc[i][4 * g], acc[i][4 * g + 1],
                           acc[i][4 * g + 2], acc[i][4 * g + 3]));
    }
  }
}

// ------------------------------------------------------ 3: state pass --

// In place over (B, nc, H, N*P): out[c] = run, run = exp(total_c) run +
// in[c], chunks in order (states entering) or in reverse (cotangents
// leaving). A thread per float4 of a (batch, head) state; the loads of
// SP_BATCH chunks are issued before any is used, so that the walk waits on
// memory once a batch, not once a chunk. ``init`` (B, H, N*P), when not
// null, is the state entering chunk 0 (else zero); ``fin`` (B, H, N*P),
// when not null, receives run after the last chunk (the final state).
constexpr int SP_BATCH = 8;

__global__ void state_pass_kernel(float* __restrict__ s,
                                  const float* __restrict__ cum,
                                  const float* __restrict__ init,
                                  float* __restrict__ fin, int B, int S,
                                  int H, int NP4, int Q, int reverse) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)B * H * NP4) return;
  const int e = idx % NP4, h = (idx / NP4) % H, b = idx / ((size_t)NP4 * H);
  const int nc = S / Q;
  const float* tot = cum + ((size_t)b * H + h) * S + Q - 1;
  float4* base = reinterpret_cast<float4*>(s) + ((size_t)b * nc * H + h) *
                                                    NP4 + e;
  const size_t cstride = (size_t)H * NP4;   // float4s from chunk to chunk
  const size_t own = ((size_t)b * H + h) * NP4 + e;   // (B, H, N*P) index
  float4 run = init ? reinterpret_cast<const float4*>(init)[own]
                    : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j0 = 0; j0 < nc; j0 += SP_BATCH) {
    float4 loc[SP_BATCH];
    float d[SP_BATCH];
#pragma unroll
    for (int k = 0; k < SP_BATCH; ++k) {
      const int c = reverse ? nc - 1 - j0 - k : j0 + k;
      if (j0 + k < nc) {
        loc[k] = base[c * cstride];
        d[k] = expf(tot[(size_t)c * Q]);
      }
    }
#pragma unroll
    for (int k = 0; k < SP_BATCH; ++k) {
      const int c = reverse ? nc - 1 - j0 - k : j0 + k;
      if (j0 + k < nc) {
        base[c * cstride] = run;
        run = make_float4(fmaf(run.x, d[k], loc[k].x),
                          fmaf(run.y, d[k], loc[k].y),
                          fmaf(run.z, d[k], loc[k].z),
                          fmaf(run.w, d[k], loc[k].w));
      }
    }
  }
  if (fin) reinterpret_cast<float4*>(fin)[own] = run;
}

// ------------------------------------------------------------ 4: out --

// y[t][p] = sum_n exp(cum_t) C[t][n] S_in[n][p] + sum_{i<=t} G[t][i]
// L[t][i] dt_i x[i][p]; a block per (64 rows x 64 columns of P, head,
// batch x chunk).
template <typename T>
__global__ void __launch_bounds__(UNIT)
    out_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const T* __restrict__ cm, const float* __restrict__ cum,
               const float* __restrict__ g, const float* __restrict__ s,
               T* __restrict__ y, int S, int H, int P, int N, int Q) {
  extern __shared__ __align__(16) float sm[];
  float* cq = sm;          // Q: cum
  float* dts = cq + Q;     // Q: dt
  float* ecum = dts + Q;   // Q: exp(cum)
  float* ring = ecum + Q;
  const int npt = (P + TILE - 1) / TILE;
  const int tt = blockIdx.x / npt, pt = blockIdx.x % npt;
  const int h = blockIdx.y, nc = S / Q, b = blockIdx.z / nc,
            c = blockIdx.z % nc;
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int HP = H * P;
  for (int i = tid; i < Q; i += UNIT) {
    cq[i] = cum[((size_t)b * H + h) * S + (size_t)c * Q + i];
    dts[i] = dt[((size_t)b * S + c * Q + i) * H + h];
    ecum[i] = expf(cq[i]);
  }
  __syncthreads();
  const T* cb = cm + ((size_t)b * S + (size_t)c * Q) * N;
  const float* sb = s + (((size_t)b * nc + c) * H + h) * (size_t)N * P;
  const float* gb = g + ((size_t)b * nc + c) * Q * Q;
  const T* xb = x + ((size_t)b * S + (size_t)c * Q) * HP + (size_t)h * P;
  const int nqa = (N + KCH - 1) / KCH;
  const int kend = min(Q, (tt + 1) * TILE);   // (G o L) is 0 right of row t
  const int nqb = (kend + KCH - 1) / KCH;
  constexpr int AF = kc_floats(TILE), CH = AF + km_floats(TILE);
  float acc[8][8];
  zero(acc);
  pipeline(
      nqa + nqb, ring, CH,
      [&](int q, float* buf) {
        if (q < nqa) {
          stage<true, TILE>(buf, cb, N, tt * TILE, Q, q * KCH, N);
          stage<false, TILE>(buf + AF, sb, P, pt * TILE, P, q * KCH, N);
        } else {
          const int k0 = (q - nqa) * KCH;
          stage<true, TILE>(buf, gb, Q, tt * TILE, Q, k0, kend);
          stage<false, TILE>(buf + AF, xb, HP, pt * TILE, P, k0, kend);
        }
      },
      [&](int q, float* buf) {
        if (q >= nqa)   // G o L, times dt_i (the u = dt x of the product)
          fix<true, TILE>(buf, tt * TILE, Q, (q - nqa) * KCH, kend,
                          [&](int t, int i, float v) {
                            return i <= t ? v * lexp(cq[t] - cq[i]) * dts[i]
                                          : 0.f;
                          });
      },
      [&](int q, float* buf) {
        mma<true, false>(acc, buf, KC_LD, buf + AF, TILE + 4, ty, tx, 0,
                         KCH);
        if (q == nqa - 1) {   // C.S_in^T is whole: times exp(cum_t)
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int t = tt * TILE + frag<true>(ty, i);
            const float e = t < Q ? ecum[t] : 0.f;
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] *= e;
          }
        }
      });
  T* yb = y + ((size_t)b * S + (size_t)c * Q) * HP + (size_t)h * P;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = tt * TILE + frag<true>(ty, i);
#pragma unroll
    for (int gi = 0; gi < 2; ++gi) {
      const int p = pt * TILE + 4 * tx + 32 * gi;
      if (t < Q && p < P)
        store4(yb + (size_t)t * HP + p,
               make_float4(acc[i][4 * gi], acc[i][4 * gi + 1],
                           acc[i][4 * gi + 2], acc[i][4 * gi + 3]));
    }
  }
}

// ------------------------------------------------------- backward: dg --

// dG[t][i] = sum over the group's heads of L_h[t][i] (gy_h[t] . u_h[i]),
// per (lower 64-tile, group, batch x chunk); writes the group's sum as
// dG (t, i) and dG^T (i, t) into dgp (2, B*nc, ng, Q, Q), zeros above the
// diagonal of a diagonal tile (tiles above it are never written).
template <typename T>
__global__ void __launch_bounds__(UNIT)
    bwd_dg_kernel(const T* __restrict__ gy, const T* __restrict__ x,
                  const float* __restrict__ dt, const float* __restrict__ cum,
                  float* __restrict__ dgp, int S, int H, int P, int Q,
                  int hpg, int ng) {
  extern __shared__ __align__(16) float sm[];
  float* dsum = sm;                   // TILE x DG_LD, each entry one owner
  float* vec = dsum + TILE * DG_LD;   // hpg x TILE each: dt_i, cum_t, cum_i
  float* ring = vec + 3 * hpg * TILE;
  int ti, ii;
  lower_tile(blockIdx.x, ti, ii);
  const int grp = blockIdx.y, nc = S / Q, b = blockIdx.z / nc,
            c = blockIdx.z % nc;
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int h0 = grp * hpg, nh = min(H, h0 + hpg) - h0;
  const int nqp = (P + KCH - 1) / KCH, HP = H * P;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) dsum[(ty + 8 * i) * DG_LD + tx + 8 * j] = 0.f;
  float* dtv = vec;                   // [head][row of the i tile]
  float* cumt = vec + hpg * TILE;     // [head][row of the t tile]
  float* cumi = cumt + hpg * TILE;    // [head][row of the i tile]
  for (int e = tid; e < nh * TILE; e += UNIT) {
    const int h = h0 + e / TILE, r = e % TILE;
    const int t = ti * TILE + r, i = ii * TILE + r;
    const float* ch = cum + ((size_t)b * H + h) * S + (size_t)c * Q;
    cumt[e] = t < Q ? ch[t] : 0.f;
    cumi[e] = i < Q ? ch[i] : 0.f;
    dtv[e] = i < Q ? dt[((size_t)b * S + c * Q + i) * H + h] : 0.f;
  }
  __syncthreads();
  const T* gyb = gy + ((size_t)b * S + (size_t)c * Q) * HP;
  const T* xb = x + ((size_t)b * S + (size_t)c * Q) * HP;
  constexpr int AF = kc_floats(TILE);
  float acc[8][8];
  zero(acc);
  pipeline(
      nh * nqp, ring, 2 * AF,
      [&](int q, float* buf) {
        const int h = h0 + q / nqp, k0 = (q % nqp) * KCH;
        stage<true, TILE>(buf, gyb + (size_t)h * P, HP, ti * TILE, Q, k0, P);
        stage<true, TILE>(buf + AF, xb + (size_t)h * P, HP, ii * TILE, Q, k0,
                          P);
      },
      NoFix{},
      [&](int q, float* buf) {
        mma<true, true>(acc, buf, KC_LD, buf + AF, KC_LD, ty, tx, 0, KCH);
        if (q % nqp != nqp - 1) return;
        // the head is done: fold L_h o (gy.x^T) dt_i into the group's sum
        float ct[8], ci[8], di[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          ct[i] = cumt[(q / nqp) * TILE + frag<true>(ty, i)];
          ci[i] = cumi[(q / nqp) * TILE + frag<true>(tx, i)];
          di[i] = dtv[(q / nqp) * TILE + frag<true>(tx, i)];
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int t = ti * TILE + frag<true>(ty, i);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int s = ii * TILE + frag<true>(tx, j);
            if (s <= t && t < Q)
              dsum[(ty + 8 * i) * DG_LD + tx + 8 * j] +=
                  acc[i][j] * lexp(ct[i] - ci[j]) * di[j];
            acc[i][j] = 0.f;
          }
        }
      });
  const size_t plane = (size_t)Q * Q;
  float* o = dgp + ((size_t)blockIdx.z * ng + grp) * plane;
  float* ot = o + (size_t)gridDim.z * ng * plane;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = ti * TILE + frag<true>(ty, i);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int s = ii * TILE + frag<true>(tx, j);
      if (t < Q && s < Q) {
        const float v = s <= t ? dsum[(ty + 8 * i) * DG_LD + tx + 8 * j] : 0.f;
        o[(size_t)t * Q + s] = v;
        ot[(size_t)s * Q + t] = v;
      }
    }
  }
}

// ------------------------------------------------------- backward: dx --

// Per (64 rows, head, batch x chunk), columns of P in tiles of 64, two
// products of two halves each: y again (C.S_in^T, then (G o L).u) and du
// (B.dS_out^T, then (G o L)^T.gy). For the block's rows: dcum gains
// gy_t . y_t (exp(cum_t) gy_t . (S_in C_t) and the row sums of M = G o dG)
// and loses u_i . du_i (R_i and the column sums of M), with du =
// exp(total - cum_i) (dS_out B_i) + ((G o L)^T gy)_i; dx = dt du. The rows' dcum, x . du and R go to rows
// (3, B, H, S) and the first row tile's <dS_out, S_in> to dss (B, nc, H),
// for the finish pass.
template <typename T>
__global__ void __launch_bounds__(UNIT)
    bwd_dx_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                  const T* __restrict__ bm, const T* __restrict__ cm,
                  const T* __restrict__ gy, const float* __restrict__ cum,
                  const float* __restrict__ g, const float* __restrict__ gt,
                  const float* __restrict__ s, const float* __restrict__ ds,
                  T* __restrict__ dx, float* __restrict__ rows,
                  float* __restrict__ dss, int S, int H, int P, int N,
                  int Q) {
  extern __shared__ __align__(16) float sm[];
  float* cq = sm;            // Q: cum
  float* dts = cq + Q;       // Q: dt
  float* ring = dts + Q;
  constexpr int AF = kc_floats(TILE), CH = AF + km_floats(TILE);
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int rt = blockIdx.x, r0 = rt * TILE, h = blockIdx.y, nc = S / Q,
            b = blockIdx.z / nc, c = blockIdx.z % nc;
  const int HP = H * P;
  const float* cumq = cum + ((size_t)b * H + h) * S + (size_t)c * Q;
  for (int i = tid; i < Q; i += UNIT) {
    cq[i] = cumq[i];
    dts[i] = dt[((size_t)b * S + c * Q + i) * H + h];
  }
  const size_t soff = (((size_t)b * nc + c) * H + h) * (size_t)N * P;
  const float* sb = s + soff;
  const float* dsb = ds + soff;
  if (rt == 0) {
    float part = 0.f;
    for (int e = 4 * tid; e < N * P; e += 4 * UNIT) {
      const float4 u = load4(dsb + e), v = load4(sb + e);
      part = fmaf(u.x, v.x, fmaf(u.y, v.y, fmaf(u.z, v.z, fmaf(u.w, v.w,
                                                                part))));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if ((tid & 31) == 0) ring[tid >> 5] = part;
    __syncthreads();
    if (tid == 0)
      dss[((size_t)b * nc + c) * H + h] = ring[0] + ring[1];
  }
  __syncthreads();
  const float total = cq[Q - 1];
  const size_t roff = ((size_t)b * S + (size_t)c * Q) * HP + (size_t)h * P;
  const T* xb = x + roff;
  const T* gyb = gy + roff;
  T* dxb = dx + roff;
  const T* cb = cm + ((size_t)b * S + (size_t)c * Q) * N;
  const T* bb = bm + ((size_t)b * S + (size_t)c * Q) * N;
  const float* gb = g + ((size_t)b * nc + c) * Q * Q;
  const float* gtb = gt + ((size_t)b * nc + c) * Q * Q;
  const int nqn = (N + KCH - 1) / KCH;
  const int kend = min(Q, r0 + TILE);        // (2): i <= t < r0 + 64
  const int kbeg = (r0 / KCH) * KCH;         // (4): t >= i >= r0
  // the thread's rows r0 + ty + 8i: sums over the row's 8 lanes, the same
  // in each of them
  float rdcum[8], rddx[8], rrr[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) rdcum[i] = rddx[i] = rrr[i] = 0.f;
  const auto lfix = [&](float* buf, int k0, int kmax, bool transposed) {
    // G o L times dt_i (rows t, k = i <= t), or G o L transposed (rows i,
    // k = t >= i)
    fix<true, TILE>(buf, r0, Q, k0, kmax, [&](int r, int k, float v) {
      const int t = transposed ? k : r, i = transposed ? r : k;
      return i <= t ? v * lexp(cq[t] - cq[i]) * (transposed ? 1.f : dts[i])
                    : 0.f;
    });
  };
  float acc[8][8];
  const int nqy = (kend + KCH - 1) / KCH, nqv = (Q - kbeg + KCH - 1) / KCH;
  for (int p0 = 0; p0 < P; p0 += TILE) {
    // y again, exp(cum_t) (C.S_in^T)_t + ((G o L) dt x)_t: dcum_t += gy_t .
    // y_t (the decay's state term and the row sums of M)
    zero(acc);
    pipeline(
        nqn + nqy, ring, CH,
        [&](int q, float* buf) {
          if (q < nqn) {
            stage<true, TILE>(buf, cb, N, r0, Q, q * KCH, N);
            stage<false, TILE>(buf + AF, sb, P, p0, P, q * KCH, N);
          } else {
            stage<true, TILE>(buf, gb, Q, r0, Q, (q - nqn) * KCH, kend);
            stage<false, TILE>(buf + AF, xb, HP, p0, P, (q - nqn) * KCH,
                               kend);
          }
        },
        [&](int q, float* buf) {
          if (q >= nqn) lfix(buf, (q - nqn) * KCH, kend, false);
        },
        [&](int q, float* buf) {
          mma<true, false>(acc, buf, KC_LD, buf + AF, TILE + 4, ty, tx, 0,
                           KCH);
          if (q == nqn - 1) {   // C.S_in^T is whole: times exp(cum_t)
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const int t = r0 + frag<true>(ty, i);
              const float e = t < Q ? expf(cq[t]) : 0.f;
#pragma unroll
              for (int j = 0; j < 8; ++j) acc[i][j] *= e;
            }
          }
        });
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = r0 + frag<true>(ty, i);
      float d = 0.f;
#pragma unroll
      for (int gi = 0; gi < 2; ++gi) {
        const int p = p0 + 4 * tx + 32 * gi;
        if (t < Q && p < P) {
          const float4 v = load4(gyb + (size_t)t * HP + p);
          d += v.x * acc[i][4 * gi] + v.y * acc[i][4 * gi + 1] +
               v.z * acc[i][4 * gi + 2] + v.w * acc[i][4 * gi + 3];
        }
      }
      rdcum[i] += row_sum(d);
    }
    // du = exp(total - cum_i) (dS_out B_i) + ((G o L)^T gy)_i, with R_i =
    // u_i . (the first term) taken between the two
    zero(acc);
    pipeline(
        nqn + nqv, ring, CH,
        [&](int q, float* buf) {
          if (q < nqn) {
            stage<true, TILE>(buf, bb, N, r0, Q, q * KCH, N);
            stage<false, TILE>(buf + AF, dsb, P, p0, P, q * KCH, N);
          } else {
            const int k0 = kbeg + (q - nqn) * KCH;
            stage<true, TILE>(buf, gtb, Q, r0, Q, k0, Q);
            stage<false, TILE>(buf + AF, gyb, HP, p0, P, k0, Q);
          }
        },
        [&](int q, float* buf) {
          if (q >= nqn) lfix(buf, kbeg + (q - nqn) * KCH, Q, true);
        },
        [&](int q, float* buf) {
          mma<true, false>(acc, buf, KC_LD, buf + AF, TILE + 4, ty, tx, 0,
                           KCH);
          if (q != nqn - 1) return;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int r = r0 + frag<true>(ty, i);
            const float w = r < Q ? expf(total - cq[r]) : 0.f;
            float d = 0.f;
#pragma unroll
            for (int gi = 0; gi < 2; ++gi) {
              const int p = p0 + 4 * tx + 32 * gi;
#pragma unroll
              for (int m = 0; m < 4; ++m) acc[i][4 * gi + m] *= w;
              if (r < Q && p < P) {
                const float4 v = load4(xb + (size_t)r * HP + p);
                d += v.x * acc[i][4 * gi] + v.y * acc[i][4 * gi + 1] +
                     v.z * acc[i][4 * gi + 2] + v.w * acc[i][4 * gi + 3];
              }
            }
            d = row_sum(d);
            if (r < Q) rrr[i] += dts[r] * d;
          }
        });
    // dx = dt du, ddt gets x . du, dcum_i loses u_i . du_i
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = r0 + frag<true>(ty, i);
      float d = 0.f;
#pragma unroll
      for (int gi = 0; gi < 2; ++gi) {
        const int p = p0 + 4 * tx + 32 * gi;
        if (r < Q && p < P) {
          const float4 du = make_float4(acc[i][4 * gi], acc[i][4 * gi + 1],
                                        acc[i][4 * gi + 2],
                                        acc[i][4 * gi + 3]);
          const float4 v = load4(xb + (size_t)r * HP + p);
          d += v.x * du.x + v.y * du.y + v.z * du.z + v.w * du.w;
          const float dr = dts[r];
          store4(dxb + (size_t)r * HP + p,
                 make_float4(dr * du.x, dr * du.y, dr * du.z, dr * du.w));
        }
      }
      d = row_sum(d);
      if (r < Q) {
        rddx[i] += d;
        rdcum[i] -= dts[r] * d;
      }
    }
  }
  if (tx) return;
  const size_t plane = (size_t)gridDim.z / nc * H * S;   // B * H * S
  float* rb = rows + ((size_t)b * H + h) * S + (size_t)c * Q;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + frag<true>(ty, i);
    if (r < Q) {
      rb[r] = rdcum[i];
      rb[plane + r] = rddx[i];
      rb[2 * plane + r] = rrr[i];
    }
  }
}

// ---------------------------------------------------- backward: finish --

// A warp per (batch, chunk, head): dcum_{Q-1} += sum R + exp(total)
// <dS_out, S_in>, dla = reverse cumsum of dcum, ddt = x . du + a dla, and
// the chunk's sum of dt dla (for da) into dapart (B, nc, H).
__global__ void bwd_finish_kernel(const float* __restrict__ rows,
                                  const float* __restrict__ dss,
                                  const float* __restrict__ dt,
                                  const float* __restrict__ a,
                                  const float* __restrict__ cum,
                                  float* __restrict__ ddt,
                                  float* __restrict__ dapart, int B, int S,
                                  int H, int Q) {
  const int w = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31, nc = S / Q;
  if (w >= B * nc * H) return;
  const int h = w % H, c = (w / H) % nc, b = w / (H * nc);
  const size_t plane = (size_t)B * H * S;
  const float* rb = rows + ((size_t)b * H + h) * S + (size_t)c * Q;
  float v[4], rs = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int t = 4 * lane + j;
    v[j] = t < Q ? rb[t] : 0.f;
    if (t < Q) rs += rb[2 * plane + t];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    rs += __shfl_xor_sync(0xffffffffu, rs, off);
  if (4 * lane <= Q - 1 && Q - 1 < 4 * lane + 4)
    v[(Q - 1) & 3] += rs + expf(cum[((size_t)b * H + h) * S +
                                    (size_t)c * Q + Q - 1]) *
                               dss[((size_t)b * nc + c) * H + h];
  // suffix sums: within the lane, then over the lanes above
  float suf[4];
  suf[3] = v[3];
  suf[2] = v[2] + suf[3];
  suf[1] = v[1] + suf[2];
  suf[0] = v[0] + suf[1];
  float incl = suf[0];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_down_sync(0xffffffffu, incl, off);
    if (lane + off < 32) incl += y;
  }
  const float next = __shfl_down_sync(0xffffffffu, incl, 1);
  const float above = lane < 31 ? next : 0.f;
  const float ah = a[h];
  float dap = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int t = 4 * lane + j;
    if (t < Q) {
      const float dla = above + suf[j];
      const size_t k = ((size_t)b * S + c * Q + t) * H + h;
      ddt[k] = rb[plane + t] + ah * dla;
      dap += dt[k] * dla;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    dap += __shfl_xor_sync(0xffffffffu, dap, off);
  if (lane == 0) dapart[((size_t)b * nc + c) * H + h] = dap;
}

// ------------------------------------------------------ backward: dbc --

// Partial sums of dC (which 0) and dB (which 1) per (which x 64-row tile x
// 64-column tile, split, batch x chunk) into part (2, B*nc, ns + 1, Q, N):
// split sp < ns sums its heads' state terms, sum over (h, p) of
// exp(cum_t) gy[t][h,p] S_in[h][n][p] (dC) or exp(total - cum_i) dt_i
// x[i][h,p] dS_out[h][n][p] (dB); split ns adds the dg pass's groups and
// takes dG.B (dC) or dG^T.C (dB).
template <typename T>
__global__ void __launch_bounds__(UNIT)
    bwd_dbc_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                   const T* __restrict__ bm, const T* __restrict__ cm,
                   const T* __restrict__ gy, const float* __restrict__ cum,
                   const float* __restrict__ s, const float* __restrict__ ds,
                   const float* __restrict__ dgp, float* __restrict__ part,
                   int S, int H, int P, int N, int Q, int ng, int hps,
                   int ns) {
  extern __shared__ __align__(16) float sm[];
  const int ntq = (Q + TILE - 1) / TILE, ntn = (N + TILE - 1) / TILE;
  const int which = blockIdx.x / (ntq * ntn);
  const int rt = (blockIdx.x / ntn) % ntq, nt = blockIdx.x % ntn;
  const int sp = blockIdx.y, nc = S / Q, b = blockIdx.z / nc,
            c = blockIdx.z % nc;
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int HP = H * P;
  constexpr int AF = kc_floats(TILE);
  float acc[8][8];
  zero(acc);
  float* pb = part + (((size_t)which * gridDim.z + blockIdx.z) * (ns + 1) +
                      sp) * (size_t)Q * N;
  if (sp < ns) {
    const int h0 = sp * hps, nh = min(H, h0 + hps) - h0;
    const int nqp = (P + KCH - 1) / KCH;
    const T* src = (which ? x : gy) + ((size_t)b * S + (size_t)c * Q) * HP;
    const float* st = (which ? ds : s) + ((size_t)b * nc + c) * H * (size_t)N * P;
    // the scale of each (head, row): exp(cum_t) (dC), exp(total - cum_i)
    // dt_i (dB)
    float* scl = sm + STAGES * 2 * AF;
    for (int e = tid; e < nh * TILE; e += UNIT) {
      const int h = h0 + e / TILE, r = rt * TILE + e % TILE;
      const float* ch = cum + ((size_t)b * H + h) * S + (size_t)c * Q;
      scl[e] = r >= Q ? 0.f
               : which ? expf(ch[Q - 1] - ch[r]) *
                             dt[((size_t)b * S + c * Q + r) * H + h]
                       : expf(ch[r]);
    }
    __syncthreads();
    pipeline(
        nh * nqp, sm, 2 * AF,
        [&](int q, float* buf) {
          const int h = h0 + q / nqp, k0 = (q % nqp) * KCH;
          stage<true, TILE>(buf, src + (size_t)h * P, HP, rt * TILE, Q, k0,
                            P);
          stage<true, TILE>(buf + AF, st + (size_t)h * N * P, P, nt * TILE,
                            N, k0, P);
        },
        [&](int q, float* buf) {
          const float* sh = scl + (q / nqp) * TILE - rt * TILE;
          fix<true, TILE>(buf, rt * TILE, Q, (q % nqp) * KCH, P,
                          [&](int r, int, float v) { return v * sh[r]; });
        },
        [&](int, float* buf) {
          mma<true, true>(acc, buf, KC_LD, buf + AF, KC_LD, ty, tx, 0, KCH);
        });
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = rt * TILE + frag<true>(ty, i);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = nt * TILE + frag<true>(tx, j);
        if (r < Q && n < N) pb[(size_t)r * N + n] = acc[i][j];
      }
    }
    return;
  }
  // dC_t += sum_{i<=t} dG[t][i] B[i]; dB_i += sum_{t>=i} dG^T[i][t] C[t]
  const size_t plane = (size_t)Q * Q;
  const float* d0 = dgp + ((size_t)which * gridDim.z + blockIdx.z) * ng * plane;
  const T* mat = (which ? cm : bm) + ((size_t)b * S + (size_t)c * Q) * N;
  const int kb = which ? (rt * TILE / KCH) * KCH : 0;
  const int ke = which ? Q : min(Q, (rt + 1) * TILE);
  pipeline(
      (ke - kb + KCH - 1) / KCH, sm, AF + km_floats(TILE),
      [&](int q, float* buf) {
        const int k0 = kb + q * KCH;
        stage<true, TILE>(buf, d0, Q, rt * TILE, Q, k0, ke);
        stage<false, TILE>(buf + AF, mat, N, nt * TILE, N, k0, ke);
      },
      [&](int q, float* buf) {
        fix<true, TILE>(buf, rt * TILE, Q, kb + q * KCH, ke,
                        [&](int r, int k, float v) {
                          if (which ? k < r : k > r) return 0.f;
                          for (int gi = 1; gi < ng; ++gi)
                            v += d0[gi * plane + (size_t)r * Q + k];
                          return v;
                        });
      },
      [&](int, float* buf) {
        mma<true, false>(acc, buf, KC_LD, buf + AF, TILE + 4, ty, tx, 0, KCH);
      });
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = rt * TILE + frag<true>(ty, i);
#pragma unroll
    for (int gi = 0; gi < 2; ++gi) {
      const int n = nt * TILE + 4 * tx + 32 * gi;
      if (r < Q && n < N)
        store4(pb + (size_t)r * N + n,
               make_float4(acc[i][4 * gi], acc[i][4 * gi + 1],
                           acc[i][4 * gi + 2], acc[i][4 * gi + 3]));
    }
  }
}

// --------------------------------------------------- backward: reduce --

// dC and dB: the ns + 1 partial sums of part, in order; the last block: da
// over (batch, chunk), in order.
template <typename T>
__global__ void bwd_reduce_kernel(const float* __restrict__ part,
                                  const float* __restrict__ dapart,
                                  T* __restrict__ db, T* __restrict__ dc,
                                  float* __restrict__ da, int B, int S, int H,
                                  int N, int Q, int ns) {
  const int nc = S / Q;
  if (blockIdx.x == gridDim.x - 1) {
    for (int h = threadIdx.x; h < H; h += blockDim.x) {
      float v = 0.f;
      for (int bc = 0; bc < B * nc; ++bc) v += dapart[(size_t)bc * H + h];
      da[h] = v;
    }
    return;
  }
  const size_t e = 4 * ((size_t)blockIdx.x * blockDim.x + threadIdx.x);
  const size_t per = (size_t)B * S * N;
  if (e >= 2 * per) return;
  const int which = e / per;
  const size_t rem = e % per;               // (b, s, n) of the output
  const int n = rem % N;
  const size_t bs = rem / N;
  const int b = bs / S, t = bs % S % Q, c = bs % S / Q;
  const float* p = part + ((((size_t)which * B + b) * nc + c) * (ns + 1)) *
                              (size_t)Q * N + (size_t)t * N + n;
  float4 v = load4(p);
  for (int sp = 1; sp <= ns; ++sp) {
    const float4 w = load4(p + (size_t)sp * Q * N);
    v = make_float4(v.x + w.x, v.y + w.y, v.z + w.z, v.w + w.w);
  }
  store4((which ? db : dc) + rem, v);
}

// ---------------------------------------------------------- launches --

template <class K>
int with_smem(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

bool bad_shape(int B, int S, int H, int P, int N, int Q) {
  return B <= 0 || H <= 0 || Q < 4 || Q > 128 || Q % 4 || S % Q || S <= 0 ||
         P <= 0 || P % 4 || N <= 0 || N % 4;
}

template <typename T>
int launch_cum_g(const void* dt, const void* a, const void* b, const void* c,
                 void* cum, void* g, void* gt, int B, int S, int H, int N,
                 int Q, cudaStream_t st) {
  const int nt = (Q + TILE - 1) / TILE;
  const size_t smem = sizeof(float) * STAGES * 2 * kc_floats(TILE);
  int err = with_smem(cum_g_kernel<T>, smem);
  if (err) return err;
  cum_g_kernel<T><<<dim3(nt * (nt + 1) / 2 + 1, S / Q, B), UNIT, smem, st>>>(
      (const float*)dt, (const float*)a, (const T*)b, (const T*)c,
      (float*)cum, (float*)g, (float*)gt, S, H, N, Q);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_chunk_state(const void* src, const void* mat, const void* dt,
                       const void* cum, void* out, int B, int S, int H, int P,
                       int N, int Q, int mode, cudaStream_t st) {
  const size_t smem = sizeof(float) * (Q + STAGES * 2 * km_floats(TILE));
  int err = with_smem(chunk_state_kernel<T>, smem);
  if (err) return err;
  const int tiles = ((N + TILE - 1) / TILE) * ((P + TILE - 1) / TILE);
  chunk_state_kernel<T><<<dim3(tiles, H, B * (S / Q)), UNIT, smem, st>>>(
      (const T*)src, (const T*)mat, (const float*)dt, (const float*)cum,
      (float*)out, S, H, P, N, Q, mode);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_out(const void* x, const void* dt, const void* c, const void* cum,
               const void* g, const void* s, void* y, int B, int S, int H,
               int P, int N, int Q, cudaStream_t st) {
  const size_t smem =
      sizeof(float) * (3 * Q + STAGES * (kc_floats(TILE) + km_floats(TILE)));
  int err = with_smem(out_kernel<T>, smem);
  if (err) return err;
  const int tiles = ((Q + TILE - 1) / TILE) * ((P + TILE - 1) / TILE);
  out_kernel<T><<<dim3(tiles, H, B * (S / Q)), UNIT, smem, st>>>(
      (const T*)x, (const float*)dt, (const T*)c, (const float*)cum,
      (const float*)g, (const float*)s, (T*)y, S, H, P, N, Q);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dg(const void* gy, const void* x, const void* dt, const void* cum,
              void* dgp, int B, int S, int H, int P, int Q, int hpg, int ng,
              cudaStream_t st) {
  const int nt = (Q + TILE - 1) / TILE;
  const size_t smem = sizeof(float) * (TILE * DG_LD + 3 * hpg * TILE +
                                       STAGES * 2 * kc_floats(TILE));
  int err = with_smem(bwd_dg_kernel<T>, smem);
  if (err) return err;
  bwd_dg_kernel<T><<<dim3(nt * (nt + 1) / 2, ng, B * (S / Q)), UNIT, smem,
                     st>>>((const T*)gy, (const T*)x, (const float*)dt,
                           (const float*)cum, (float*)dgp, S, H, P, Q, hpg,
                           ng);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dx(const void* const* p, int B, int S, int H, int P, int N, int Q,
              cudaStream_t st) {
  const size_t smem =
      sizeof(float) * (2 * Q + STAGES * (kc_floats(TILE) + km_floats(TILE)));
  int err = with_smem(bwd_dx_kernel<T>, smem);
  if (err) return err;
  bwd_dx_kernel<T><<<dim3((Q + TILE - 1) / TILE, H, B * (S / Q)), UNIT, smem,
                      st>>>(
      (const T*)p[0], (const float*)p[1], (const T*)p[2], (const T*)p[3],
      (const T*)p[4], (const float*)p[5], (const float*)p[6],
      (const float*)p[7], (const float*)p[8], (const float*)p[9], (T*)p[10],
      (float*)p[11], (float*)p[12], S, H, P, N, Q);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dbc(const void* const* p, int B, int S, int H, int P, int N, int Q,
               int ng, int hps, int ns, cudaStream_t st) {
  const size_t smem =
      sizeof(float) * (STAGES * 2 * kc_floats(TILE) + hps * TILE);
  int err = with_smem(bwd_dbc_kernel<T>, smem);
  if (err) return err;
  const int tiles = 2 * ((Q + TILE - 1) / TILE) * ((N + TILE - 1) / TILE);
  bwd_dbc_kernel<T><<<dim3(tiles, ns + 1, B * (S / Q)), UNIT, smem, st>>>(
      (const T*)p[0], (const float*)p[1], (const T*)p[2], (const T*)p[3],
      (const T*)p[4], (const float*)p[5], (const float*)p[6],
      (const float*)p[7], (const float*)p[8], (float*)p[9], S, H, P, N, Q, ng,
      hps, ns);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_reduce(const void* part, const void* dapart, void* db, void* dc,
                  void* da, int B, int S, int H, int N, int Q, int ns,
                  cudaStream_t st) {
  const size_t n4 = (size_t)2 * B * S * N / 4;
  const int blocks = (int)((n4 + 255) / 256) + 1;
  bwd_reduce_kernel<T><<<blocks, 256, 0, st>>>(
      (const float*)part, (const float*)dapart, (T*)db, (T*)dc, (float*)da, B,
      S, H, N, Q, ns);
  return (int)cudaGetLastError();
}

#define SSD_DISPATCH(dtype, call)                               \
  switch (dtype) {                                              \
    case 0: { using T = float; return call; }                   \
    case 1: { using T = __nv_bfloat16; return call; }           \
    default: return (int)cudaErrorInvalidValue;                 \
  }

}  // namespace

// The passes' C entry points. dtype (of x, b, c, gy, y, dx, db, dc): 0 =
// fp32, 1 = bf16. Each needs S % Q == 0, Q % 4 == 0, 4 <= Q <= 128,
// P % 4 == 0 and N % 4 == 0, and returns cudaGetLastError() of its launch.
extern "C" int ssd_cum_g(const void* dt, const void* a, const void* b,
                         const void* c, void* cum, void* g, void* gt, int B,
                         int S, int H, int N, int Q, int dtype,
                         void* stream) {
  if (bad_shape(B, S, H, 4, N, Q)) return (int)cudaErrorInvalidValue;
  SSD_DISPATCH(dtype, launch_cum_g<T>(dt, a, b, c, cum, g, gt, B, S, H, N, Q,
                                      (cudaStream_t)stream))
}

// mode 0: the local states from (x, b); mode 1: the local state
// cotangents from (gy, c).
extern "C" int ssd_chunk_state(const void* src, const void* mat,
                               const void* dt, const void* cum, void* out,
                               int B, int S, int H, int P, int N, int Q,
                               int mode, int dtype, void* stream) {
  if (bad_shape(B, S, H, P, N, Q)) return (int)cudaErrorInvalidValue;
  SSD_DISPATCH(dtype, launch_chunk_state<T>(src, mat, dt, cum, out, B, S, H,
                                            P, N, Q, mode,
                                            (cudaStream_t)stream))
}

// init / fin: (B, H, N, P) fp32 or null (a zero initial state; no final
// state written).
extern "C" int ssd_state_pass(void* s, const void* cum, const void* init,
                              void* fin, int B, int S, int H, int P, int N,
                              int Q, int reverse, void* stream) {
  if (bad_shape(B, S, H, P, N, Q)) return (int)cudaErrorInvalidValue;
  const int np4 = N * P / 4;
  const size_t n = (size_t)B * H * np4;
  state_pass_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                      (cudaStream_t)stream>>>(
      (float*)s, (const float*)cum, (const float*)init, (float*)fin, B, S, H,
      np4, Q, reverse);
  return (int)cudaGetLastError();
}

extern "C" int ssd_out(const void* x, const void* dt, const void* c,
                       const void* cum, const void* g, const void* s, void* y,
                       int B, int S, int H, int P, int N, int Q, int dtype,
                       void* stream) {
  if (bad_shape(B, S, H, P, N, Q)) return (int)cudaErrorInvalidValue;
  SSD_DISPATCH(dtype, launch_out<T>(x, dt, c, cum, g, s, y, B, S, H, P, N, Q,
                                    (cudaStream_t)stream))
}

extern "C" int ssd_bwd_dg(const void* gy, const void* x, const void* dt,
                          const void* cum, void* dgp, int B, int S, int H,
                          int P, int Q, int hpg, int ng, int dtype,
                          void* stream) {
  if (bad_shape(B, S, H, P, 4, Q) || hpg <= 0 || ng * hpg < H)
    return (int)cudaErrorInvalidValue;
  SSD_DISPATCH(dtype, launch_dg<T>(gy, x, dt, cum, dgp, B, S, H, P, Q, hpg,
                                   ng, (cudaStream_t)stream))
}

// rows (3, B, H, S): each row's dcum, x . du and R; dss (B, nc, H)
extern "C" int ssd_bwd_dx(const void* x, const void* dt, const void* b,
                          const void* c, const void* gy, const void* cum,
                          const void* g, const void* gt, const void* s,
                          const void* ds, void* dx, void* rows, void* dss,
                          int B, int S, int H, int P, int N, int Q, int dtype,
                          void* stream) {
  if (bad_shape(B, S, H, P, N, Q)) return (int)cudaErrorInvalidValue;
  const void* p[13] = {x, dt, b, c, gy, cum, g, gt, s, ds, dx, rows, dss};
  SSD_DISPATCH(dtype, launch_dx<T>(p, B, S, H, P, N, Q,
                                   (cudaStream_t)stream))
}

extern "C" int ssd_bwd_finish(const void* rows, const void* dss,
                              const void* dt, const void* a, const void* cum,
                              void* ddt, void* dapart, int B, int S, int H,
                              int Q, void* stream) {
  if (bad_shape(B, S, H, 4, 4, Q)) return (int)cudaErrorInvalidValue;
  const int warps = B * (S / Q) * H;
  bwd_finish_kernel<<<(warps + 3) / 4, 128, 0, (cudaStream_t)stream>>>(
      (const float*)rows, (const float*)dss, (const float*)dt,
      (const float*)a, (const float*)cum, (float*)ddt, (float*)dapart, B, S,
      H, Q);
  return (int)cudaGetLastError();
}

extern "C" int ssd_bwd_dbc(const void* x, const void* dt, const void* b,
                           const void* c, const void* gy, const void* cum,
                           const void* s, const void* ds, const void* dgp,
                           void* part, int B, int S, int H, int P, int N,
                           int Q, int ng, int hps, int ns, int dtype,
                           void* stream) {
  if (bad_shape(B, S, H, P, N, Q) || ng <= 0 || hps <= 0 || ns * hps < H)
    return (int)cudaErrorInvalidValue;
  const void* p[10] = {x, dt, b, c, gy, cum, s, ds, dgp, part};
  SSD_DISPATCH(dtype, launch_dbc<T>(p, B, S, H, P, N, Q, ng, hps, ns,
                                    (cudaStream_t)stream))
}

extern "C" int ssd_bwd_reduce(const void* part, const void* dapart, void* db,
                              void* dc, void* da, int B, int S, int H, int N,
                              int Q, int ns, int dtype, void* stream) {
  if (bad_shape(B, S, H, 4, N, Q)) return (int)cudaErrorInvalidValue;
  SSD_DISPATCH(dtype, launch_reduce<T>(part, dapart, db, dc, da, B, S, H, N,
                                       Q, ns, (cudaStream_t)stream))
}

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
// All designs evaluate that rule for every entry on the caller's (bq, bk)
// grid, whatever their own tiles are: an entry of a skipped block is left
// out (score -inf, p = 0), a masked entry of a running block takes -1e30
// and so contributes exp(-1e30 - m), 1 while its row's max is still -1e30,
// as in the Pallas body (the KV tail up to the padded grid counts, with
// V = 0). A key tile is skipped unless it holds a kept entry or a row
// still at -1e30 has an entry of a running block in it.
//
// Bound on the H100: the products at the paths' shapes. In fp32 (the
// training shape) a causal (batch, head) of S = 4096, hd = 128 needs ~4.3
// GFLOP (Q.K^T and P.V over the lower triangle) against 4 MB of q, k, v
// and o: far above the card's fp32 ridge of ~20 FLOP/byte, so the
// products' FMAs on the CUDA cores (TF32 stays off: fp32 is the path's
// dtype) and the shared-memory reads that feed them set the pace. In bf16
// (serving's prefill_with_cache at gemma2-27b's heads, S = 7600) the same
// work runs on the tensor cores: 0.48 ms at 989 TFLOP/s, far above its
// 187 MB of traffic (0.056 ms), and beside it the transcendentals, one exp a
// pair and one tanh more under a softcap, 0.22 / 0.44 ms at the SFU's 16
// a clock an SM. At hd 256 (paligemma-3b, gemma3-12b) a pair costs twice
// the products of hd 128 for the same exps; at hd 80 (zamba2-2.7b) the
// designs run their hd-128 instances, 1.6x the tensor work of the pair.
// Three designs, picked on the host (kernels/flash_attention.py
// select_flash_design):
//
// tc (bf16, hd 64, 80, 128 or 256): wgmma tiles fed by TMA, in
//    csrc/flash_tc.cu (its own library, so that the two compile side by
//    side), whose header sets the design out.
// tiled (fp32, hd 64, 80, 128 or 256: the training paths). At hd <= 128 a
//    block of 128 threads takes 64 query rows of one head; a key tile is
//    128 keys. Thread (ty, tx) owns rows ty + 8i and keys tx + 16j (i, j <
//    8) of the score tile, an 8 x 8 register tile, and rows ty + 8i by
//    dims 4tx + 64h of the output (8 x 8 at hd 128). Q sits in shared
//    memory row-major; K and V stream through a ring of two 18 KB buffers
//    in chunks, K as 128
//    keys x 32 dims, V as 32 keys x hd, each copied with 16-byte cp.async
//    into rows padded by 16 bytes (no transposing store, conflict-free
//    float4 reads), the next chunk in flight while this one computes, one
//    barrier a chunk.
//    Q.K^T: per 4 dims a thread reads 8 float4 of Q and 8 of K (256 bytes)
//    for 256 FMAs; P.V: per key 2 float4 of P and 2 of V (64 bytes) for 64
//    FMAs: one FMA a byte of shared memory on both sides. The row max and
//    sum are reduced over the 16 threads that share a row by shuffles; P
//    goes through shared memory, key-major with the rows of a thread
//    contiguous. A tile below the diagonal, inside the window and the KV
//    tail, with no perforation, skips the per-entry rule. The blocks of a
//    query tile's heads launch side by side, heaviest causal tiles first,
//    so the R heads of a GQA group read each K/V chunk from L2 at about
//    the same time. K/V are not shared in shared memory by those heads:
//    Q and P of a head's 64 rows take 68 KB, so three heads (phi4-mini's
//    R = 3) with two K/V stages need ~240 KB, above the 227 KB a block may
//    have, and 32 rows a head would leave one block of 6 warps an SM. Nor
//    would it pay: a 128-row block of one head, which halves the K/V
//    staged per FMA as sharing by two heads would, ran the training cell
//    in 6.19 ms against this layout's 6.01 (H100, one call). At the cell
//    the kernel issues ~21k instructions a thread a tile for 16k FMAs and
//    stalls on each loop's shared-memory loads with two warps a scheduler:
//    the registers (245 a thread, no spills) leave no room to load ahead.
//    hd 80 runs the hd-128 instance: its cp.async copies past dim 80 take
//    a source size of 0 (zeros), a tile's K chunks stop at the chunk that
//    holds dim 79 (3 of 4), and output dims past 80 are not stored.
//    hd 256: a thread cannot own twice the output dims at 245 registers,
//    so a block is two halves of 128 threads. Half hf owns keys 64 hf ..
//    64 hf + 63 of each score tile (an 8 x 4 register tile a thread, over
//    all 256 dims) and output dims 128 hf .. 128 hf + 127 (8 x 8, as at hd
//    128); the row max meets across the halves through shared memory once
//    a tile, each half sums its own keys' p and the sums meet at the end;
//    P is staged key-major as before, so each half's P.V reads all 128
//    keys. K chunks are 128 keys x 64 dims, V chunks 32 keys x 256 dims:
//    Q 66.6 KB, P 34.8 KB, two 34.8 KB stages, 171.5 KB a block.
// simple (fp32 and bf16 at every other head size: the smoke configs' hd 16;
//    no full-width config's path takes it): one block of 256 threads per
//    (query tile of 64 rows, head, batch). Q transposed in shared memory;
//    K staged transposed with scalar loads, a 4 x 4 register tile of scores
//    a thread, rows' max and sum across 16 threads by shuffles, P to shared
//    memory, then V staged into the same buffer and each thread
//    accumulating its 4 rows x hd/16 columns of the output in registers.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

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


// ------------------------------------------------------------- tiled --

namespace tiled {

constexpr int NTY = 8;         // row groups: thread (ty, tx) owns rows ty + NTY i
constexpr int TQ = 8 * NTY;    // query rows a block
constexpr int TK = 128;        // keys a tile
constexpr int VC = 32;         // keys of a V chunk
constexpr int PLD = NTY * 8 + 4;  // a key's P: NTY row groups x 8 rows

// A block is NHF halves of 128 threads: at hd 256 half hf owns keys
// 64 hf .. 64 hf + 63 of each score tile (over every dim) and output dims
// 128 hf .. 128 hf + 127; below, one half owns everything. The chunks of a
// tile: K as TK keys x DC dims, V as VC keys x HD dims.
template <int HD>
struct Layout {
  static constexpr int NHF = HD > 128 ? 2 : 1;
  static constexpr int NT = 128 * NHF;             // threads
  static constexpr int JK = 8 / NHF;               // keys a thread a tile
  static constexpr int DC = HD > 128 ? 64 : 32;    // dims of a K chunk
  static constexpr int KLD = DC + 4;               // row stride of a K chunk
  static constexpr int QLD = HD + 4;               // Q and V chunk row stride
  static constexpr int CHUNK = TK * KLD > VC * QLD ? TK * KLD : VC * QLD;
  static constexpr int RED = NHF > 1 ? NHF * TQ : 0;  // the halves' row max
  static constexpr int FLOATS = TQ * QLD + TK * PLD + 2 * CHUNK + RED;
  static_assert(FLOATS * 4 <= 232448, "tiled: shared memory");
};

using hopper::smem_u32;

// 16 bytes from src, or zeros when src_bytes is 0
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

struct Args {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  int H, KVH, Sq, Skv, hd, bq, bk, causal, window, stride, n_kpad;
  float cap, scale;
};

// The thread's entries of the tile at k0 (bit 8i + j: row q0 + ty + 8i,
// key k0 + kx + 16j, j < JK): inc, in a running block of the caller's
// grid; keep, also unmasked. Whether the block must visit the tile: some
// entry is kept, or a row still at -1e30 (m) has an entry in a running
// block (tile_walk in kernels/flash_attention.py mirrors this). A tile
// wholly below the diagonal, inside the window and the KV tail, with no
// perforation, is full: every entry kept, no entry evaluated.
template <int JK>
__device__ bool tile_needed(const Args& a, int q0, int k0, int ty, int kx,
                            const float (&m)[8], uint64_t& inc,
                            uint64_t& keep) {
  const bool full = a.stride <= 1 && (!a.causal || k0 + TK - 1 <= q0) &&
                    (!a.window || k0 > q0 + TQ - 1 - a.window) &&
                    k0 + TK <= a.Skv;
  if (full) {                 // the same for every thread: no vote
    inc = keep = ~0ull;
    return true;
  }
  inc = keep = 0;
  int jb[JK];
#pragma unroll
  for (int j = 0; j < JK; ++j) jb[j] = (k0 + kx + 16 * j) / a.bk;
  bool need = false;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int qp = q0 + ty + NTY * i;
    if (qp >= a.Sq) continue;
    const int ib = qp / a.bq;
    uint32_t row_inc = 0;
#pragma unroll
    for (int j = 0; j < JK; ++j) {
      const int kp = k0 + kx + 16 * j;
      bool run = kp < a.n_kpad;
      if (a.causal) run = run && jb[j] * a.bk < (ib + 1) * a.bq;
      if (a.window) run = run && ib * a.bq - (jb[j] + 1) * a.bk < a.window;
      if (a.stride > 1) {
        const bool near = ib * a.bq - jb[j] * a.bk <= 2 * a.bq;
        run = run && (near || (ib - (jb[j] * a.bk) / a.bq) % a.stride == 0);
      }
      if (!run) continue;
      row_inc = 1;
      inc |= 1ull << (8 * i + j);
      if (kp < a.Skv && (!a.causal || kp <= qp) &&
          (!a.window || kp > qp - a.window))
        keep |= 1ull << (8 * i + j);
    }
    need = need || (row_inc && m[i] == NEG_INF);
  }
  return __syncthreads_or(need || keep != 0);
}

// HD is the instance's width; a.hd <= HD the inputs' (hd 80 runs the
// 128 instance: dims past a.hd land as zeros and are never stored).
template <int HD>
__global__ void __launch_bounds__(Layout<HD>::NT, 256 / Layout<HD>::NT)
    tiled_kernel(Args a) {
  using L = Layout<HD>;
  constexpr int JK = L::JK, DC = L::DC, KLD = L::KLD;
  constexpr int NO = HD / L::NHF / 64;          // float4 groups of O a row
  extern __shared__ __align__(16) float sm[];
  float* Qs = sm;                               // [TQ][QLD]
  float* Ps = Qs + TQ * L::QLD;                 // [TK][PLD]
  float* ring = Ps + TK * PLD;                  // 2 x CHUNK
  float* red = ring + 2 * L::CHUNK;             // [NHF][TQ]
  const int tid = threadIdx.x, hf = tid / 128, tx = tid & 15,
            ty = (tid & 127) >> 4;
  const int kx = hf * (TK / L::NHF) + tx;       // the thread's first key
  const int d0 = hf * (HD / L::NHF);            // its first output dim
  const int hd = a.hd, nkc = (hd + DC - 1) / DC, nch = nkc + TK / VC;
  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TQ;
  const int g = h / (a.H / a.KVH);
  const float* qb = a.q + ((size_t)b * a.H + h) * a.Sq * hd;
  const float* kb = a.k + ((size_t)b * a.KVH + g) * a.Skv * hd;
  const float* vb = a.v + ((size_t)b * a.KVH + g) * a.Skv * hd;

  // keys past the causal reach of the tile's last row never run; under a
  // window, keys below the first row's reach never do either
  int kend = a.n_kpad;
  if (a.causal) {
    const int i_last = (min(q0 + TQ, a.Sq) - 1) / a.bq;
    kend = min(kend, ((i_last + 1) * a.bq + a.bk - 1) / a.bk * a.bk);
  }
  const int nt = (kend + TK - 1) / TK;
  int t0 = 0;
  if (a.window) t0 = max(0, (q0 / a.bq) * a.bq - a.window - a.bk) / TK;

  float m[8], l[8], s[8][JK], o[8][4 * NO];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < 4 * NO; ++d) o[i][d] = 0.f;
  }

  // the chunks of a tile: K dims c * DC .. for c < nkc, then V keys
  // (c - nkc) * VC ..; rows past Skv and dims past hd land as zeros
  auto issue = [&](int t, int c, float* buf) {
    const int k0 = t * TK;
    if (c < nkc) {
      for (int e = tid; e < TK * (DC / 4); e += L::NT) {
        const int key = e / (DC / 4), d = c * DC + 4 * (e % (DC / 4));
        const bool ok = k0 + key < a.Skv && d < hd;
        cp_async16(buf + key * KLD + d - c * DC,
                   kb + (ok ? (size_t)(k0 + key) * hd + d : 0), ok ? 16 : 0);
      }
    } else {
      const int kv0 = k0 + (c - nkc) * VC;
      for (int e = tid; e < VC * (HD / 4); e += L::NT) {
        const int key = e / (HD / 4), d = 4 * (e % (HD / 4));
        const bool ok = kv0 + key < a.Skv && d < hd;
        cp_async16(buf + key * L::QLD + d,
                   vb + (ok ? (size_t)(kv0 + key) * hd + d : 0), ok ? 16 : 0);
      }
    }
  };

  for (int e = tid; e < TQ * (HD / 4); e += L::NT) {
    const int r = e / (HD / 4), d = 4 * (e % (HD / 4));
    const bool ok = q0 + r < a.Sq && d < hd;
    cp_async16(Qs + r * L::QLD + d,
               qb + (ok ? (size_t)(q0 + r) * hd + d : 0), ok ? 16 : 0);
  }
  uint64_t inc = 0, keep = 0, n_inc = 0, n_keep = 0;
  int t = t0;
  while (t < nt && !tile_needed<JK>(a, q0, t * TK, ty, kx, m, inc, keep))
    ++t;
  if (t < nt) issue(t, 0, ring);
  cp_commit();

  int c = 0, buf = 0;
  while (t < nt) {
    // the next chunk: this tile's next, or the first of the next tile the
    // block must visit (decided with m after this tile's softmax)
    int tn = t, cn = c + 1;
    if (cn == nch) {
      cn = 0;
      for (tn = t + 1; tn < nt; ++tn)
        if (tile_needed<JK>(a, q0, tn * TK, ty, kx, m, n_inc, n_keep)) break;
    }
    // one barrier a chunk: past it, this chunk has landed for every thread
    // and every thread is done with the previous one, whose buffer the
    // next chunk then fills while this one computes
    cp_wait0();
    __syncthreads();
    if (tn < nt) issue(tn, cn, ring + (buf ^ 1) * L::CHUNK);
    cp_commit();
    const float* cb = ring + buf * L::CHUNK;
    if (c < nkc) {
      if (c == 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < JK; ++j) s[i][j] = 0.f;
      }
      // S += Q[:, c DC ..] . K_chunk^T: 8 float4 of Q and JK of K a step
#pragma unroll 1
      for (int d4 = 0; d4 < DC / 4; ++d4) {
        float4 qv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          qv[i] = *reinterpret_cast<const float4*>(
              Qs + (ty + NTY * i) * L::QLD + c * DC + 4 * d4);
#pragma unroll
        for (int j = 0; j < JK; ++j) {
          const float4 kv = *reinterpret_cast<const float4*>(
              cb + (kx + 16 * j) * KLD + 4 * d4);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            float x = s[i][j];
            x = fmaf(qv[i].x, kv.x, x);
            x = fmaf(qv[i].y, kv.y, x);
            x = fmaf(qv[i].z, kv.z, x);
            s[i][j] = fmaf(qv[i].w, kv.w, x);
          }
        }
      }
      if (c == nkc - 1) {
        // the tile's scores are whole: mask, online softmax, P to smem;
        // the row max over the 16 threads of a half by shuffles, then
        // over the halves through shared memory
        float mx[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          mx[i] = -INFINITY;
#pragma unroll
          for (int j = 0; j < JK; ++j) {
            const int bit = 8 * i + j;
            float x;
            if ((keep >> bit) & 1ull) {
              x = s[i][j] * a.scale;
              if (a.cap != 0.f) x = a.cap * tanhf(x / a.cap);
            } else {
              x = ((inc >> bit) & 1ull) ? NEG_INF : -INFINITY;
            }
            s[i][j] = x;
            mx[i] = fmaxf(mx[i], x);
          }
#pragma unroll
          for (int off = 8; off > 0; off >>= 1)
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], off));
        }
        if constexpr (L::NHF > 1) {
          // red was last read before this tile's K chunks' barriers
          if (tx == 0)
#pragma unroll
            for (int i = 0; i < 8; ++i) red[hf * TQ + ty + NTY * i] = mx[i];
          __syncthreads();
#pragma unroll
          for (int i = 0; i < 8; ++i)
            mx[i] = fmaxf(mx[i], red[(hf ^ 1) * TQ + ty + NTY * i]);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float mn = fmaxf(m[i], mx[i]);
          const float alpha = __expf(m[i] - mn);
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < JK; ++j) {
            s[i][j] = __expf(s[i][j] - mn);
            sum += s[i][j];
          }
#pragma unroll
          for (int off = 8; off > 0; off >>= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, off);
          l[i] = l[i] * alpha + sum;      // this half's keys
          m[i] = mn;
#pragma unroll
          for (int d = 0; d < 4 * NO; ++d) o[i][d] *= alpha;
        }
#pragma unroll
        for (int j = 0; j < JK; ++j) {
          float* pj = Ps + (kx + 16 * j) * PLD + ty * 8;
          *reinterpret_cast<float4*>(pj) =
              make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
          *reinterpret_cast<float4*>(pj + 4) =
              make_float4(s[4][j], s[5][j], s[6][j], s[7][j]);
        }
      }
    } else {
      // O += P[:, keys of the chunk] . V_chunk: 2 float4 of P, NO of V a key
      const int kc0 = (c - nkc) * VC;
#pragma unroll 2
      for (int kk = 0; kk < VC; ++kk) {
        const float* pr = Ps + (kc0 + kk) * PLD + ty * 8;
        const float4 p0 = *reinterpret_cast<const float4*>(pr);
        const float4 p1 = *reinterpret_cast<const float4*>(pr + 4);
        const float pv[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
        for (int hh = 0; hh < NO; ++hh) {
          const float4 vv = *reinterpret_cast<const float4*>(
              cb + kk * L::QLD + d0 + 64 * hh + 4 * tx);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            o[i][4 * hh] = fmaf(pv[i], vv.x, o[i][4 * hh]);
            o[i][4 * hh + 1] = fmaf(pv[i], vv.y, o[i][4 * hh + 1]);
            o[i][4 * hh + 2] = fmaf(pv[i], vv.z, o[i][4 * hh + 2]);
            o[i][4 * hh + 3] = fmaf(pv[i], vv.w, o[i][4 * hh + 3]);
          }
        }
      }
    }
    if (cn == 0) {
      t = tn;
      inc = n_inc;
      keep = n_keep;
    }
    c = cn;
    buf ^= 1;
  }
  cp_wait0();  // the Q copies, when no tile ran

  if constexpr (L::NHF > 1) {
    // the row sums over both halves' keys (red's last reads lie before
    // the last tile's V chunks' barriers)
    if (tx == 0)
#pragma unroll
      for (int i = 0; i < 8; ++i) red[hf * TQ + ty + NTY * i] = l[i];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i) l[i] += red[(hf ^ 1) * TQ + ty + NTY * i];
  }
  float* ob = a.o + ((size_t)b * a.H + h) * a.Sq * hd;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = q0 + ty + NTY * i;
    if (r >= a.Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int hh = 0; hh < NO; ++hh) {
      const int d = d0 + 64 * hh + 4 * tx;
      if (d < hd)
        *reinterpret_cast<float4*>(ob + (size_t)r * hd + d) =
            make_float4(o[i][4 * hh] * inv, o[i][4 * hh + 1] * inv,
                        o[i][4 * hh + 2] * inv, o[i][4 * hh + 3] * inv);
    }
  }
}

template <int HD>
int launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * Layout<HD>::FLOATS;
  static bool granted = false;
  if (!granted) {
    cudaError_t err = cudaFuncSetAttribute(
        tiled_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    granted = true;
  }
  dim3 grid(a.H, (a.Sq + TQ - 1) / TQ, B);
  tiled_kernel<HD><<<grid, Layout<HD>::NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace tiled


}  // namespace

// dtype (of q, k, v and o): 0 = fp32, 1 = bf16; design: 0 = simple,
// 1 = tiled (fp32 at hd 64, 80, 128 or 256 only, every pointer 16-byte
// aligned); tc (design 2) is flash_tc.cu's flash_attention_tc. Needs hd a
// multiple of 16 up to 256, H a multiple of KVH, and bq, bk >= 1 (the
// caller's block grid, already clipped to Sq and Skv). Returns
// cudaGetLastError() of the launch.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int B, int H, int KVH, int Sq,
                               int Skv, int hd, int bq, int bk, int causal,
                               int window, int stride, float cap,
                               float scale, int dtype, int design,
                               void* stream) {
  if (hd <= 0 || hd > 256 || hd % 16 || KVH <= 0 || H % KVH || bq <= 0 ||
      bk <= 0 || Sq <= 0 || Skv <= 0 || B <= 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool fast_hd = hd == 64 || hd == 80 || hd == 128 || hd == 256;
  const bool aligned =
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16 == 0;
  // hd 80 runs the 128 instance, its dims past 80 zero-filled
  if (design == 1) {
    if (dtype != 0 || !fast_hd || !aligned || (Sq + 63) / 64 > 65535)
      return (int)cudaErrorInvalidValue;
    tiled::Args a{(const float*)q, (const float*)k, (const float*)v,
                  (float*)o, H, KVH, Sq, Skv, hd, bq, bk, causal, window,
                  stride, (Skv + bk - 1) / bk * bk, cap, scale};
    switch (hd) {
      case 64: return tiled::launch<64>(a, B, s);
      case 256: return tiled::launch<256>(a, B, s);
      default: return tiled::launch<128>(a, B, s);
    }
  }
  if (design != 0) return (int)cudaErrorInvalidValue;
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

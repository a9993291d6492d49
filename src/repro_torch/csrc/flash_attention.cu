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
// a clock an SM. Three designs, picked on the host
// (kernels/flash_attention.py select_flash_design):
//
// tc (bf16, hd 64 or 128: serving). A block takes one 64-row query tile of
//    one KV head and holds that head's query heads of the GQA group, up to
//    3 (heads beyond go to another block of the grid, the group split
//    as evenly as that allows): warpgroup 0 produces, warpgroup 1 + c is
//    the consumer of head c. One producer warp walks the key tiles the
//    block's rows need (the rule below, from each row's span of running
//    and kept keys; tile_walk mirrors it at the tile widths below) and keeps
//    K and V tiles in flight with TMA (3D maps, 128-byte swizzle, zero
//    fill past Skv: V = 0 in the padded tail) through a ring of 3 stages
//    guarded by full (K, V) and empty mbarriers, each stage's slot naming
//    its tile, -1 ending the walk; Q is loaded once. Each K/V tile is
//    staged once for every head of the block. setmaxnreg gives the
//    consumers the producer's registers. A consumer runs S = Q.K^T as
//    wgmma m64nTKk16 bf16 -> fp32 with both operands in shared memory,
//    then scale, softcap, mask and the online softmax on the accumulator
//    fragment in registers, in log2 units (log2 e folded into the scale;
//    cap tanh(x / cap) as cap (1 - 2 / (1 + 2^(2 x log2 e / cap))), one
//    ex2 and one rcp.approx; on a full tile without a cap the max is
//    taken over the raw sums and the scale folded into the exponent's
//    fma), P rounded to bf16 as the register A operand of O += P.V
//    (wgmma m64nHDk16, V the MN-major B operand through the descriptor).
//    The next tile's S is issued before this tile's P.V, each its own
//    wgmma group, and its softmax runs while P.V is on the tensor cores;
//    O is rescaled by alpha once P.V is done, and not at all when no row
//    of the warp moved its max (exact). Only tiles cut by the diagonal,
//    the window edge, the KV tail, perforation or the caller's grid pay
//    the per-entry rule; keys past the padded grid weigh nothing (-inf).
//    Tiles of 128 keys for blocks of 1 or 2 heads, 64 for 3 (S, P and O of
//    three heads at 128 keys would pass the 152 registers a consumer
//    thread gets). Blocks run heaviest query tile first, every head of a
//    batch side by side when the batch's K/V fit in half the L2, else one
//    KV head's tiles after another. No branch lies between a wgmma's issue
//    and its wait, and S's accumulator is written fresh each tile, so
//    ptxas keeps the wgmmas pipelined (no C7514/C7515 serialization).
// tiled (fp32, hd 64 or 128: the training path). A block of 128 threads
//    takes 64 query rows of one head; a key tile is 128 keys. Thread
//    (ty, tx) owns rows ty + 8i and keys tx + 16j (i, j < 8) of the score
//    tile, an 8 x 8 register tile, and rows ty + 8i by dims 4tx + 64h of
//    the output (8 x 8 at hd 128). Q sits in shared memory row-major; K
//    and V stream through a ring of two 18 KB buffers in chunks, K as 128
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
// simple (other dtypes and head sizes): one block of 256 threads per
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
constexpr int NT = 16 * NTY;   // threads: ty 0..NTY-1 x tx 0..15
constexpr int DC = 32;         // dims of a K chunk
constexpr int VC = 32;         // keys of a V chunk
constexpr int KLD = DC + 4;    // row stride (floats) of a K chunk
constexpr int PLD = NTY * 8 + 4;  // a key's P: NTY row groups x 8 rows

template <int HD>
struct Layout {
  static constexpr int QLD = HD + 4;           // Q and V chunk row stride
  static constexpr int CHUNK = TK * KLD > VC * QLD ? TK * KLD : VC * QLD;
  static constexpr int NKC = HD / DC;          // K chunks a tile
  static constexpr int NCH = NKC + TK / VC;    // chunks a tile
  static constexpr int FLOATS = TQ * QLD + TK * PLD + 2 * CHUNK;
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
  int H, KVH, Sq, Skv, bq, bk, causal, window, stride, n_kpad;
  float cap, scale;
};

// The thread's entries of the tile at k0 (bit 8i + j: row q0 + ty + 8i,
// key k0 + tx + 16j): inc, in a running block of the caller's grid; keep,
// also unmasked. Whether the block must visit the tile: some entry is
// kept, or a row still at -1e30 (m) has an entry in a running block
// (tile_walk in kernels/flash_attention.py mirrors this). A tile wholly
// below the diagonal, inside the window and the KV tail, with no
// perforation, is full: every entry kept, no entry evaluated.
__device__ bool tile_needed(const Args& a, int q0, int k0, int ty, int tx,
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
  int jb[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) jb[j] = (k0 + tx + 16 * j) / a.bk;
  bool need = false;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int qp = q0 + ty + NTY * i;
    if (qp >= a.Sq) continue;
    const int ib = qp / a.bq;
    uint32_t row_inc = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int kp = k0 + tx + 16 * j;
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

template <int HD>
__global__ void __launch_bounds__(NT, 256 / NT) tiled_kernel(Args a) {
  using L = Layout<HD>;
  constexpr int NO = HD / 64;                   // float4 groups of O a row
  extern __shared__ __align__(16) float sm[];
  float* Qs = sm;                               // [TQ][QLD]
  float* Ps = Qs + TQ * L::QLD;                 // [TK][PLD]
  float* ring = Ps + TK * PLD;                  // 2 x CHUNK
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TQ;
  const int g = h / (a.H / a.KVH);
  const float* qb = a.q + ((size_t)b * a.H + h) * a.Sq * HD;
  const float* kb = a.k + ((size_t)b * a.KVH + g) * a.Skv * HD;
  const float* vb = a.v + ((size_t)b * a.KVH + g) * a.Skv * HD;

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

  float m[8], l[8], s[8][8], o[8][4 * NO];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < 4 * NO; ++d) o[i][d] = 0.f;
  }

  // the chunks of a tile: K dims c * DC .. for c < NKC, then V keys
  // (c - NKC) * VC ..; rows past Skv land as zeros
  auto issue = [&](int t, int c, float* buf) {
    const int k0 = t * TK;
    if (c < L::NKC) {
      for (int e = tid; e < TK * (DC / 4); e += NT) {
        const int key = e / (DC / 4), f = e % (DC / 4);
        const bool ok = k0 + key < a.Skv;
        cp_async16(buf + key * KLD + 4 * f,
                   kb + (ok ? (size_t)(k0 + key) * HD + c * DC + 4 * f : 0),
                   ok ? 16 : 0);
      }
    } else {
      const int kv0 = k0 + (c - L::NKC) * VC;
      for (int e = tid; e < VC * (HD / 4); e += NT) {
        const int key = e / (HD / 4), f = e % (HD / 4);
        const bool ok = kv0 + key < a.Skv;
        cp_async16(buf + key * L::QLD + 4 * f,
                   vb + (ok ? (size_t)(kv0 + key) * HD + 4 * f : 0),
                   ok ? 16 : 0);
      }
    }
  };

  for (int e = tid; e < TQ * (HD / 4); e += NT) {
    const int r = e / (HD / 4), f = e % (HD / 4);
    const bool ok = q0 + r < a.Sq;
    cp_async16(Qs + r * L::QLD + 4 * f,
               qb + (ok ? (size_t)(q0 + r) * HD + 4 * f : 0), ok ? 16 : 0);
  }
  uint64_t inc = 0, keep = 0, n_inc = 0, n_keep = 0;
  int t = t0;
  while (t < nt && !tile_needed(a, q0, t * TK, ty, tx, m, inc, keep)) ++t;
  if (t < nt) issue(t, 0, ring);
  cp_commit();

  int c = 0, buf = 0;
  while (t < nt) {
    // the next chunk: this tile's next, or the first of the next tile the
    // block must visit (decided with m after this tile's softmax)
    int tn = t, cn = c + 1;
    if (cn == L::NCH) {
      cn = 0;
      for (tn = t + 1; tn < nt; ++tn)
        if (tile_needed(a, q0, tn * TK, ty, tx, m, n_inc, n_keep)) break;
    }
    // one barrier a chunk: past it, this chunk has landed for every thread
    // and every thread is done with the previous one, whose buffer the
    // next chunk then fills while this one computes
    cp_wait0();
    __syncthreads();
    if (tn < nt) issue(tn, cn, ring + (buf ^ 1) * L::CHUNK);
    cp_commit();
    const float* cb = ring + buf * L::CHUNK;
    if (c < L::NKC) {
      if (c == 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
      }
      // S += Q[:, c DC ..] . K_chunk^T: 8 float4 of Q and 8 of K a step
#pragma unroll 1
      for (int d4 = 0; d4 < DC / 4; ++d4) {
        float4 qv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          qv[i] = *reinterpret_cast<const float4*>(
              Qs + (ty + NTY * i) * L::QLD + c * DC + 4 * d4);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 kv = *reinterpret_cast<const float4*>(
              cb + (tx + 16 * j) * KLD + 4 * d4);
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
      if (c == L::NKC - 1) {
        // the tile's scores are whole: mask, online softmax, P to smem
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int bit = 8 * i + j;
            float x;
            if ((keep >> bit) & 1ull) {
              x = s[i][j] * a.scale;
              if (a.cap != 0.f) x = a.cap * tanhf(x / a.cap);
            } else {
              x = ((inc >> bit) & 1ull) ? NEG_INF : -INFINITY;
            }
            s[i][j] = x;
            mx = fmaxf(mx, x);
          }
#pragma unroll
          for (int off = 8; off > 0; off >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
          const float mn = fmaxf(m[i], mx);
          const float alpha = __expf(m[i] - mn);
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            s[i][j] = __expf(s[i][j] - mn);
            sum += s[i][j];
          }
#pragma unroll
          for (int off = 8; off > 0; off >>= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, off);
          l[i] = l[i] * alpha + sum;
          m[i] = mn;
#pragma unroll
          for (int d = 0; d < 4 * NO; ++d) o[i][d] *= alpha;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float* pj = Ps + (tx + 16 * j) * PLD + ty * 8;
          *reinterpret_cast<float4*>(pj) =
              make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
          *reinterpret_cast<float4*>(pj + 4) =
              make_float4(s[4][j], s[5][j], s[6][j], s[7][j]);
        }
      }
    } else {
      // O += P[:, keys of the chunk] . V_chunk: 2 float4 of P, 2 of V a key
      const int kc0 = (c - L::NKC) * VC;
#pragma unroll 2
      for (int kk = 0; kk < VC; ++kk) {
        const float* pr = Ps + (kc0 + kk) * PLD + ty * 8;
        const float4 p0 = *reinterpret_cast<const float4*>(pr);
        const float4 p1 = *reinterpret_cast<const float4*>(pr + 4);
        const float pv[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
        for (int hh = 0; hh < NO; ++hh) {
          const float4 vv = *reinterpret_cast<const float4*>(
              cb + kk * L::QLD + 64 * hh + 4 * tx);
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

  float* ob = a.o + ((size_t)b * a.H + h) * a.Sq * HD;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = q0 + ty + NTY * i;
    if (r >= a.Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int hh = 0; hh < NO; ++hh)
      *reinterpret_cast<float4*>(ob + (size_t)r * HD + 64 * hh + 4 * tx) =
          make_float4(o[i][4 * hh] * inv, o[i][4 * hh + 1] * inv,
                      o[i][4 * hh + 2] * inv, o[i][4 * hh + 3] * inv);
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
  tiled_kernel<HD><<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace tiled


// ---------------------------------------------------------------- tc --

namespace tc {

using namespace hopper;

constexpr int TQ = 64;           // query rows a block, for each of its heads
constexpr int STAGES = 3;        // K/V tiles in flight
constexpr long L2_HALF = 25L << 20;   // half the H100's 50 MB L2
constexpr int BOX = 64;          // dims a TMA box: 128 bytes, the swizzle's
constexpr int BOX_BYTES = 64 * 128;   // one box of 64 rows
constexpr int FULL = 1 << 30;    // slot flag: every entry of the tile kept
constexpr int MAX_HEADS = 3;     // consumer warpgroups a block
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  __nv_bfloat16* o;
  int H, KVH, Sq, Skv, bq, bk, causal, window, stride, n_kpad, ngrp, cap;
  int hgrp;   // head groups (blocks of a query tile) side by side
  float s2;   // scale log2(e): the score in log2 units when no cap is set
  float c1;   // 2 scale log2(e) / cap: e^(2 x scale / cap) = 2^(x c1)
  float c2;   // cap log2(e): cap tanh(.) in log2 units
};

// Shared memory, from a 1024-aligned base: Q of each head (HD / 64 boxes of
// 64 rows x 128 swizzled bytes), the K and the V ring (HD / 64 boxes of TK
// rows a tile), the barriers (Q; full K, full V and empty per stage) and a
// slot per stage naming its tile (-1: the walk is over).
template <int HD, int NH, int TK>
struct Layout {
  static constexpr int QTILE = TQ * HD * 2;  // a head's Q
  static constexpr int TILE = TK * HD * 2;   // a K or V tile
  static constexpr int KBOX = TK * 128;      // a K or V box: TK rows
  static constexpr int K = NH * QTILE;
  static constexpr int V = K + STAGES * TILE;
  static constexpr int BAR = V + STAGES * TILE;
  static constexpr int SLOT = BAR + 8 * (1 + 3 * STAGES);
  static constexpr int BYTES = SLOT + 4 * STAGES + 1024;
};

// Descriptor of V as the MN-major B operand of P.V: a key's 64 dims are a
// 128-byte swizzled row, 8 keys 1024 bytes apart (stride offset), the next
// 64 dims a box of TK keys further (leading offset).
template <int TK>
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)(TK * 128 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
// Keep the compiler from moving accumulator accesses across wgmma issue.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_frag(uint32_t (&p)[N][4]) {
#pragma unroll
  for (int i = 0; i < 4 * N; ++i)
    asm volatile("" : "+r"(p[i / 4][i % 4]) :: "memory");
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += A (64 x 16, K-major, smem) . B (64 x 16, K-major, smem)^T
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da,
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}
// d = A (64 x 16, K-major, smem) . B (64 x 16, K-major, smem)^T: the
// first k-step, D not read (a fresh accumulator, defined by the wgmma alone)
__device__ __forceinline__ void mma_ss_first(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(0));
}

// d += A (64 x 16, K-major, smem) . B (128 x 16, K-major, smem)^T
__device__ __forceinline__ void mma_ss(float (&d)[64], uint64_t da,
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}"
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}
// d = A (64 x 16, K-major, smem) . B (128 x 16, K-major, smem)^T: the
// first k-step, D not read (a fresh accumulator, defined by the wgmma alone)
__device__ __forceinline__ void mma_ss_first(float (&d)[64], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}"
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),
        "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]),
        "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]),
        "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
        "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(da), "l"(db), "r"(0));
}
// d += A (64 x 16, registers) . B (16 x 64, MN-major, smem)
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// d += A (64 x 16, registers) . B (16 x 128, MN-major, smem)
__device__ __forceinline__ void mma_rs(float (&d)[64], const uint32_t (&a)[4],
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// The entries of query row qp on the caller's (bq, bk) grid, ib = qp / bq:
// keys in [inc_lo, inc_hi) lie in a running block as far as the causal
// and window rules go (and below the padded grid n_kpad), keys in
// [keep_lo, keep_hi) are also kept by the mask. Perforation (stride > 1)
// skips further blocks (runs_stride).
struct Span {
  int ib, inc_lo, inc_hi, keep_lo, keep_hi;
};

__device__ __forceinline__ Span row_span(const Args& a, int qp) {
  Span r;
  r.ib = qp / a.bq;
  r.inc_lo = 0;
  r.inc_hi = a.n_kpad;
  // causal: jb bk < (ib + 1) bq; window: ib bq - (jb + 1) bk < window
  if (a.causal)
    r.inc_hi = min(r.inc_hi, ((r.ib + 1) * a.bq + a.bk - 1) / a.bk * a.bk);
  if (a.window) {
    const int x = r.ib * a.bq - a.window;
    if (x > 0) r.inc_lo = x / a.bk * a.bk;
  }
  r.keep_lo = a.window ? max(r.inc_lo, qp - a.window + 1) : r.inc_lo;
  r.keep_hi = min(r.inc_hi, a.Skv);
  if (a.causal) r.keep_hi = min(r.keep_hi, qp + 1);
  return r;
}

// The perforation rule for key block jb of row block ib (stride > 1).
__device__ __forceinline__ bool runs_stride(const Args& a, int ib, int jb) {
  return ib * a.bq - jb * a.bk <= 2 * a.bq ||
         (ib - (jb * a.bk) / a.bq) % a.stride == 0;
}

// Entry (row of r, kp): 3 if kept, 1 if masked in a running block
// (-1e30), 0 if its block is skipped or kp lies past the padded grid
// (-inf, weighs nothing).
__device__ __forceinline__ int entry(const Args& a, const Span& r, int kp) {
  if (kp < r.inc_lo || kp >= r.inc_hi) return 0;
  if (a.stride > 1 && !runs_stride(a, r.ib, kp / a.bk)) return 0;
  return kp >= r.keep_lo && kp < r.keep_hi ? 3 : 1;
}

// Bit 0: keys k0 .. k0 + TK - 1 hold an entry of a running block for the
// row of r; bit 1: a kept one.
template <int TK>
__device__ __forceinline__ int row_seen(const Args& a, const Span& r, int k0) {
  const int lo = max(r.inc_lo, k0), hi = min(r.inc_hi, k0 + TK);
  if (lo >= hi) return 0;
  if (a.stride <= 1)
    return 1 | (max(lo, r.keep_lo) < min(hi, r.keep_hi) ? 2 : 0);
  int seen = 0;
  for (int jb = lo / a.bk; jb * a.bk < hi && seen != 3; ++jb) {
    if (!runs_stride(a, r.ib, jb)) continue;
    const int blo = max(lo, jb * a.bk), bhi = min(hi, (jb + 1) * a.bk);
    seen |= 1 | (max(blo, r.keep_lo) < min(bhi, r.keep_hi) ? 2 : 0);
  }
  return seen;
}

// A tile below the diagonal, inside the window and the KV tail, with no
// perforation: every entry kept (a kept entry's block always runs at
// stride 1), none evaluated.
template <int TK>
__device__ __forceinline__ bool tile_full(const Args& a, int q0, int k0) {
  return a.stride <= 1 && (!a.causal || k0 + TK - 1 <= q0) &&
         (!a.window || k0 > q0 + TQ - 1 - a.window) && k0 + TK <= a.Skv;
}

// One block: query rows q0 .. q0 + 63 of heads h0 .. h0 + hcount - 1, all
// reading KV head kvh. Warpgroup 0 is the producer (its warp 0 walks the
// tiles; thread 0 issues TMA), warpgroup 1 + c the consumer of head
// h0 + c. Accumulator fragment (wgmma m64nN): warp w of a warpgroup holds
// rows 16w .. 16w + 15; lane (g = lane / 4, t = lane % 4) holds
// d[4j + 2h + b] = (row 16w + g + 8h, column 8j + 2t + b).
template <int HD, int NH, int TK>
__global__ void __launch_bounds__(128 * (NH + 1), 1)
    tc_kernel(const __grid_constant__ CUtensorMap mq,
              const __grid_constant__ CUtensorMap mk,
              const __grid_constant__ CUtensorMap mv, const Args a) {
  using L = Layout<HD, NH, TK>;
  constexpr int NS = TK / 2;                    // S registers a thread
  constexpr int NB = HD / BOX;                  // boxes a row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t bar_q = base + L::BAR, bar_k = bar_q + 8,
                 bar_v = bar_k + 8 * STAGES, bar_e = bar_v + 8 * STAGES;
  volatile int* slots =
      reinterpret_cast<volatile int*>(smem_raw + (base - raw) + L::SLOT);

  const int R = a.H / a.KVH;
  // Block order (x): a.hgrp head groups at a time, their query tiles
  // heaviest first (causal), the groups of a query tile side by side.
  const int nq = (a.Sq + TQ - 1) / TQ, nhy = a.KVH * a.ngrp;
  const int gi = blockIdx.x / (nq * a.hgrp), g0 = gi * a.hgrp;
  const int gsz = min(a.hgrp, nhy - g0), rem = blockIdx.x - g0 * nq;
  const int qx = rem / gsz, hy = g0 + rem % gsz;
  const int kvh = hy / a.ngrp, grp = hy % a.ngrp;
  const int h0 = kvh * R + grp * NH, hcount = min(NH, R - grp * NH);
  const int b = blockIdx.y;
  const int q0 = (nq - 1 - qx) * TQ;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_e + 8 * s, hcount);     // one arrive per consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    if constexpr (NH > 1)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x >= 32) return;
    // producer: Q once, then the walk. A tile is visited when it keeps an
    // entry, or a row that has kept none yet has an entry of a running
    // block in it (kernels/flash_attention.py tile_walk mirrors this);
    // lane l judges rows q0 + l and q0 + l + 32.
    const int lane = threadIdx.x;
    if (lane == 0) {
      mbar_expect_tx(bar_q, hcount * L::QTILE);
      for (int i = 0; i < hcount; ++i)
        for (int x = 0; x < NB; ++x)
          tma_load(base + i * L::QTILE + x * BOX_BYTES, &mq, bar_q, x * BOX,
                   q0, b * a.H + h0 + i);
    }
    int kend = a.n_kpad;
    if (a.causal) {
      const int i_last = (min(q0 + TQ, a.Sq) - 1) / a.bq;
      kend = min(kend, ((i_last + 1) * a.bq + a.bk - 1) / a.bk * a.bk);
    }
    const int nt = (kend + TK - 1) / TK;
    int t = 0;
    if (a.window) t = max(0, (q0 / a.bq) * a.bq - a.window - a.bk) / TK;
    const Span sp[2] = {row_span(a, q0 + lane), row_span(a, q0 + lane + 32)};
    bool kept[2] = {false, false};
    int s = 0;
    uint32_t ph = 0;
    for (; t < nt; ++t) {
      const int k0 = t * TK;
      const bool full = tile_full<TK>(a, q0, k0);
      bool need = full;
      if (!full) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (q0 + lane + 32 * i >= a.Sq) continue;
          const int seen = row_seen<TK>(a, sp[i], k0);
          need = need || (seen & 2) || ((seen & 1) && !kept[i]);
          kept[i] = kept[i] || (seen & 2);
        }
        need = __any_sync(0xffffffffu, need);
      }
      if (!need) continue;
      mbar_wait(bar_e + 8 * s, ph ^ 1);
      if (lane == 0) {
        slots[s] = t | (full ? FULL : 0);
        mbar_expect_tx(bar_k + 8 * s, L::TILE);
        for (int x = 0; x < NB; ++x)
          tma_load(base + L::K + s * L::TILE + x * L::KBOX, &mk,
                   bar_k + 8 * s, x * BOX, k0, b * a.KVH + kvh);
        mbar_expect_tx(bar_v + 8 * s, L::TILE);
        for (int x = 0; x < NB; ++x)
          tma_load(base + L::V + s * L::TILE + x * L::KBOX, &mv,
                   bar_v + 8 * s, x * BOX, k0, b * a.KVH + kvh);
      }
      __syncwarp();
      if (++s == STAGES) { s = 0; ph ^= 1; }
    }
    mbar_wait(bar_e + 8 * s, ph ^ 1);
    if (lane == 0) {
      slots[s] = -1;
      mbar_arrive(bar_k + 8 * s);
    }
    return;
  }

  if constexpr (NH == 2)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  if constexpr (NH == 3)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 152;\n");
  const int c = wg - 1;
  if (c >= hcount) return;
  const int w = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rows[2] = {q0 + 16 * w + g, q0 + 16 * w + g + 8};
  const uint32_t qs = base + c * L::QTILE;

  float o[HD / 2], sc[NS];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  // S = Q . K^T of the tile in stage s on the tensor cores, fp32 sums
  auto issue_qk = [&](int s) {
    const uint32_t ks = base + L::K + s * L::TILE;
    mma_ss_first(sc, desc_sw128(qs), desc_sw128(ks));
#pragma unroll
    for (int kk = 1; kk < HD / 16; ++kk)
      mma_ss(sc, desc_sw128(qs + (kk / 4) * BOX_BYTES) + 2 * (kk % 4),
             desc_sw128(ks + (kk / 4) * L::KBOX) + 2 * (kk % 4));
  };
  // O += P . V, V of stage s from shared memory as the MN-major B operand
  auto issue_pv = [&](int s, uint32_t (&pa)[TK / 16][4]) {
    const uint32_t vs = base + L::V + s * L::TILE;
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk)
      mma_rs(o, pa[kk], desc_mn<TK>(vs + kk * 2048));
  };
  // The online softmax of the scores in sc (the tile named by slot), in
  // place: sc becomes P in fp32, m and l are updated, and alpha is the
  // factor O must take before this tile's P.V.
  float alpha[2];
  auto softmax = [&](int slot) {
    // scores in log2 units: x scale, or cap tanh(x scale / cap) as
    // cap (1 - 2 / (1 + e^(2 x scale / cap))), one ex2 and one rcp. A
    // full tile without a cap takes the max of the raw sums (scale > 0
    // keeps the order) and folds the scale into the exponent's fma.
    if (!a.cap && (slot & FULL)) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < TK / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          mx[h] = fmaxf(mx[h],
                        fmaxf(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        mx[h] = fmaxf(m[h], mx[h] * a.s2);
        alpha[h] = ex2(m[h] - mx[h]);
        m[h] = mx[h];
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int j = 0; j < TK / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int bb = 0; bb < 2; ++bb) {
            float& x = sc[4 * j + 2 * h + bb];
            x = ex2(fmaf(x, a.s2, -mx[h]));
            l[h] += x;
          }
      return;
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      if (a.cap) {
        const float u = ex2(sc[i] * a.c1);
        sc[i] = fmaf(-2.f * a.c2, rcp(1.f + u), a.c2);
      } else {
        sc[i] *= a.s2;
      }
    }
    if (!(slot & FULL)) {
      const int k0 = (slot & (FULL - 1)) * TK;
      const Span sp[2] = {row_span(a, rows[0]), row_span(a, rows[1])};
#pragma unroll
      for (int j = 0; j < TK / 8; ++j)
#pragma unroll
        for (int bb = 0; bb < 2; ++bb)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = entry(a, sp[h], k0 + 8 * j + 2 * t4 + bb);
            float& x = sc[4 * j + 2 * h + bb];
            if (e != 3) x = e ? NEG_INF : -INFINITY;
          }
    }
    // the max over the quad of lanes that shares a row
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < TK / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        mx[h] = fmaxf(mx[h], fmaxf(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = ex2(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int j = 0; j < TK / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int bb = 0; bb < 2; ++bb) {
          float& x = sc[4 * j + 2 * h + bb];
          x = ex2(x - mx[h]);
          l[h] += x;
        }
  };
  // P in bf16 as the register A operand: its k16 slice kk is columns
  // 16 kk .. 16 kk + 15 of the accumulator, pairs packed in order.
  uint32_t pa[TK / 16][4];
  auto pack = [&]() {
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
  };

  // exact to skip: no row of the warp moved its max (alpha 1)
  auto rescale = [&]() {
    if (!__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) return;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        o[4 * j + 2 * h] *= alpha[h];
        o[4 * j + 2 * h + 1] *= alpha[h];
      }
  };
  auto issue_s = [&](int s) {
    fence_acc(sc);
    wg_fence();
    issue_qk(s);
    wg_commit();
    fence_acc(sc);
  };
  auto issue_o = [&](int s) {
    fence_acc(o);
    fence_frag(pa);
    wg_fence();
    issue_pv(s, pa);
    wg_commit();
    fence_acc(o);
    fence_frag(pa);
  };
  // Each step issues S of the next tile, then P.V of this one (each its
  // own wgmma group), and runs the next tile's softmax while P.V is on
  // the tensor cores; P is packed once P.V is done. No branch lies between
  // a product's issue and its wait.
  mbar_wait(bar_q, 0);
  mbar_wait(bar_k, 0);
  int slot = slots[0];
  if (slot >= 0) {
    issue_s(0);
    wg_wait<0>();
    fence_acc(sc);
    softmax(slot);
    pack();
    int s = 0;
    uint32_t ph = 0;
    for (;;) {
      const int s1 = s + 1 == STAGES ? 0 : s + 1;
      const uint32_t ph1 = s1 == 0 ? ph ^ 1 : ph;
      mbar_wait(bar_k + 8 * s1, ph1);
      slot = slots[s1];
      if (slot < 0) break;
      rescale();
      mbar_wait(bar_v + 8 * s, ph);
      issue_s(s1);
      issue_o(s);
      wg_wait<1>();
      fence_acc(sc);
      softmax(slot);
      wg_wait<0>();
      fence_acc(o);
      fence_frag(pa);
      if (threadIdx.x % 128 == 0) mbar_arrive(bar_e + 8 * s);
      pack();
      s = s1;
      ph = ph1;
    }
    rescale();                              // the last tile's P.V
    mbar_wait(bar_v + 8 * s, ph);
    issue_o(s);
    wg_wait<0>();
    fence_acc(o);
    if (threadIdx.x % 128 == 0) mbar_arrive(bar_e + 8 * s);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  __nv_bfloat16* ob = a.o + ((size_t)b * a.H + h0 + c) * a.Sq * HD;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rows[h] >= a.Sq) continue;
    const float inv = 1.f / fmaxf(l[h], 1e-30f);
    __nv_bfloat16* orow = ob + (size_t)rows[h] * HD + 2 * t4;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * h] * inv,
                                o[4 * j + 2 * h + 1] * inv);
  }
}

// A (heads, rows, hd) bf16 tensor in boxes of 64 dims x box_rows rows x 1
// head, 128-byte swizzle; rows past `rows` of a head read as 0.
bool tensor_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                int heads, int rows, int hd, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)rows * hd * 2};
  const cuuint32_t box[3] = {(cuuint32_t)BOX, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, int NH, int TK>
int launch(const void* q, const void* k, const void* v, int B, const Args& a,
           cudaStream_t stream) {
  const EncodeTiled encode = encoder();
  if (!encode) return (int)cudaErrorNotSupported;
  CUtensorMap mq, mk, mv;
  if (!tensor_map(encode, &mq, q, B * a.H, a.Sq, HD, TQ) ||
      !tensor_map(encode, &mk, k, B * a.KVH, a.Skv, HD, TK) ||
      !tensor_map(encode, &mv, v, B * a.KVH, a.Skv, HD, TK))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = Layout<HD, NH, TK>::BYTES;
  static bool granted = false;
  if (!granted) {
    cudaError_t e = cudaFuncSetAttribute(
        tc_kernel<HD, NH, TK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    granted = true;
  }
  dim3 grid((a.Sq + TQ - 1) / TQ * a.KVH * a.ngrp, B);
  tc_kernel<HD, NH, TK><<<grid, 128 * (NH + 1), smem, stream>>>(mq, mk, mv,
                                                                a);
  return (int)cudaGetLastError();
}

// The GQA group of R = H / KVH heads in ngrp blocks of up to MAX_HEADS.
template <int HD>
int dispatch(const void* q, const void* k, const void* v, int B, Args a,
             cudaStream_t s) {
  const int R = a.H / a.KVH;
  a.ngrp = (R + MAX_HEADS - 1) / MAX_HEADS;
  const int nh = (R + a.ngrp - 1) / a.ngrp;
  if ((long)(a.Sq + TQ - 1) / TQ * a.KVH * a.ngrp > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  // Every head at each query tile, heaviest first, when a batch's K and V
  // fit in half the L2 (phi4-mini's training cell, 16.8 MB: 0.386 against
  // 0.406 ms head by head); else one KV head's query tiles after another,
  // the blocks at the card sharing that head's K/V (gemma2-27b's prefill,
  // 62 MB: 0.877 against 0.927-0.958 ms in groups of 3 to 10 heads; H100,
  // tools/flash_bench.py).
  const bool all_heads = (long)a.KVH * a.Skv * HD * 4 <= L2_HALF;
  a.hgrp = all_heads ? a.KVH * a.ngrp : a.ngrp;
  switch (nh) {
    case 1: return launch<HD, 1, 128>(q, k, v, B, a, s);
    case 2: return launch<HD, 2, 128>(q, k, v, B, a, s);
    default: return launch<HD, 3, 64>(q, k, v, B, a, s);
  }
}

}  // namespace tc
}  // namespace

// dtype (of q, k, v and o): 0 = fp32, 1 = bf16; design: 0 = simple,
// 1 = tiled (fp32, hd 64 or 128 only), 2 = tc (bf16, hd 64 or 128, every
// pointer 16-byte aligned). Needs hd a multiple of 16 up to 256,
// H a multiple of KVH, and bq, bk >= 1 (the caller's block grid, already
// clipped to Sq and Skv). Returns cudaGetLastError() of the launch.
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
  if (design == 1) {
    if (dtype != 0 || (hd != 64 && hd != 128) || (Sq + 63) / 64 > 65535)
      return (int)cudaErrorInvalidValue;
    tiled::Args a{(const float*)q, (const float*)k, (const float*)v,
                  (float*)o, H, KVH, Sq, Skv, bq, bk, causal, window,
                  stride, (Skv + bk - 1) / bk * bk, cap, scale};
    return hd == 64 ? tiled::launch<64>(a, B, s) : tiled::launch<128>(a, B, s);
  }
  if (design == 2) {
    if (dtype != 1 || (hd != 64 && hd != 128) ||
        ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16)
      return (int)cudaErrorInvalidValue;
    tc::Args a{(__nv_bfloat16*)o, H, KVH, Sq, Skv, bq, bk, causal, window,
               stride, (Skv + bk - 1) / bk * bk, 1, cap != 0.f, 1,
               scale * tc::LOG2E,
               cap != 0.f ? 2.f * scale * tc::LOG2E / cap : 0.f,
               cap * tc::LOG2E};
    return hd == 64 ? tc::dispatch<64>(q, k, v, B, a, s)
                    : tc::dispatch<128>(q, k, v, B, a, s);
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

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
// Both designs evaluate that rule for every entry on the caller's (bq, bk)
// grid, whatever their own tiles are: an entry of a skipped block is left
// out (score -inf, p = 0), a masked entry of a running block takes -1e30
// and so contributes exp(-1e30 - m), 1 while its row's max is still -1e30,
// as in the Pallas body (the KV tail up to the padded grid counts, with
// V = 0). A key tile is skipped unless it holds a kept entry or a row
// still at -1e30 has an entry of a running block in it.
//
// Bound on the H100: fp32 operations at the training shape. A causal
// (batch, head) of S = 4096, hd = 128 needs ~4.3 GFLOP (Q.K^T and P.V over
// the lower triangle) against 4 MB of q, k, v and o: far above the card's
// fp32 ridge of ~20 FLOP/byte, so the products' FMAs on the CUDA cores (TF32
// stays off: fp32 is the path's dtype) and the shared-memory reads that
// feed them set the pace. Two designs, picked on the host
// (kernels/flash_attention.py select_flash_design):
//
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
// simple (bf16, and fp32 at other hd): one block of 256 threads per
//    (query tile of 64 rows, head, batch). Q transposed in shared memory;
//    K staged transposed with scalar loads, a 4 x 4 register tile of scores
//    a thread, rows' max and sum across 16 threads by shuffles, P to shared
//    memory, then V staged into the same buffer and each thread
//    accumulating its 4 rows x hd/16 columns of the output in registers.
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
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
}  // namespace

// dtype (of q, k, v and o): 0 = fp32, 1 = bf16; design: 0 = simple,
// 1 = tiled (fp32, hd 64 or 128 only). Needs hd a multiple of 16 up to 256,
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

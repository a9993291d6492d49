// One hop of ring attention (chunked prefill over sequence shards) for
// Hopper (sm_90a), one launch for every shard that runs at a hop step.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ring_attention.py
// (_hop / _hop_kernel). The resident queries q (B,H,Cl,hd) of shard d meet
// the visiting K/V shard src, k, v (B,KVH,Ll,hd); query head h reads KV
// head h / (H / KVH). The online-softmax state enters and leaves through
// m, l (B,H,Cl,1) and acc (B,H,Cl,hd), fp32, UPDATED IN PLACE. Masking is
// by explicit position: query row r sits at qp[b][r], key c at kvp[b][c],
// -1 = empty; a pair is visible when both are >= 0, kv <= q and, with a
// window, kv > q - window. Scores s = (q . k) * scale (K/V times kv_scale
// when it is nonzero: int8 dequantised), optionally cap * tanh(s / cap);
// masked entries take -1e30 in the row max and weigh exactly 0 in l and
// acc, so a row with nothing visible keeps its state, as in the Pallas body.
//
// Every tensor is a stack over shards: q, qp, m, l, acc carry a leading
// shard index d, k, v, kvp one of src, and the launch runs the (d, src)
// pairs it is given (by value, in the kernel's arguments) as the grid's z
// dimension with the batch. A single hop is the pair (0, 0).
//
// Bound on the H100: at the phi4-mini cell's hop (H 24, KVH 8, Cl 512,
// Ll 4096, hd 128, bf16) a fully visible hop is ~25.8 GFLOP of products
// against ~33 MB of q, K/V and the fp32 state read and written: operations,
// far above the ridge. Two designs, picked on the host
// (kernels/ring_attention.py select_hop_design):
//
// tc (bf16 queries, bf16 or int8 K/V, hd 64 or 128): tensor cores.
//    A block is one 64-row query tile of one KV head and holds that head's
//    R query heads (4 warps a head, 16 rows a warp), up to a cap set by the
//    registers (3 heads at hd 128, 4 at hd 64); heads beyond it go to
//    another block on the grid's y dimension. Each K/V tile is thus staged
//    once for all heads of a GQA group. A prologue reads the hop's key
//    positions once and lists the 64-key tiles that hold a visible pair for
//    the block's rows (the Pallas kernel's position-bound skip) and marks
//    the tiles where every pair is visible (no per-pair mask); the main
//    loop walks that list with the K and V tiles in three cp.async stages
//    of shared memory, so two tiles load while one computes, with one
//    barrier a tile (int8 tiles land in a staging buffer and the warps
//    widen them to bf16, exactly, behind a second barrier). Each warp keeps
//    its 16 rows of Q as mma A fragments in registers for the whole hop.
//    S = Q.K^T runs on mma.sync m16n8k16 bf16 with fp32 sums (bf16 x bf16
//    products are exact in fp32; K from ldmatrix); kv_scale and scale
//    multiply the fp32 score. The row max and sum are reduced across the
//    quad of lanes that shares a row; l sums the fp32 P. P.V keeps fp32
//    accuracy: P (times kv_scale for int8 V) is split into hi = bf16(P) and
//    lo = bf16(P - hi), two MMAs of the same V fragment (ldmatrix.trans)
//    each, residual <= 2^-16 |P| a term. Each tile's P.V sums in a fresh
//    fragment over its 64 keys and is added to the running acc in fp32 on
//    the CUDA cores, so the tensor cores' own accumulation never runs a
//    chain longer than one tile. A warp whose 16 rows see no key of a tile
//    computes nothing for it. The split does 1.5x the function's product
//    work. What holds it back: every warp reads the whole K and V tile
//    through ldmatrix (16 rows of MMA work per 32 KB a tile), and the
//    warps of a block run the products, the softmax and P.V in step.
// simt (any other dtype pair): every product an fp32 FMA on the CUDA
//    cores. One block of 256 threads per (query tile of 64 rows, head,
//    batch x pair); Q staged transposed in shared memory, K then V staged
//    (dequantised) into one buffer, a 4 x 4 register tile of scores a
//    thread, rows' max and sum combined across 16 threads by shuffles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BQ = 64;         // query rows per block (both designs)
constexpr int BK = 64;         // keys per tile (both designs)
constexpr int MAX_PAIRS = 64;  // shards one launch runs
constexpr float NEG_INF = -1e30f;

struct HopArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* qp;
  const int* kvp;
  float* m;
  float* l;
  float* acc;
  int B, H, KVH, Cl, Ll, hd, window;
  float cap, kvs, scale;
};

// (d, src) of each running shard: the grid's z is b + B * pair.
struct Pairs {
  int d[MAX_PAIRS];
  int src[MAX_PAIRS];
};

__device__ __forceinline__ bool visible(int qpos, int kpos, int window) {
  return qpos >= 0 && kpos >= 0 && kpos <= qpos &&
         (!window || kpos > qpos - window);
}

// ------------------------------------------------------------------ simt --

constexpr int THREADS = 256;   // 16 x 16: ty owns rows 4ty.., tx keys 4tx..
constexpr int LD = BQ + 4;     // stride (floats) of the transposed tiles

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load_f(const int8_t* p) {
  return (float)*p;
}

size_t simt_smem_bytes(int hd) {
  return sizeof(float) * ((size_t)2 * hd * LD + (size_t)BK * LD);
}

// NJ >= hd / 16: the acc columns (tx + 16 * jj) each thread owns.
template <typename TQ, typename TKV, int NJ>
__global__ void __launch_bounds__(THREADS)
    simt_kernel(HopArgs a, Pairs pr) {
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // hd x LD: Qt[d][r]
  const int hd = a.hd, H = a.H, Cl = a.Cl, Ll = a.Ll;
  float* KV = Qt + hd * LD;   // K as Kt[d][c] (hd x LD), then V[c][d]
  float* Ps = KV + hd * LD;   // BK x LD: Ps[c][r]
  const float kvs = a.kvs, scale = a.scale, cap = a.cap;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z % a.B, pi = blockIdx.z / a.B;
  const int d = pr.d[pi], src = pr.src[pi];
  const int g = h / (H / a.KVH);
  const int nj = hd >> 4;
  const size_t qrow0 = ((size_t)d * a.B + b) * H * Cl + (size_t)h * Cl;
  const TQ* qb = (const TQ*)a.q + qrow0 * hd;
  const size_t kvrow0 = (((size_t)src * a.B + b) * a.KVH + g) * Ll;
  const TKV* kb = (const TKV*)a.k + kvrow0 * hd;
  const TKV* vb = (const TKV*)a.v + kvrow0 * hd;
  const int* qpb = a.qp + ((size_t)d * a.B + b) * Cl;
  const int* kpb = a.kvp + ((size_t)src * a.B + b) * Ll;

  for (int e = tid; e < BQ * hd; e += THREADS) {
    const int r = e / hd, c = e - r * hd;
    Qt[c * LD + r] = q0 + r < Cl ? load_f(qb + (size_t)(q0 + r) * hd + c)
                                 : 0.f;
  }

  // this thread's rows: positions (-1 past Cl) and carried state
  int qpos[4];
  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    qpos[i] = r < Cl ? qpb[r] : -1;
    m[i] = r < Cl ? a.m[qrow0 + r] : NEG_INF;
    l[i] = r < Cl ? a.l[qrow0 + r] : 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
      acc[i][jj] = (r < Cl && jj < nj)
                       ? a.acc[(qrow0 + r) * hd + tx + 16 * jj]
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
        if (visible(qpos[i], kpos[j], a.window)) keep |= 1u << (4 * i + j);
    // a tile with no visible pair changes nothing; also the barrier before
    // KV and Ps are overwritten (and after the Q tile is stored)
    if (!__syncthreads_or(keep != 0)) continue;

    for (int e = tid; e < BK * hd; e += THREADS) {
      const int c = e / hd, dd = e - c * hd;
      KV[dd * LD + c] =
          k0 + c < Ll ? load_f(kb + (size_t)(k0 + c) * hd + dd) * kvs : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int dd = 0; dd < hd; ++dd) {
      const float4 qa =
          *reinterpret_cast<const float4*>(Qt + dd * LD + ty * 4);
      const float4 ka =
          *reinterpret_cast<const float4*>(KV + dd * LD + tx * 4);
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
      a.m[qrow0 + r] = m[i];
      a.l[qrow0 + r] = l[i];
    }
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
      if (jj < nj) a.acc[(qrow0 + r) * hd + tx + 16 * jj] = acc[i][jj];
  }
}

template <typename TQ, typename TKV, int NJ>
int launch_simt(const HopArgs& a, const Pairs& pr, int n_run,
                cudaStream_t stream) {
  const size_t smem = simt_smem_bytes(a.hd);
  cudaError_t err = cudaFuncSetAttribute(
      simt_kernel<TQ, TKV, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Cl + BQ - 1) / BQ, a.H, a.B * n_run);
  simt_kernel<TQ, TKV, NJ><<<grid, THREADS, smem, stream>>>(a, pr);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV>
int simt_by_hd(const HopArgs& a, const Pairs& pr, int n_run,
               cudaStream_t s) {
  if (a.hd <= 64) return launch_simt<TQ, TKV, 4>(a, pr, n_run, s);
  if (a.hd <= 128) return launch_simt<TQ, TKV, 8>(a, pr, n_run, s);
  return launch_simt<TQ, TKV, 16>(a, pr, n_run, s);
}

template <typename TQ>
int simt_by_kv(int kv_dtype, const HopArgs& a, const Pairs& pr, int n_run,
               cudaStream_t s) {
  switch (kv_dtype) {
    case 0: return simt_by_hd<TQ, float>(a, pr, n_run, s);
    case 1: return simt_by_hd<TQ, __nv_bfloat16>(a, pr, n_run, s);
    case 2: return simt_by_hd<TQ, int8_t>(a, pr, n_run, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// -------------------------------------------------------------------- tc --

// Query heads a block holds, by head width: 4 warps a head, and the warps'
// registers (16 rows of Q fragments and of acc a warp) set the cap.
template <int HD>
struct TcCap;
template <>
struct TcCap<64> { static constexpr int HEADS = 4; };
template <>
struct TcCap<128> { static constexpr int HEADS = 3; };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16 bytes global -> shared, zero-filled where src_bytes is 0.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
// c += a (16 x 16, row) . b (16 x 8, col), bf16 in, fp32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
// (x0, x1) -> bf16 hi and lo halves: x = hi + lo + O(2^-16 |x|)
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}
// 2^x on the special-function unit (denormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

constexpr int STAGES = 3;   // cp.async stages of the tc design's K/V tiles

template <typename TKV, int HD>
constexpr size_t tc_smem_base() {
  // bf16 K and V tiles (a stage each for bf16 K/V, one tile for int8), int8
  // staging (int8 only), key positions, the block's bounds and tile count
  return (std::is_same<TKV, int8_t>::value
              ? 2 * (size_t)BK * (HD + 8) * 2 + 2 * STAGES * (size_t)BK * HD
              : 2 * STAGES * (size_t)BK * (HD + 8) * 2) +
         STAGES * BK * sizeof(int) + 4 * sizeof(int);
}

// The online-softmax update of one 64-key tile for a warp's rows ra
// (score elements 0, 1) and rb (2, 3): s holds the dot products on entry
// and P on exit; m, l advance and alpha is returned for acc. Without a cap
// the max is taken over the raw dot products (sk > 0 keeps their order, and
// rounding is monotonic) and sk folds into the exponent. ALL: every element
// is visible (no per-element mask).
template <bool ALL>
__device__ __forceinline__ void tile_softmax(float (&s)[8][4], uint32_t keep,
                                             float sk, float cap, float& m0,
                                             float& m1, float& l0, float& l1,
                                             float& al0, float& al1) {
  constexpr float LOG2E = 1.4426950408889634f;
  const bool capped = cap != 0.f;
  if (capped) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) s[j][x] = cap * tanhf(s[j][x] * sk / cap);
  }
  float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      if (ALL || (keep & (1u << (4 * j + x)))) {
        if (x < 2) mx0 = fmaxf(mx0, s[j][x]);
        else mx1 = fmaxf(mx1, s[j][x]);
      }
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);
  if (!capped) {
    mx0 = mx0 == NEG_INF ? NEG_INF : mx0 * sk;
    mx1 = mx1 == NEG_INF ? NEG_INF : mx1 * sk;
  }
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  al0 = mn0 == m0 ? 1.f : ex2((m0 - mn0) * LOG2E);
  al1 = mn1 == m1 ? 1.f : ex2((m1 - mn1) * LOG2E);
  const float c1 = capped ? LOG2E : sk * LOG2E;
  const float b0 = -mn0 * LOG2E, b1 = -mn1 * LOG2E;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      float p = ex2(fmaf(s[j][x], c1, x < 2 ? b0 : b1));
      if (!ALL && !(keep & (1u << (4 * j + x)))) p = 0.f;
      if (x < 2) sum0 += p;
      else sum1 += p;
      s[j][x] = p;
    }
  l0 = l0 * al0 + quad_sum(sum0);
  l1 = l1 * al1 + quad_sum(sum1);
  m0 = mn0;
  m1 = mn1;
}

template <typename TKV, int HD>
__global__ void __launch_bounds__(TcCap<HD>::HEADS * 128, 1)
    tc_kernel(HopArgs a, Pairs pr) {
  constexpr bool I8 = std::is_same<TKV, int8_t>::value;
  constexpr int LDS = HD + 8;  // bf16 row stride: ldmatrix conflict-free
  constexpr int NKK = HD / 16;
  constexpr int NO = HD / 8;
  constexpr int NBUF = I8 ? 1 : STAGES;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* Kb = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* Vb = Kb + NBUF * BK * LDS;
  int8_t* Kst = reinterpret_cast<int8_t*>(Vb + NBUF * BK * LDS);
  int8_t* Vst = Kst + (I8 ? STAGES * BK * HD : 0);
  int* kps = reinterpret_cast<int*>(Vst + (I8 ? STAGES * BK * HD : 0));
  int* sinfo = kps + STAGES * BK;   // the query bounds, then the tiles' count
  int* tiles = sinfo + 4;      // the running tiles' indices

  const int Cl = a.Cl, Ll = a.Ll, window = a.window;
  const int nthr = blockDim.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthr >> 5;
  const int nh = nthr >> 7;                 // heads in this block
  const int R = a.H / a.KVH;
  const int ngrp = (R + nh - 1) / nh;
  const int g = blockIdx.y / ngrp, hrel = (blockIdx.y % ngrp) * nh + (warp >> 2);
  const bool active = hrel < R;
  const int h = g * R + (active ? hrel : 0);
  const int b = blockIdx.z % a.B, pi = blockIdx.z / a.B;
  const int d = pr.d[pi], src = pr.src[pi];
  const int q0 = blockIdx.x * BQ;
  const size_t qrow0 = ((size_t)d * a.B + b) * a.H * Cl + (size_t)h * Cl;
  const __nv_bfloat16* qg = (const __nv_bfloat16*)a.q + qrow0 * HD;
  const size_t kvrow0 = (((size_t)src * a.B + b) * a.KVH + g) * Ll;
  const TKV* kg = (const TKV*)a.k + kvrow0 * HD;
  const TKV* vg = (const TKV*)a.v + kvrow0 * HD;
  const int* qpb = a.qp + ((size_t)d * a.B + b) * Cl;
  const int* kpb = a.kvp + ((size_t)src * a.B + b) * Ll;

  // ---- prologue: the block's query bounds, then its running key tiles
  if (warp < 2) {
    const int r = q0 + tid;
    const int p = r < Cl ? qpb[r] : -1;
    int lo = p >= 0 ? p : 0x7fffffff, hi = p;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
    if (lane == 0) {
      sinfo[2 * warp] = lo;
      sinfo[2 * warp + 1] = hi;
    }
  }
  __syncthreads();
  const int q_min = min(sinfo[0], sinfo[2]);
  const int q_max = max(sinfo[1], sinfo[3]);
  __syncthreads();
  const int ntiles = (Ll + BK - 1) / BK;
  // flag 0: no visible pair; 1: some; 2: every key of the tile is visible
  // to every row of the block that has a position
  for (int t = warp; t < ntiles; t += nwarps) {
    int lo = 0x7fffffff, hi = -1;
    bool all = true;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = t * BK + lane + 32 * e;
      const int p = c < Ll ? kpb[c] : -1;
      all = all && p >= 0;
      if (p >= 0) {
        lo = min(lo, p);
        hi = max(hi, p);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
    all = __all_sync(0xffffffffu, all);
    if (lane == 0) {
      const bool run = q_max >= 0 && hi >= 0 && lo <= q_max &&
                       (!window || hi > q_min - window);
      const bool full = all && hi <= q_min && (!window || lo > q_max - window);
      tiles[t] = run ? 1 + full : 0;
    }
  }
  __syncthreads();
  if (warp == 0) {   // compact the flags into the list, in place
    int n = 0;
    for (int t0 = 0; t0 < ntiles; t0 += 32) {
      const int f = t0 + lane < ntiles ? tiles[t0 + lane] : 0;
      // every lane has read its flag before any lane writes the list
      const unsigned bal = __ballot_sync(0xffffffffu, f != 0);
      if (f)   // entry: 2 * tile + (every pair visible)
        tiles[n + __popc(bal & ((1u << lane) - 1))] = 2 * (t0 + lane) + (f == 2);
      n += __popc(bal);
    }
    if (lane == 0) sinfo[2] = n;
  }
  __syncthreads();
  const int nrun = sinfo[2];
  if (nrun == 0) return;   // nothing visible: the state stays as it is

  // ---- this warp's 16 rows: Q fragments, positions, carried state
  const int gq = lane >> 2, tq = lane & 3;
  const int ra = q0 + (warp & 3) * 16 + gq, rb = ra + 8;
  const bool va = ra < Cl, vb = rb < Cl;
  uint32_t qf[NKK][4];
#pragma unroll
  for (int kk = 0; kk < NKK; ++kk) {
    const int c = kk * 16 + 2 * tq;
    const uint32_t* qa = reinterpret_cast<const uint32_t*>(qg + (size_t)ra * HD + c);
    const uint32_t* qb = reinterpret_cast<const uint32_t*>(qg + (size_t)rb * HD + c);
    qf[kk][0] = active && va ? qa[0] : 0u;
    qf[kk][1] = active && vb ? qb[0] : 0u;
    qf[kk][2] = active && va ? qa[4] : 0u;
    qf[kk][3] = active && vb ? qb[4] : 0u;
  }
  const int qpa = va ? qpb[ra] : -1, qpbr = vb ? qpb[rb] : -1;
  // the keep bits of a tile whose every pair is visible
  const uint32_t full_rows =
      (qpa >= 0 ? 0x33333333u : 0u) | (qpbr >= 0 ? 0xCCCCCCCCu : 0u);
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  if (active) {
    if (va) {
      m0 = a.m[qrow0 + ra];
      l0 = a.l[qrow0 + ra];
    }
    if (vb) {
      m1 = a.m[qrow0 + rb];
      l1 = a.l[qrow0 + rb];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int c = n * 8 + 2 * tq;
      if (va) {
        const float2 x = *reinterpret_cast<const float2*>(
            a.acc + (qrow0 + ra) * HD + c);
        o[n][0] = x.x;
        o[n][1] = x.y;
      }
      if (vb) {
        const float2 x = *reinterpret_cast<const float2*>(
            a.acc + (qrow0 + rb) * HD + c);
        o[n][2] = x.x;
        o[n][3] = x.y;
      }
    }
  }

  // ---- the K/V pipeline: tiles i + 1 and i + 2 load while tile i computes
  auto load_tile = [&](int i) {
    const int k0 = (tiles[i] >> 1) * BK, st = i % STAGES;
    constexpr int CH = I8 ? HD / 16 : HD / 8;   // 16-byte chunks a row
    for (int c = tid; c < BK * CH; c += nthr) {
      const int row = c / CH, ch = c - row * CH;
      const bool ok = k0 + row < Ll;
      const size_t off =
          (size_t)(ok ? k0 + row : 0) * HD + ch * (16 / sizeof(TKV));
      uint32_t dk, dv;
      if (I8) {
        dk = smem_u32(Kst + (st * BK + row) * HD + ch * 16);
        dv = smem_u32(Vst + (st * BK + row) * HD + ch * 16);
      } else {
        dk = smem_u32(Kb + (st * BK + row) * LDS + ch * 8);
        dv = smem_u32(Vb + (st * BK + row) * LDS + ch * 8);
      }
      cp_async16(dk, kg + off, ok ? 16 : 0);
      cp_async16(dv, vg + off, ok ? 16 : 0);
    }
    if (tid < BK) {
      const bool ok = k0 + tid < Ll;
      cp_async4(smem_u32(kps + st * BK + tid), kpb + (ok ? k0 + tid : 0),
                ok ? 4 : 0);
    }
    cp_commit();
  };

  const float sk = a.scale * a.kvs;   // on the fp32 score
  const float sv = a.kvs;             // on P before P.V
  const int mat = lane >> 3, mr = lane & 7;   // ldmatrix: this lane's row
  load_tile(0);
  if (nrun > 1) load_tile(1);
  for (int i = 0; i < nrun; ++i) {
    const int st = i % STAGES;
    if (i + 1 < nrun) cp_wait<1>();
    else cp_wait<0>();
    // tile i has landed for every thread, and every warp is done with tile
    // i - 1, whose stage tile i + 2 now takes
    __syncthreads();
    if (i + 2 < nrun) load_tile(i + 2);
    const __nv_bfloat16* Ks = Kb + (I8 ? 0 : st * BK * LDS);
    const __nv_bfloat16* Vs = Vb + (I8 ? 0 : st * BK * LDS);
    if (I8) {   // widen the staged int8 tile to bf16 (exact: |x| <= 127)
      for (int c = tid; c < 2 * BK * (HD / 16); c += nthr) {
        const int kv = c / (BK * (HD / 16)), e = c - kv * BK * (HD / 16);
        const int row = e / (HD / 16), ch = e - row * (HD / 16);
        const int4 raw = *reinterpret_cast<const int4*>(
            (kv ? Vst : Kst) + (st * BK + row) * HD + ch * 16);
        const int8_t* x = reinterpret_cast<const int8_t*>(&raw);
        uint32_t w[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          w[j] = as_u32(__floats2bfloat162_rn((float)x[2 * j],
                                              (float)x[2 * j + 1]));
        uint4* dst = reinterpret_cast<uint4*>((kv ? Vb : Kb) + row * LDS +
                                              ch * 16);
        dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
        dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
      }
      __syncthreads();
    }
    const int k0 = (tiles[i] >> 1) * BK;
    const int* kp = kps + st * BK;
    // bit 4j + x: element x of the score fragment of keys 8j.. is visible
    uint32_t keep = full_rows;
    if (!(tiles[i] & 1)) {
      keep = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * tq + e;
          const int kpos = k0 + c < Ll ? kp[c] : -1;
          if (visible(qpa, kpos, window)) keep |= 1u << (4 * j + e);
          if (visible(qpbr, kpos, window)) keep |= 1u << (4 * j + 2 + e);
        }
    }
    if (!active || !__any_sync(0xffffffffu, keep != 0)) continue;
    // S = Q . K^T over the tile's 64 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NKK; ++kk)
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t kf[4];
        ldsm_x4(kf, smem_u32(Ks + (16 * jp + mr + 8 * (mat >> 1)) * LDS +
                             16 * kk + 8 * (mat & 1)));
        mma_bf16(s[2 * jp], qf[kk], kf[0], kf[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], kf[2], kf[3]);
      }
    float al0, al1;
    if (keep == 0xffffffffu)
      tile_softmax<true>(s, keep, sk, a.cap, m0, m1, l0, l1, al0, al1);
    else
      tile_softmax<false>(s, keep, sk, a.cap, m0, m1, l0, l1, al0, al1);
    if (sv != 1.f) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) s[j][x] *= sv;
    }
    // P (times kv_scale) as A fragments of 16 keys, hi and lo halves
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      split2(s[2 * kk][0], s[2 * kk][1], ph[kk][0], pl[kk][0]);
      split2(s[2 * kk][2], s[2 * kk][3], ph[kk][1], pl[kk][1]);
      split2(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[kk][2], pl[kk][2]);
      split2(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[kk][3], pl[kk][3]);
    }
    // acc = acc * alpha + P.V, the tile's sum in a fresh fragment
#pragma unroll
    for (int np = 0; np < HD / 16; ++np) {
      float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t vf[4];
        ldsm_x4_t(vf, smem_u32(Vs + (16 * kk + mr + 8 * (mat & 1)) * LDS +
                               16 * np + 8 * (mat >> 1)));
        mma_bf16(t0, ph[kk], vf[0], vf[1]);
        mma_bf16(t0, pl[kk], vf[0], vf[1]);
        mma_bf16(t1, ph[kk], vf[2], vf[3]);
        mma_bf16(t1, pl[kk], vf[2], vf[3]);
      }
      o[2 * np][0] = o[2 * np][0] * al0 + t0[0];
      o[2 * np][1] = o[2 * np][1] * al0 + t0[1];
      o[2 * np][2] = o[2 * np][2] * al1 + t0[2];
      o[2 * np][3] = o[2 * np][3] * al1 + t0[3];
      o[2 * np + 1][0] = o[2 * np + 1][0] * al0 + t1[0];
      o[2 * np + 1][1] = o[2 * np + 1][1] * al0 + t1[1];
      o[2 * np + 1][2] = o[2 * np + 1][2] * al1 + t1[2];
      o[2 * np + 1][3] = o[2 * np + 1][3] * al1 + t1[3];
    }
  }

  if (!active) return;
  if (tq == 0) {
    if (va) {
      a.m[qrow0 + ra] = m0;
      a.l[qrow0 + ra] = l0;
    }
    if (vb) {
      a.m[qrow0 + rb] = m1;
      a.l[qrow0 + rb] = l1;
    }
  }
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = n * 8 + 2 * tq;
    if (va)
      *reinterpret_cast<float2*>(a.acc + (qrow0 + ra) * HD + c) =
          make_float2(o[n][0], o[n][1]);
    if (vb)
      *reinterpret_cast<float2*>(a.acc + (qrow0 + rb) * HD + c) =
          make_float2(o[n][2], o[n][3]);
  }
}

template <typename TKV, int HD>
int launch_tc(const HopArgs& a, const Pairs& pr, int n_run,
              cudaStream_t stream) {
  const int R = a.H / a.KVH, cap = TcCap<HD>::HEADS;
  const int groups = (R + cap - 1) / cap;
  const int nh = (R + groups - 1) / groups;   // heads a block holds
  const size_t smem = tc_smem_base<TKV, HD>() +
                      sizeof(int) * (size_t)((a.Ll + BK - 1) / BK);
  cudaError_t err = cudaFuncSetAttribute(
      tc_kernel<TKV, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Cl + BQ - 1) / BQ, a.KVH * ((R + nh - 1) / nh),
            a.B * n_run);
  tc_kernel<TKV, HD><<<grid, nh * 128, smem, stream>>>(a, pr);
  return (int)cudaGetLastError();
}

template <typename TKV>
int tc_by_hd(const HopArgs& a, const Pairs& pr, int n_run, cudaStream_t s) {
  if (a.hd == 64) return launch_tc<TKV, 64>(a, pr, n_run, s);
  if (a.hd == 128) return launch_tc<TKV, 128>(a, pr, n_run, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Runs the hops (d, src) = (pairs[2i], pairs[2i+1]), i < n_run, of one hop
// step in one launch. Stacks: q (n,B,H,Cl,hd), k and v (n,B,KVH,Ll,hd),
// qp (n,B,Cl), kvp (n,B,Ll) int32, m and l (n,B,H,Cl,1) and acc
// (n,B,H,Cl,hd) fp32, read and written in place; `pairs` is host memory.
// q_dtype: 0 = fp32, 1 = bf16; kv_dtype (of k and v): 0 = fp32, 1 = bf16,
// 2 = int8. kv_scale 0 leaves K/V unscaled. design: 0 = simt (needs hd a
// multiple of 16 up to 256), 1 = tc (bf16 q, bf16 or int8 K/V, hd 64 or
// 128, 16-byte aligned q, k and v). H must be a multiple of KVH and the
// destinations distinct. Returns cudaGetLastError() of the launch.
extern "C" int ring_hop_step(const void* q, const void* k, const void* v,
                             const void* qp, const void* kvp, void* m,
                             void* l, void* acc, const int* pairs, int n_run,
                             int B, int H, int KVH, int Cl, int Ll, int hd,
                             int window, float cap, float kv_scale,
                             float scale, int q_dtype, int kv_dtype,
                             int design, void* stream) {
  if (hd <= 0 || hd > 256 || hd % 16 || KVH <= 0 || H % KVH || Cl <= 0 ||
      Ll <= 0 || B <= 0 || H > 65535 || n_run <= 0 ||
      n_run > MAX_PAIRS || (long)B * n_run > 65535)
    return (int)cudaErrorInvalidValue;
  HopArgs a{q, k, v, (const int*)qp, (const int*)kvp, (float*)m, (float*)l,
            (float*)acc, B, H, KVH, Cl, Ll, hd, window, cap,
            kv_scale != 0.f ? kv_scale : 1.f, scale};
  Pairs pr{};
  for (int i = 0; i < n_run; ++i) {
    pr.d[i] = pairs[2 * i];
    pr.src[i] = pairs[2 * i + 1];
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (design == 1) {
    if (q_dtype != 1) return (int)cudaErrorInvalidValue;
    if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) & 15)
      return (int)cudaErrorMisalignedAddress;
    switch (kv_dtype) {
      case 1: return tc_by_hd<__nv_bfloat16>(a, pr, n_run, s);
      case 2: return tc_by_hd<int8_t>(a, pr, n_run, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (design != 0) return (int)cudaErrorInvalidValue;
  switch (q_dtype) {
    case 0: return simt_by_kv<float>(kv_dtype, a, pr, n_run, s);
    case 1: return simt_by_kv<__nv_bfloat16>(kv_dtype, a, pr, n_run, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

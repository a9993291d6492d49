// Fused paged-attention decode for Hopper (sm_90a): one query token per
// batch slot attends over its block table's K/V pages in place, with a
// slot's pages split over the card (flash-decoding).
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py
// (paged_attention_impl / _kernel) and computes what _kernel computes: a
// page is skipped when its physical id is 0, when it starts past the query
// position, or (window > 0) when it lies wholly below the window band;
// entries are masked by the page's ppos row (-1 empty, future, out of
// window) after the optional softcap to -1e30; the softmax is online in
// fp32, int8 K/V are dequantised by kv_scale, a slot with no running page
// writes zeros and one whose running pages hold no valid entry the mean of
// V over their entries (acc / max(l, 1e-30), m starting at -1e30).
//
// Bound on the H100: decode attention reads every running page's K and V
// once and does ~1 flop per byte, so it is bound by bytes at 3.35 TB/s: at
// the ring cell's decode (4 slots of 8194-16000 tokens, 2,828 running
// pages of 16 x 8 heads x 128, bf16) 185.5 MB, 0.055 ms. The TPU walked a
// slot's pages in sequence; a block per (slot, KV head) gives the H100 32
// to 64 blocks for 132 SMs, each walking up to a thousand pages in series.
//
// Design. Each block-table row is cut into fixed ranges of `pps` pages
// (page_splits in kernels/paged_attention.py, from shapes only: the host
// never reads a position). Kernel 1, paged_split_kernel, runs one block
// per (range, KV head x group of <= 4 query heads, slot); a range that
// starts past the slot's position or lies wholly below the window exits
// at once, and a range that runs writes its partial (m, l, acc) to fp32
// scratch. The block's 4 warps take the range's pages in turn (page
// m0 + w, m0 + w + 4, ...), each warp on its own with no block barrier
// until the end: lane i holds the block-table id of the warp's page i (32
// at a time), and the warp stages each running page's K and V slice for
// the head (P rows of hd elements at stride G * hd) and its ppos row in
// shared memory with 16-byte cp.async copies, in two stages, so the next
// stage loads while this one computes. A stage holds a tile of `pt` rows
// of a page: the whole page wherever the 4 warps' two stages fit in
// shared memory (every shape of the serving paths), else the page in
// equal tiles that fit (tile_rows: fp32 hd 256 pages of 16 rows take
// tiles of 8), so every page size runs. Int8 and bf16 are widened in
// registers after the load. Scores: 32 / lk keys at a time, lk lanes a key,
// each lane holding its 16-byte slices of the block's rows of Q in
// registers, reduced across the lk lanes by shuffles, all rows at once.
// Softmax: a lane a key, the page's max and sum of all rows by warp
// shuffles, one exponential a lane, key and row. P.V: each lane owns 4
// consecutive dims of every row (twice at hd > 128). The warps' states
// merge in shared memory at the end of the range, in warp order. Kernel 2,
// paged_merge_kernel, one block per (KV head, slot) and a warp per query
// row, merges the running ranges in range order: m = max m_s, l = sum
// l_s exp(m_s - m), acc likewise, then acc / max(l, 1e-30). No atomics:
// the result does not change from run to run. A range with only masked
// entries carries m = -1e30, l = its count and acc = its sum of V, which
// weighs 0 beside a range with a valid entry and counts fully when no
// range has one; a range with no running page carries l = 0, so the two
// cases above come out as in the sequential walk.
//
// Shared memory: 4 warps x 2 stages of a tile (2 pt rb + its ppos) and the
// tile's probabilities (pt x 4 floats), at most 227 KB.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RT = 4;           // query rows (heads of a GQA group) a block
static_assert(RT == 4, "the softmax reads a key's rows as one float4");
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait(int pending) {
  if (pending >= 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// q and the output: dtype code 0 fp32, 1 bf16, 2 fp16
__device__ __forceinline__ float load_q(const void* p, size_t i, int code) {
  if (code == 1) return __bfloat162float(((const __nv_bfloat16*)p)[i]);
  if (code == 2) return __half2float(((const __half*)p)[i]);
  return ((const float*)p)[i];
}
__device__ __forceinline__ void store_o(void* p, size_t i, int code,
                                        float v) {
  if (code == 1)
    ((__nv_bfloat16*)p)[i] = __float2bfloat16(v);
  else if (code == 2)
    ((__half*)p)[i] = __float2half(v);
  else
    ((float*)p)[i] = v;
}

// 4 consecutive elements of type T from shared memory, widened
__device__ __forceinline__ void load4(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&f)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
}
__device__ __forceinline__ void load4(const __half* p, float (&f)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
}
__device__ __forceinline__ void load4(const int8_t* p, float (&f)[4]) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  f[0] = c.x; f[1] = c.y; f[2] = c.z; f[3] = c.w;
}

// the 16 bytes at p (shared memory), widened: 4, 8 or 16 elements
__device__ __forceinline__ void widen16(const unsigned char* p,
                                        const float*, float (&f)[4]) {
  load4(reinterpret_cast<const float*>(p), f);
}
__device__ __forceinline__ void widen16(const unsigned char* p,
                                        const __nv_bfloat16*, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void widen16(const unsigned char* p,
                                        const __half*, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void widen16(const unsigned char* p,
                                        const int8_t*, float (&f)[16]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    f[i] = (float)(int8_t)((w[i / 4] >> (8 * (i % 4))) & 0xffu);
}

template <typename T>
__device__ __forceinline__ T zero_of() {
  T z;
  unsigned char* bytes = reinterpret_cast<unsigned char*>(&z);
#pragma unroll
  for (int i = 0; i < (int)sizeof(T); ++i) bytes[i] = 0;
  return z;
}

__device__ __forceinline__ bool page_runs(int m, int pid, int P, int pos,
                                          int window) {
  bool run = pid != 0 && m * P <= pos;
  if (window) run = run && (m + 1) * P - 1 > pos - window;
  return run;
}

// Range s of a row (pages s*pps .. min((s+1)*pps, M) - 1) holds a page that
// can run: it starts at or before the position and, with a window, its
// last page reaches into the window band. Kernel 1 exits and kernel 2
// skips the range otherwise.
__device__ __forceinline__ bool split_live(int s, int pps, int M, int P,
                                           int pos, int window) {
  const int m0 = s * pps, m1 = min(m0 + pps, M);
  bool live = m0 < m1 && m0 * P <= pos;
  if (window) live = live && m1 * P - 1 > pos - window;
  return live;
}

struct Args {
  const void* q;
  const void* kp;
  const void* vp;
  const int* ppos;
  const int* block;
  const int* position;
  float* part;          // (B, G, NS, R, hd + 2): m, l, acc
  void* out;
  int G, R, hd, P, M, pps, ns, window, pt, vec16, q_code;
  float kv_scale, cap, scale;
};

// Shared memory a warp stages a tile of `pt` rows in: K and V rows of `rb`
// bytes (hd elements padded to 16 bytes), the ppos entries, padded to 16
// bytes.
__host__ __device__ __forceinline__ int row_bytes(int hd, int esize) {
  return (hd * esize + 15) / 16 * 16;
}
__host__ __device__ __forceinline__ int stage_bytes(int P, int rb) {
  return 2 * P * rb + (4 * P + 15) / 16 * 16;
}
constexpr int STAGES = 2;       // tiles in flight a warp
static_assert(STAGES == 2, "a warp keeps its two stages' row counts");
constexpr int NW = 4;           // warps a block of kernel 1
constexpr int SMEM_MAX = 227 * 1024;

// TKV: K/V element type; HK: groups of 128 dims (hd <= 128 * HK)
template <typename TKV, int HK>
__global__ void __launch_bounds__(128) paged_split_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ES = sizeof(TKV);
  constexpr int EPC = 16 / ES;              // elements a 16-byte chunk
  constexpr int JC = ES == 4 ? 2 : 1;       // chunks a lane at most
  const int s = blockIdx.x, b = blockIdx.z;
  const int n_rg = (a.R + RT - 1) / RT;
  const int g = blockIdx.y / n_rg, r0 = (blockIdx.y % n_rg) * RT;
  const int RB = min(RT, a.R - r0);         // rows of this block
  const int pos = a.position[b];
  const int P = a.P, hd = a.hd;
  if (!split_live(s, a.pps, a.M, P, pos, a.window)) return;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pt = a.pt;                      // rows of a page a stage holds
  const int rb = row_bytes(hd, ES), sb = stage_bytes(pt, rb);
  const int nc = rb / 16;                   // chunks a row
  // lanes a key in the score step: the power of two >= nc, at most 32
  int lk = 1;
  while (lk < nc && lk < 32) lk <<= 1;
  const int kpi = 32 / lk, sub = lane % lk;
  const int cpl = (nc + lk - 1) / lk;       // chunks a lane (1 or 2)

  unsigned char* wbase = smem + (size_t)warp * (STAGES * sb + 16 * pt);
  float* ew = reinterpret_cast<float*>(wbase + STAGES * sb);  // [pt][RT]

  // this lane's slice of the rows of Q (the dims of its chunks), fp32
  float qr[RT][JC * EPC];
  const size_t qb = ((size_t)b * a.G + g) * a.R * hd;
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int j = 0; j < JC; ++j)
#pragma unroll
      for (int e = 0; e < EPC; ++e) {
        const int d = (sub + lk * j) * EPC + e;
        qr[r][j * EPC + e] = (r < RB && j < cpl && d < hd)
                                 ? load_q(a.q, qb + (size_t)(r0 + r) * hd + d,
                                          a.q_code)
                                 : 0.f;
      }

  float m_r[RT], l_r[RT], acc[RT][HK][4];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    m_r[r] = NEG_INF;
    l_r[r] = 0.f;
#pragma unroll
    for (int k = 0; k < HK; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[r][k][i] = 0.f;
  }

  const int m_end = min((s + 1) * a.pps, a.M);
  const int* brow = a.block + (size_t)b * a.M;
  const TKV* kp = (const TKV*)a.kp;
  const TKV* vp = (const TKV*)a.vp;
  const size_t row_stride = (size_t)a.G * hd;   // elements between rows
  // the warp's pages of the range: the k-th is m_first + NW * k; lane i
  // holds the block-table id of page 32 * chunk + i, read 32 at a time
  const int m_first = s * a.pps + warp;
  const int n_mine = m_first < m_end ? (m_end - m_first + NW - 1) / NW : 0;
  int ids = 0, chunk = -1;
  // the warp's next running page at or after its k-th; -1 when none is left
  auto next_run = [&](int k, int& pid) {
    for (; k < n_mine; ++k) {
      const int m = m_first + NW * k;
      if (m * P > pos) break;
      if ((k >> 5) != chunk) {
        chunk = k >> 5;
        const int kk = 32 * chunk + lane;
        ids = kk < n_mine ? brow[m_first + NW * kk] : 0;
      }
      pid = __shfl_sync(0xffffffffu, ids, k & 31);
      if (page_runs(m, pid, P, pos, a.window)) return k;
    }
    return -1;
  };
  // lanes' (row, chunk) pairs of a page copy: fixed when nc divides 32
  const bool even = 32 % nc == 0;
  const int c_lane = even ? lane % nc : 0, p_lane = even ? lane / nc : 0;
  const int p_step = even ? 32 / nc : 0;
  // stage rows row0 .. row0 + n - 1 of page pid
  auto issue = [&](int st, int pid, int row0, int n) {
    unsigned char* kd = wbase + st * sb;
    unsigned char* vd = kd + pt * rb;
    int* pd = reinterpret_cast<int*>(vd + pt * rb);
    const size_t base =
        ((size_t)pid * P + row0) * row_stride + (size_t)g * hd;
    if (a.vec16 && even) {
      for (int p = p_lane; p < n; p += p_step) {
        const size_t off = base + (size_t)p * row_stride + c_lane * EPC;
        cp_async16(smem_u32(kd + p * rb + c_lane * 16), kp + off);
        cp_async16(smem_u32(vd + p * rb + c_lane * 16), vp + off);
      }
    } else if (a.vec16) {
      for (int i = lane; i < n * nc; i += 32) {
        const int p = i / nc, c = i - p * nc;
        const size_t off = base + (size_t)p * row_stride + c * EPC;
        cp_async16(smem_u32(kd + p * rb + c * 16), kp + off);
        cp_async16(smem_u32(vd + p * rb + c * 16), vp + off);
      }
    } else {          // rows not 16-byte aligned: plain copies, zero pad
      const int ne = rb / ES;
      for (int i = lane; i < n * ne; i += 32) {
        const int p = i / ne, e = i - p * ne;
        const size_t off = base + (size_t)p * row_stride + e;
        TKV kz = zero_of<TKV>(), vz = zero_of<TKV>();
        if (e < hd) {
          kz = kp[off];
          vz = vp[off];
        }
        reinterpret_cast<TKV*>(kd + p * rb)[e] = kz;
        reinterpret_cast<TKV*>(vd + p * rb)[e] = vz;
      }
    }
    for (int i = lane; i < n; i += 32)
      cp_async4(smem_u32(pd + i), a.ppos + (size_t)pid * P + row0 + i);
  };

  const float sc = a.scale * (a.kv_scale != 0.f ? a.kv_scale : 1.f);
  const int n_tiles = (P + pt - 1) / pt;    // stages a page takes
  int pid = 0, t_next = 0, rows0 = 0, rows1 = 0, issued = 0;
  int k_next = next_run(0, pid);
  // stage the warp's next (page, tile) and move past it
  auto issue_next = [&](int st) {
    const int row0 = t_next * pt, n = min(pt, P - row0);
    issue(st, pid, row0, n);
    if (st) rows1 = n; else rows0 = n;
    ++issued;
    if (++t_next == n_tiles) {
      t_next = 0;
      k_next = next_run(k_next + 1, pid);
    }
  };
  for (int st = 0; st < STAGES; ++st) {
    if (k_next >= 0) issue_next(st);
    cp_commit();
  }
  for (int done = 0; done < issued; ++done) {
    cp_wait(STAGES - 1);
    __syncwarp();
    const int st = done % STAGES;
    const int np = st ? rows1 : rows0;      // rows of this tile
    const unsigned char* kd = wbase + st * sb;
    const unsigned char* vd = kd + pt * rb;
    const int* pd = reinterpret_cast<const int*>(vd + pt * rb);

    // scores: kpi keys at a time, lk lanes a key
#pragma unroll 2
    for (int p0 = 0; p0 < np; p0 += kpi) {
      const int p = p0 + lane / lk;
      float part[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) part[r] = 0.f;
      if (p < np) {
#pragma unroll
        for (int j = 0; j < JC; ++j) {
          const int c = sub + lk * j;
          if (j < cpl && c < nc) {
            float kf[EPC];
            widen16(kd + p * rb + c * 16, (const TKV*)nullptr, kf);
#pragma unroll
            for (int e = 0; e < EPC; ++e)
#pragma unroll
              for (int r = 0; r < RT; ++r)
                part[r] = fmaf(qr[r][j * EPC + e], kf[e], part[r]);
          }
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        if (o < lk)
#pragma unroll
          for (int r = 0; r < RT; ++r)
            part[r] += __shfl_xor_sync(0xffffffffu, part[r], o);
      if (sub == 0 && p < np) {
        const int kvp = pd[p];
        bool valid = kvp >= 0 && kvp <= pos;
        if (a.window) valid = valid && kvp > pos - a.window;
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          float x = part[r] * sc;
          if (a.cap != 0.f) x = a.cap * tanhf(x / a.cap);
          ew[p * RT + r] = r >= RB ? 0.f : valid ? x : NEG_INF;
        }
      }
    }
    __syncwarp();

    // online softmax: a lane a key, all rows at once (rows past RB hold
    // scores of 0 and are never written out)
    float mx[RT], sum[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      mx[r] = NEG_INF;
      sum[r] = 0.f;
    }
    for (int p = lane; p < np; p += 32) {
      const float4 x = *reinterpret_cast<const float4*>(ew + p * RT);
      mx[0] = fmaxf(mx[0], x.x);
      mx[1] = fmaxf(mx[1], x.y);
      mx[2] = fmaxf(mx[2], x.z);
      mx[3] = fmaxf(mx[3], x.w);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int r = 0; r < RT; ++r)
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], o));
    float alpha[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      mx[r] = fmaxf(m_r[r], mx[r]);
      alpha[r] = __expf(m_r[r] - mx[r]);
      m_r[r] = mx[r];
    }
    for (int p = lane; p < np; p += 32) {
      float4 x = *reinterpret_cast<const float4*>(ew + p * RT);
      x.x = __expf(x.x - mx[0]);
      x.y = __expf(x.y - mx[1]);
      x.z = __expf(x.z - mx[2]);
      x.w = __expf(x.w - mx[3]);
      sum[0] += x.x;
      sum[1] += x.y;
      sum[2] += x.z;
      sum[3] += x.w;
      *reinterpret_cast<float4*>(ew + p * RT) = x;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int r = 0; r < RT; ++r)
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], o);
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      l_r[r] = l_r[r] * alpha[r] + sum[r];
#pragma unroll
      for (int k = 0; k < HK; ++k)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[r][k][i] *= alpha[r];
    }
    __syncwarp();

    // P.V: the lane's 4 dims (per 128) of every row
#pragma unroll
    for (int k = 0; k < HK; ++k) {
      const int d0 = 4 * lane + 128 * k;
      if (d0 < hd) {
#pragma unroll 4
        for (int p = 0; p < np; ++p) {
          const float4 e4 = *reinterpret_cast<const float4*>(ew + p * RT);
          const float ev[4] = {e4.x, e4.y, e4.z, e4.w};
          float vf[4];
          load4(reinterpret_cast<const TKV*>(vd + p * rb) + d0, vf);
#pragma unroll
          for (int r = 0; r < RT; ++r)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              acc[r][k][i] = fmaf(ev[r], vf[i], acc[r][k][i]);
        }
      }
    }
    __syncwarp();               // the stage and ew are free again
    if (k_next >= 0) issue_next(st);
    cp_commit();
  }

  // merge the warps' states in shared memory (warp order), write the range
  __syncthreads();
  float* ws = reinterpret_cast<float*>(smem);   // [NW][RT][2 + 128 HK]
  constexpr int WLD = 2 + 128 * HK;
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    float* w = ws + (warp * RT + r) * WLD;
    if (lane == 0) {
      w[0] = m_r[r];
      w[1] = l_r[r];
    }
#pragma unroll
    for (int k = 0; k < HK; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i) w[2 + 128 * k + 4 * lane + i] = acc[r][k][i];
  }
  __syncthreads();
  const float vs = a.kv_scale != 0.f ? a.kv_scale : 1.f;
  float* dst = a.part + (((size_t)b * a.G + g) * a.ns + s) * a.R * (hd + 2);
  for (int i = threadIdx.x; i < RB * (hd + 2); i += blockDim.x) {
    const int r = i / (hd + 2), c = i - r * (hd + 2);
    float mx = NEG_INF;
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, ws[(w * RT + r) * WLD]);
    float v = c == 0 ? mx : 0.f;
    if (c > 0)
      for (int w = 0; w < NW; ++w) {
        const float* wr = ws + (w * RT + r) * WLD;
        v += __expf(wr[0] - mx) * wr[c];
      }
    dst[(r0 + r) * (hd + 2) + c] = c >= 2 ? v * vs : v;
  }
}

// One block per (KV head, slot), a warp per query row: merges the running
// ranges in range order and writes the output in q's dtype. The running
// ranges are consecutive (split_live is a band), s_lo .. s_hi.
__global__ void __launch_bounds__(128) paged_merge_kernel(Args a) {
  const int g = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pos = a.position[b];
  const int hd = a.hd, ld = hd + 2;
  const float* src = a.part + ((size_t)b * a.G + g) * a.ns * a.R * ld;
  int s_lo = a.ns, s_hi = -1;
  for (int s = 0; s < a.ns; ++s)
    if (split_live(s, a.pps, a.M, a.P, pos, a.window)) {
      s_lo = min(s_lo, s);
      s_hi = s;
    }
  for (int r = warp; r < a.R; r += blockDim.x / 32) {
    float mx = NEG_INF;
    for (int s = s_lo + lane; s <= s_hi; s += 32)
      mx = fmaxf(mx, src[((size_t)s * a.R + r) * ld]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float l = 0.f, acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.f;
#pragma unroll 4
    for (int s = s_lo; s <= s_hi; ++s) {
      const float* ps = src + ((size_t)s * a.R + r) * ld;
      const float w = __expf(ps[0] - mx);
      l = fmaf(w, ps[1], l);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = lane + 32 * j;
        if (d < hd) acc[j] = fmaf(w, ps[2 + d], acc[j]);
      }
    }
    const float den = fmaxf(l, 1e-30f);
    const size_t ob = (((size_t)b * a.G + g) * a.R + r) * hd;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = lane + 32 * j;
      if (d < hd) store_o(a.out, ob + d, a.q_code, acc[j] / den);
    }
  }
}

// kernel 1's shared memory at tiles of pt rows: the warps' stages, which
// the warps' states reuse when they merge
size_t split_smem(int pt, int hd, int esize) {
  const size_t stages =
      (size_t)NW * (STAGES * stage_bytes(pt, row_bytes(hd, esize)) + 16 * pt);
  const size_t merge =
      (size_t)NW * RT * (2 + 128 * (hd <= 128 ? 1 : 2)) * sizeof(float);
  return stages > merge ? stages : merge;
}

// rows of a page a stage holds: the whole page where it fits, else the
// fewest equal tiles that do (one row always fits at hd <= 256)
int tile_rows(int P, int hd, int esize) {
  const int per_row = NW * (STAGES * (2 * row_bytes(hd, esize) + 4) + 16);
  int fit = SMEM_MAX / per_row < P ? SMEM_MAX / per_row : P;
  while (fit > 1 && split_smem(fit, hd, esize) > (size_t)SMEM_MAX) --fit;
  const int tiles = (P + fit - 1) / fit;
  return (P + tiles - 1) / tiles;
}

template <typename TKV, int HK>
int launch(Args a, int B, cudaStream_t stream) {
  a.pt = tile_rows(a.P, a.hd, sizeof(TKV));
  const size_t smem = split_smem(a.pt, a.hd, sizeof(TKV));
  auto kernel = paged_split_kernel<TKV, HK>;
  static size_t granted = 48 * 1024;   // dynamic shared memory allowed
  if (smem > granted) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    granted = smem;
  }
  const int n_rg = (a.R + RT - 1) / RT;
  kernel<<<dim3(a.ns, a.G * n_rg, B), 32 * NW, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename TKV>
int launch_hd(const Args& a, int B, cudaStream_t s) {
  return a.hd <= 128 ? launch<TKV, 1>(a, B, s) : launch<TKV, 2>(a, B, s);
}

}  // namespace

// dtype codes: 0 = fp32, 1 = bf16, 2 = fp16, 3 = int8 (K/V only).
// part: fp32 scratch of B * G * ns * R * (hd + 2); vec16: K/V rows and
// pointers are 16-byte aligned. Each returns the launch's
// cudaGetLastError().
extern "C" int paged_attention_split(
    const void* q, const void* kp, const void* vp, const void* ppos,
    const void* block, const void* position, void* part, int B, int G,
    int R, int hd, int P, int M, int pps, int ns, int window, int vec16,
    float kv_scale, float cap, float scale, int q_dtype, int kv_dtype,
    void* stream) {
  if (R < 1 || R > 16 || hd < 1 || hd > 256 || P < 1 || pps < 1 ||
      ns < 1 || q_dtype < 0 || q_dtype > 2)
    return (int)cudaErrorInvalidValue;
  Args a{q, kp, vp, (const int*)ppos, (const int*)block,
         (const int*)position, (float*)part, nullptr, G, R, hd, P, M, pps,
         ns, window, 0, vec16, q_dtype, kv_scale, cap, scale};
  cudaStream_t s = (cudaStream_t)stream;
  switch (kv_dtype) {
    case 0: return launch_hd<float>(a, B, s);
    case 1: return launch_hd<__nv_bfloat16>(a, B, s);
    case 2: return launch_hd<__half>(a, B, s);
    case 3: return launch_hd<int8_t>(a, B, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int paged_attention_merge(const void* position, const void* part,
                                     void* out, int B, int G, int R, int hd,
                                     int P, int M, int pps, int ns,
                                     int window, int q_dtype, void* stream) {
  if (R < 1 || hd < 1 || hd > 256 || q_dtype < 0 || q_dtype > 2)
    return (int)cudaErrorInvalidValue;
  Args a{nullptr, nullptr, nullptr, nullptr, nullptr, (const int*)position,
         (float*)part, out, G, R, hd, P, M, pps, ns, window, 0, 0, q_dtype,
         0.f, 0.f, 0.f};
  paged_merge_kernel<<<dim3(G, B), 128, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// rows of a page kernel 1 stages at a time for K/V elements of `esize`
// bytes (P where the page fits), or 0 for a shape it does not take
extern "C" int paged_attention_tile_rows(int P, int hd, int esize) {
  if (P < 1 || hd < 1 || hd > 256 || (esize != 1 && esize != 2 && esize != 4))
    return 0;
  return tile_rows(P, hd, esize);
}

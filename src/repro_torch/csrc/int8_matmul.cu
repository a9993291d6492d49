// W8A8 GEMM for Hopper (sm_90a): out[m][n] = float(sum_k x[m][k] * w_t[n][k])
// * x_scale[m] * w_scale[n], cast to fp32, bf16 or fp16.
//
// Replaces the Pallas TPU kernel src/repro/kernels/int8_matmul.py
// (int8_matmul / _kernel), computing what its oracle int8_matmul_ref does:
// the sum is carried in int32 across ALL of K (exact; the Pallas kernel adds
// per-block int32 partials in fp32), so the result equals the float64
// oracle bit for bit; ragged M and N are handled, not asserted, because
// decode runs with M = live batch.
//
// The weight comes as w_t (N, K), K-major: the int8 tensor-core
// instructions (wgmma .s32.s8.s8, mma.sync m16n8k32 .s8) take both operands
// K-major, and x (M, K) already is. The paths launch the product in two
// regimes, so there are two designs, picked on the host from (M, N, K)
// (kernels/int8_matmul.py select_design), and a fallback:
//
// A. Bound by operations (M > 16: chunked admission, training).
//    Warp-specialised wgmma tiles. A block owns a 128 x BN output tile
//    (BN 128 or 256). One producer warp keeps TMA loads of 128-byte-deep
//    K slices of x and w_t (128-byte swizzle, zero fill out of range) in
//    flight through a ring of 4 stages guarded by full / empty mbarriers;
//    two consumer warpgroups each run wgmma m64nBNk32 on 64 rows and keep
//    the s32 accumulators in registers. Zeros from the fill add nothing to
//    an integer sum, so ragged M, N and K need no masking in the main loop.
//    The epilogue stages each warpgroup's tile in shared memory and stores
//    it in 16-byte pieces. Needs K % 16 == 0 (TMA's row stride is a
//    multiple of 16 bytes).
// B. Bound by bytes (M <= 16: the decode step). The weight streams once
//    from device memory in 16-byte loads, four lanes on 64 consecutive bytes
//    of a row. A block owns 16 rows of w_t, and its 8 warps split K; each
//    warp feeds mma.sync m16n8k32 with w_t as the A operand (N as the MMA's
//    M) and x as B (the <= 16 tokens as the MMA's N). The sum over k is
//    exact in any order, so each lane uses its 16 loaded bytes as they lie
//    and takes the same 16 bytes of x: both operands see one permutation of
//    the 64 k. Each block reads each byte of x once (its warps split K), so
//    x is read straight from L2 rather than staged in shared memory. The
//    warps' int32 partials are summed in shared memory. Needs K % 16 == 0.
// Fallback (K % 16 != 0): a shared-memory __dp4a tile of 64 x 64 outputs,
//    BK 32, with out-of-range bytes staged as 0.
//
// All three share the epilogue float(acc) * x_scale[m] * w_scale[n] (two
// fp32 multiplies in that order, rounded to nearest), as the oracle does.
//
// Experts. The JAX package's MoE layer applies jax.vmap to the Pallas call
// over its experts (src/repro/models/moe.py _expert_ffn): one call with the
// experts on its grid. Here one launch computes E independent products,
// x (E, M, K) by w_t (E, N, K) into out (E, M, N), the expert on the grid's
// last dimension (A: blockIdx.z, B: blockIdx.y, fallback: blockIdx.z). A's
// tensor maps are 3-D (K, rows, E), so a tile's loads stop at its expert's
// last row and fill the rest with zeros; B and the fallback offset their
// pointers by the expert's strides. E = 1 is the 2-D product.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// A null scale vector stands for unit scales (the backward's exact int32
// sums): multiplying by 1 is exact, so the product stays the sums.
__device__ __forceinline__ float scale_at(const float* p, int i) {
  return p ? p[i] : 1.f;
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store1(__half* p, float v) {
  *p = __float2half(v);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

// ------------------------------------------------- A: wgmma + TMA tiles --

namespace wg {

using namespace hopper;

constexpr int BM = 128, BK = 128, STAGES = 4;
constexpr int THREADS = 384;  // warpgroup 0 loads, warpgroups 1-2 multiply

template <int BN>
constexpr int smem_bytes() {
  return STAGES * (BM + BN) * BK + 2 * STAGES * 8 + 1024;  // + alignment
}

// Keep the compiler from moving accumulator accesses across wgmma issue.
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

template <int N>
struct Wgmma;

template <>
struct Wgmma<128> {
  // d (+)= A (64 x 32, K-major, smem) . B (128 x 32, K-major, smem)^T
  static __device__ __forceinline__ void mma(int (&d)[64], uint64_t da,
                                             uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  // d (+)= A (64 x 32, K-major, smem) . B (256 x 32, K-major, smem)^T
  static __device__ __forceinline__ void mma(int (&d)[128], uint64_t da,
                                             uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
  }
};

// Registers of a thread's accumulator, m64nBN layout: warp w of the
// warpgroup holds rows 16w..16w+15; lane (g = lane / 4, t = lane % 4) holds
// d[4j + 2h + b] = (row 16w + g + 8h, column 8j + 2t + b).
template <typename T, int BN>
__global__ void __launch_bounds__(THREADS, 1)
    wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                 const __grid_constant__ CUtensorMap map_w,
                 const float* __restrict__ xs, const float* __restrict__ ws,
                 T* __restrict__ out, int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  const int e = blockIdx.z;  // the expert: its rows of x, w_t and out
  if (xs) xs += (size_t)e * M;
  if (ws) ws += (size_t)e * N;
  out += (size_t)e * M * N;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t a_s = raw + ((1024 - (raw & 1023)) & 1023);  // 1024-aligned
  const uint32_t b_s = a_s + STAGES * BM * BK;
  const uint32_t bars = b_s + STAGES * BN * BK;
  // full[s] at bars + 8 s, empty[s] at bars + 8 (STAGES + s)
  const int KT = (K + BK - 1) / BK;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);                 // the producer's expect_tx
      mbar_init(bars + 8 * (STAGES + s), 2);      // one arrive per consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wgi == 0) {
    // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int s = 0;
      uint32_t ph = 0;
      for (int kt = 0; kt < KT; ++kt) {
        mbar_wait(bars + 8 * (STAGES + s), ph ^ 1);
        mbar_expect_tx(bars + 8 * s, (BM + BN) * BK);
        tma_load(a_s + s * BM * BK, &map_x, bars + 8 * s, kt * BK, m0, e);
        tma_load(b_s + s * BN * BK, &map_w, bars + 8 * s, kt * BK, n0, e);
        if (++s == STAGES) { s = 0; ph ^= 1; }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wgi - 1;  // this warpgroup's 64 rows of the tile
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    int s = 0, prev = 0;
    uint32_t ph = 0;
    for (int kt = 0; kt < KT; ++kt) {
      mbar_wait(bars + 8 * s, ph);
      const uint64_t da = desc_sw128(a_s + s * BM * BK + c * 64 * BK);
      const uint64_t db = desc_sw128(b_s + s * BN * BK);
      fence_acc(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
        Wgmma<BN>::mma(acc, da + 2 * kk, db + 2 * kk);
      wg_commit();
      wg_wait<1>();  // the previous slice's products are done: free it
      fence_acc(acc);
      if (kt > 0 && threadIdx.x % 128 == 0)
        mbar_arrive(bars + 8 * (STAGES + prev));
      prev = s;
      if (++s == STAGES) { s = 0; ph ^= 1; }
    }
    wg_wait<0>();
    fence_acc(acc);

    // Epilogue: scale and round in registers, stage this warpgroup's 64 x BN
    // tile in shared memory (rows padded by 16 bytes against bank
    // conflicts), then store it in 16-byte pieces, neighbouring lanes on
    // neighbouring addresses. The stage buffers are free once both
    // consumers are past their last product.
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    constexpr int ROW_BYTES = BN * (int)sizeof(T) + 16;
    uint8_t* tile = smem_raw + (a_s - raw) + c * 64 * ROW_BYTES;
    const int lane = threadIdx.x % 32, w = (threadIdx.x % 128) / 32;
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = w * 16 + g + 8 * h, row = m0 + c * 64 + r;
      const float xsv = row < M ? scale_at(xs, row) : 0.f;
      T* trow = reinterpret_cast<T*>(tile + r * ROW_BYTES);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        const float ws0 = col < N ? scale_at(ws, col) : 0.f;
        const float ws1 = col + 1 < N ? scale_at(ws, col + 1) : 0.f;
        store2(trow + 8 * j + 2 * t, (float)acc[4 * j + 2 * h] * xsv * ws0,
               (float)acc[4 * j + 2 * h + 1] * xsv * ws1);
      }
    }
    asm volatile("bar.sync %0, 128;\n" :: "r"(2 + c) : "memory");
    constexpr int VEC = 16 / (int)sizeof(T);  // outputs in 16 bytes
    constexpr int PIECES = BN / VEC;          // 16-byte pieces in a row
    const bool whole = N % VEC == 0;          // rows start 16-byte aligned
    for (int i = threadIdx.x % 128; i < 64 * PIECES; i += 128) {
      const int r = i / PIECES, c0 = (i % PIECES) * VEC;
      const int row = m0 + c * 64 + r, col = n0 + c0;
      if (row >= M || col >= N) continue;
      const uint8_t* src = tile + r * ROW_BYTES + c0 * (int)sizeof(T);
      T* dst = out + (size_t)row * N + col;
      if (whole) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < VEC && col + e < N; ++e)
          dst[e] = reinterpret_cast<const T*>(src)[e];
      }
    }
  }
}

// E stacked (rows, K) int8 matrices, K contiguous, loaded in boxes of
// box_rows x 128 bytes of one matrix with the 128-byte swizzle; elements
// out of a matrix's range read as 0.
bool tensor_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                int E, int rows, int K, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)rows, (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)K, (cuuint64_t)rows * K};
  const cuuint32_t box[3] = {(cuuint32_t)BK, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(ptr),
                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int BN>
int launch(const void* x, const void* xs, const void* w, const void* ws,
           void* out, int E, int M, int N, int K, cudaStream_t stream) {
  const EncodeTiled encode = encoder();
  if (!encode) return (int)cudaErrorNotSupported;
  CUtensorMap mx, mw;
  if (!tensor_map(encode, &mx, x, E, M, K, BM) ||
      !tensor_map(encode, &mw, w, E, N, K, BN))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = smem_bytes<BN>();
  cudaError_t e = cudaFuncSetAttribute(
      wgmma_kernel<T, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, E);
  wgmma_kernel<T, BN><<<grid, THREADS, smem, stream>>>(
      mx, mw, (const float*)xs, (const float*)ws, (T*)out, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace wg

// ---------------------------------------- B: weight-streaming, M <= 16 --

namespace stream {

constexpr int WARPS = 8, THREADS = 32 * WARPS, ROWS = 16, UNROLL = 4;

__device__ __forceinline__ void mma(int (&c)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// MT token tiles of 8: 1 for M <= 8, 2 for M <= 16.
// Lane (g = lane / 4, t = lane % 4) of a warp loads, per 64-byte chunk of
// K at k, bytes [k + 16t, k + 16t + 16) of w_t rows n0 + g and n0 + g + 8
// and of x rows g (+ 8). m16n8k32's fragments give lane (g, t) k slots
// 4t..4t+3 and 16+4t..16+4t+3 of A rows g, g + 8 and B column g, so two
// MMAs take the 16 bytes as slots (0-3, 4-7) and (8-11, 12-15): the same
// map of slots to bytes for both operands. Accumulator c[mt] holds
// (n g, m 8mt+2t), (g, 8mt+2t+1), (g+8, 8mt+2t), (g+8, 8mt+2t+1).
template <typename T, int MT>
__global__ void __launch_bounds__(THREADS, 2)
    stream_kernel(const int8_t* __restrict__ x, const float* __restrict__ xs,
                  const int8_t* __restrict__ w, const float* __restrict__ ws,
                  T* __restrict__ out, int M, int N, int K) {
  __shared__ int red[WARPS][ROWS][8 * MT];
  const int e = blockIdx.y;  // the expert: one weight slab a grid row
  x += (size_t)e * M * K;
  w += (size_t)e * N * K;
  if (xs) xs += (size_t)e * M;
  if (ws) ws += (size_t)e * N;
  out += (size_t)e * M * N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * ROWS;
  const bool lo_ok = n0 + g < N, hi_ok = n0 + g + 8 < N;
  const int8_t* wlo = w + (size_t)(lo_ok ? n0 + g : 0) * K + 16 * t;
  const int8_t* whi = w + (size_t)(hi_ok ? n0 + g + 8 : 0) * K + 16 * t;
  const int8_t* xr[MT];
  bool x_ok[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    x_ok[mt] = g + 8 * mt < M;
    xr[mt] = x + (size_t)(x_ok[mt] ? g + 8 * mt : 0) * K + 16 * t;
  }
  int c[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[mt][i] = 0;

  const uint4 zero = make_uint4(0, 0, 0, 0);
  const int chunks = (K + 63) / 64;
  for (int sc = warp * UNROLL; sc < chunks; sc += WARPS * UNROLL) {
    uint4 a[UNROLL], b[UNROLL], xv[UNROLL][MT];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int k = (sc + u) * 64;
      const bool k_ok = k + 16 * t < K;
      a[u] = (k_ok && lo_ok)
                 ? __ldcs(reinterpret_cast<const uint4*>(wlo + k)) : zero;
      b[u] = (k_ok && hi_ok)
                 ? __ldcs(reinterpret_cast<const uint4*>(whi + k)) : zero;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        xv[u][mt] = (k_ok && x_ok[mt])
                        ? __ldg(reinterpret_cast<const uint4*>(xr[mt] + k))
                        : zero;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma(c[mt], a[u].x, b[u].x, a[u].y, b[u].y, xv[u][mt].x, xv[u][mt].y);
        mma(c[mt], a[u].z, b[u].z, a[u].w, b[u].w, xv[u][mt].z, xv[u][mt].w);
      }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    red[warp][g][8 * mt + 2 * t] = c[mt][0];
    red[warp][g][8 * mt + 2 * t + 1] = c[mt][1];
    red[warp][g + 8][8 * mt + 2 * t] = c[mt][2];
    red[warp][g + 8][8 * mt + 2 * t + 1] = c[mt][3];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ROWS * 8 * MT; i += THREADS) {
    const int m = i / ROWS, r = i % ROWS, n = n0 + r;
    if (m < M && n < N) {
      int acc = 0;
#pragma unroll
      for (int v = 0; v < WARPS; ++v) acc += red[v][r][m];
      store1(out + (size_t)m * N + n,
             (float)acc * scale_at(xs, m) * scale_at(ws, n));
    }
  }
}

template <typename T>
int launch(const void* x, const void* xs, const void* w, const void* ws,
           void* out, int E, int M, int N, int K, cudaStream_t stream) {
  const dim3 grid((N + ROWS - 1) / ROWS, E);
  if (M <= 8)
    stream_kernel<T, 1><<<grid, THREADS, 0, stream>>>(
        (const int8_t*)x, (const float*)xs, (const int8_t*)w,
        (const float*)ws, (T*)out, M, N, K);
  else
    stream_kernel<T, 2><<<grid, THREADS, 0, stream>>>(
        (const int8_t*)x, (const float*)xs, (const int8_t*)w,
        (const float*)ws, (T*)out, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace stream

// ------------------------------------- fallback: __dp4a, K % 16 != 0 --

namespace dp4a {

constexpr int BM = 64, BN = 64, BK = 32, THREADS = 256;
constexpr int BK4 = BK / 4;

// Word of four K-consecutive bytes of row `row` (of a K-long row-major
// int8 matrix with `rows` rows) at k; out-of-range bytes are 0.
__device__ __forceinline__ int word(const int8_t* a, int row, int rows, int k,
                                   int K) {
  unsigned v = 0;
  if (row < rows) {
    const int8_t* r = a + (size_t)row * K;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (k + b < K) v |= (unsigned)(uint8_t)r[k + b] << (8 * b);
  }
  return (int)v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    dp4a_kernel(const int8_t* __restrict__ x, const float* __restrict__ xs,
                const int8_t* __restrict__ w, const float* __restrict__ ws,
                T* __restrict__ out, int M, int N, int K) {
  const int e = blockIdx.z;  // the expert
  x += (size_t)e * M * K;
  w += (size_t)e * N * K;
  if (xs) xs += (size_t)e * M;
  if (ws) ws += (size_t)e * N;
  out += (size_t)e * M * N;
  // k-major so that threads of a warp read neighbouring words
  __shared__ int As[BK4][BM];
  __shared__ int Bs[BK4][BN];
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = t; i < BK4 * BM; i += THREADS)
      As[i / BM][i % BM] = word(x, m0 + i % BM, M, k0 + 4 * (i / BM), K);
    for (int i = t; i < BK4 * BN; i += THREADS)
      Bs[i / BN][i % BN] = word(w, n0 + i % BN, N, k0 + 4 * (i / BN), K);
    __syncthreads();
#pragma unroll
    for (int k4 = 0; k4 < BK4; ++k4) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k4][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k4][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N)
        store1(out + (size_t)m * N + n,
               (float)acc[i][j] * scale_at(xs, m) * scale_at(ws, n));
    }
  }
}

template <typename T>
int launch(const void* x, const void* xs, const void* w, const void* ws,
           void* out, int E, int M, int N, int K, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, E);
  dp4a_kernel<T><<<grid, THREADS, 0, stream>>>(
      (const int8_t*)x, (const float*)xs, (const int8_t*)w, (const float*)ws,
      (T*)out, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace dp4a

template <typename T>
int dispatch(const void* x, const void* xs, const void* w, const void* ws,
             void* out, int E, int M, int N, int K, int design, int tile_n,
             cudaStream_t s) {
  switch (design) {
    case 0: return dp4a::launch<T>(x, xs, w, ws, out, E, M, N, K, s);
    case 1:
      if (tile_n == 256)
        return wg::launch<T, 256>(x, xs, w, ws, out, E, M, N, K, s);
      if (tile_n == 128)
        return wg::launch<T, 128>(x, xs, w, ws, out, E, M, N, K, s);
      return (int)cudaErrorInvalidValue;
    case 2:
      if (M > 16) return (int)cudaErrorInvalidValue;
      return stream::launch<T>(x, xs, w, ws, out, E, M, N, K, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x (E, M, K) int8, xs (E, M) fp32, w_t (E, N, K) int8, ws (E, N) fp32 ->
// out (E, M, N), each expert's product on its own (E = 1: the 2-D
// product); a null xs or ws stands for unit scales.
// design: 0 = __dp4a fallback, 1 = A (wgmma tiles of 128 x tile_n, tile_n
// 128 or 256), 2 = B (weight streaming, M <= 16); A and B need K % 16 == 0
// and 16-byte aligned x and w_t. out_dtype: 0 = fp32, 1 = bf16, 2 = fp16.
// Returns cudaGetLastError() of the launch (or the error that kept it from
// launching).
extern "C" int int8_matmul(const void* x, const void* xs, const void* w,
                           const void* ws, void* out, int E, int M, int N,
                           int K, int out_dtype, int design, int tile_n,
                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (E < 1 || E > 65535) return (int)cudaErrorInvalidValue;
  if (design != 0 && (K % 16 != 0 || ((uintptr_t)x | (uintptr_t)w) % 16))
    return (int)cudaErrorInvalidValue;
  switch (out_dtype) {
    case 0:
      return dispatch<float>(x, xs, w, ws, out, E, M, N, K, design, tile_n,
                             s);
    case 1:
      return dispatch<__nv_bfloat16>(x, xs, w, ws, out, E, M, N, K, design,
                                     tile_n, s);
    case 2:
      return dispatch<__half>(x, xs, w, ws, out, E, M, N, K, design, tile_n,
                              s);
    default: return (int)cudaErrorInvalidValue;
  }
}

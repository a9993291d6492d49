// The "tc" design of the port's blocked online-softmax (flash) attention
// for Hopper (sm_90a): bf16 q, k, v and o at hd 64, 80, 128 or 256.
//
// Replaces, with csrc/flash_attention.cu, the Pallas TPU kernel
// src/repro/kernels/flash_attention.py (flash_attention / _kernel).
// flash_attention.cu's header sets out the function (start-aligned
// positions, causal, window, softcap, the caller's (bq, bk) block-skip
// rule with its kv_keep_stride perforation, fp32 softmax, P rounded to
// bf16 before P.V) and the bound: at the paths' bf16 shapes the products
// on the tensor cores, beside the exps on the SFU. This file is its own
// library (entry flash_attention_tc, the same arguments as
// flash_attention's), so that the two sources compile side by side.
//
// tc (bf16, hd 64, 80, 128 or 256). A block takes one 64-row query tile of
//    one KV head and holds that head's query heads of the GQA group, up to
//    3 (heads beyond go to another block of the grid, the group split
//    as evenly as that allows): warpgroup 0 produces, warpgroup 1 + c is
//    the consumer of head c. One producer warp walks the key tiles the
//    block's rows need (the rule of flash_attention.cu's header, from each
//    row's span of running and kept keys; tile_walk mirrors it at the tile
//    widths below) and keeps K and V tiles in flight with TMA (3D maps,
//    128-byte swizzle, zero fill past Skv: V = 0 in the padded tail)
//    through a ring of 3 stages (2 for two heads at hd 256) guarded by
//    full and empty mbarriers for K and for V, each stage's slot naming
//    its tile, -1 ending the walk; Q is loaded once. At 3
//    stages a stage's K and V free together once P.V of its tile is done;
//    at 2 its K frees once S is done, so the K of tile i + 2 loads while
//    P.V of tile i runs (gemma3-12b's global shape: 0.8658 ms against
//    1.1927 with both freed after P.V; at 3 stages the early K cost 1-7%:
//    H100, tools/flash_bench.py). Each K/V tile is staged once for every
//    head of the block. setmaxnreg gives the
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
//    thread gets).
//    hd 256: a head's Q tile and a 64-key K or V tile take 32 KB each, so
//    a block holds 1 head over 3 stages (32 + 192 KB + barriers: 230,492
//    of the 232,448 bytes a block may have) or 2 heads over 2 (64 + 128
//    KB); 128-key tiles do not fit. A consumer thread holds O's 64 x 256
//    fp32 fragment in 128 registers, S at 64 keys in 32 and P's bf16 A
//    operand in 16: one head a warpgroup fits the 224 setmaxnreg gives
//    two consumers (and the 255 of a block of one; ptxas -v: no spills),
//    three would not. P.V
//    is two m64n128k16 products a k-step, dims 0-127 and 128-255 (V's
//    boxes 0-1 and 2-3) on the two halves of the fragment. Two heads a
//    block stage each K/V tile once for both (gemma3-12b's GQA 2:1: 0.8658
//    / 0.3584 ms causal / window 1024 against 1.1083 / 0.4802 one head a
//    block); where blocks of two would not fill the card (fewer than the
//    SMs: paligemma-3b's MQA 8:1 at 2 x 512 tokens makes 64) a block takes
//    one head (0.0196 ms against 0.0262 two heads a block; H100,
//    tools/flash_bench.py).
//    MHA (R 1): one head a block would leave one consumer warpgroup an SM,
//    its softmax in series with its own products; so a block of 2
//    consumers takes two consecutive 64-row query tiles of the one head
//    (a 128-row tile, tile_walk at tile_q 128), sharing each K/V tile as a
//    GQA group's heads do, where such blocks fill the card: zamba2-2.7b's
//    handoff 0.1283 ms against 0.2067, whisper's encoder 0.2434 against
//    0.3474; a grid of 32 such blocks 0.0339 against 0.0272 (H100,
//    tools/flash_bench.py).
//    hd 80: the hd-128 instance. The tensor maps keep the inputs' inner
//    dimension (80, rows of 160 bytes), so the second 64-dim box reads dims
//    64-127 with 80-127 zero-filled by TMA: they add nothing to Q.K^T and
//    make output columns 80-127, which are never stored.
//    Blocks run heaviest query tile first, every head of a
//    batch side by side when the batch's K/V fit in half the L2, else one
//    KV head's tiles after another. No branch lies between a wgmma's issue
//    and its wait, and S's accumulator is written fresh each tile, so
//    ptxas keeps the wgmmas pipelined (no C7514/C7515 serialization).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------- tc --

namespace tc {

using namespace hopper;

constexpr int TQ = 64;           // query rows a block, for each of its heads
constexpr long L2_HALF = 25L << 20;   // half the H100's 50 MB L2
constexpr int BOX = 64;          // dims a TMA box: 128 bytes, the swizzle's
constexpr int BOX_BYTES = 64 * 128;   // one box of 64 rows
constexpr int FULL = 1 << 30;    // slot flag: every entry of the tile kept
constexpr int MAX_HEADS = 3;     // consumer warpgroups a block (hd <= 128)
constexpr int MAX_HEADS_256 = 2; // the same at hd 256
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  __nv_bfloat16* o;
  int H, KVH, Sq, Skv, hd, bq, bk, causal, window, stride, n_kpad, ngrp,
      cap;
  int hgrp;   // head groups (blocks of a query tile) side by side
  int rows;   // 64-row query tiles a block: 1, or NH (R 1: the consumers
              // take consecutive tiles of one head)
  float s2;   // scale log2(e): the score in log2 units when no cap is set
  float c1;   // 2 scale log2(e) / cap: e^(2 x scale / cap) = 2^(x c1)
  float c2;   // cap log2(e): cap tanh(.) in log2 units
};

// Shared memory, from a 1024-aligned base: Q of each head (HD / 64 boxes of
// 64 rows x 128 swizzled bytes), the K and the V ring (HD / 64 boxes of TK
// rows a tile, STAGES tiles), the barriers (Q; full K, full V, empty K and
// empty V per stage) and a slot per stage naming its tile (-1: the walk is
// over).
template <int HD, int NH, int TK, int STAGES>
struct Layout {
  static constexpr int QTILE = TQ * HD * 2;  // a head's Q
  static constexpr int TILE = TK * HD * 2;   // a K or V tile
  static constexpr int KBOX = TK * 128;      // a K or V box: TK rows
  static constexpr int K = NH * QTILE;
  static constexpr int V = K + STAGES * TILE;
  static constexpr int BAR = V + STAGES * TILE;
  static constexpr int SLOT = BAR + 8 * (1 + 4 * STAGES);
  static constexpr int BYTES = SLOT + 4 * STAGES + 1024;
  static_assert(BYTES <= 232448, "tc: shared memory");
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
// perforation, for the block's rows q0 .. q0 + nr - 1: every entry kept
// (a kept entry's block always runs at stride 1), none evaluated.
template <int TK>
__device__ __forceinline__ bool tile_full(const Args& a, int q0, int nr,
                                          int k0) {
  return a.stride <= 1 && (!a.causal || k0 + TK - 1 <= q0) &&
         (!a.window || k0 > q0 + nr - 1 - a.window) && k0 + TK <= a.Skv;
}

// One block: query rows q0 .. q0 + 64 a.rows - 1 of heads h0 .. h0 +
// hcount - 1, all reading KV head kvh. Warpgroup 0 is the producer (its
// warp 0 walks the tiles; thread 0 issues TMA), warpgroup 1 + c the
// consumer of head h0 + c, rows q0 .. q0 + 63 (a.rows 1), or of head h0,
// rows q0 + 64 c .. q0 + 64 c + 63 (a.rows NH: R 1, the K/V tiles shared
// by two query tiles as a GQA group's heads share them). Accumulator
// fragment (wgmma m64nN): warp w of a warpgroup holds
// rows 16w .. 16w + 15; lane (g = lane / 4, t = lane % 4) holds
// d[4j + 2h + b] = (row 16w + g + 8h, column 8j + 2t + b).
template <int HD, int NH, int TK, int STAGES>
__global__ void __launch_bounds__(128 * (NH + 1), 1)
    tc_kernel(const __grid_constant__ CUtensorMap mq,
              const __grid_constant__ CUtensorMap mk,
              const __grid_constant__ CUtensorMap mv, const Args a) {
  using L = Layout<HD, NH, TK, STAGES>;
  constexpr int NS = TK / 2;                    // S registers a thread
  constexpr int NB = HD / BOX;                  // boxes a row
  // At 2 stages a stage's K frees once S of its tile is done (the next
  // tile's K at the end of this step), so K of tile i + 2 loads while P.V
  // of tile i runs; at 3, with its V once P.V is done (1-7% faster there,
  // tools/flash_bench.py on an H100).
  constexpr bool EARLY_K = STAGES < 3;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t bar_q = base + L::BAR, bar_k = bar_q + 8,
                 bar_v = bar_k + 8 * STAGES, bar_ek = bar_v + 8 * STAGES,
                 bar_ev = bar_ek + 8 * STAGES;
  volatile int* slots =
      reinterpret_cast<volatile int*>(smem_raw + (base - raw) + L::SLOT);

  const int R = a.H / a.KVH;
  // Block order (x): a.hgrp head groups at a time, their query tiles
  // heaviest first (causal), the groups of a query tile side by side.
  const int nr = TQ * a.rows;                   // the block's rows
  const int nq = (a.Sq + nr - 1) / nr, nhy = a.KVH * a.ngrp;
  const int gi = blockIdx.x / (nq * a.hgrp), g0 = gi * a.hgrp;
  const int gsz = min(a.hgrp, nhy - g0), rem = blockIdx.x - g0 * nq;
  const int qx = rem / gsz, hy = g0 + rem % gsz;
  const int kvh = hy / a.ngrp, grp = hy % a.ngrp;
  const int h0 = kvh * R + grp * NH;
  const int hcount = a.rows > 1 ? NH : min(NH, R - grp * NH);
  const int b = blockIdx.y;
  const int q0 = (nq - 1 - qx) * nr;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_ek + 8 * s, hcount);    // one arrive per consumer
      mbar_init(bar_ev + 8 * s, hcount);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // setmaxnreg moves registers within the block's launch allocation (a
    // consumer's inc past it would wait forever): at NH 2 384 x 168 =
    // 64,512 >= 128 x 48 + 256 x 224 (the producer's walk judges 4 rows a
    // lane under the row split; at 40 it spilled), at NH 3 512 x 128 =
    // 65,536 >= 128 x 40 + 384 x 152
    if constexpr (NH == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 48;\n");
    if constexpr (NH == 3)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x >= 32) return;
    // producer: Q once, then the walk. A tile is visited when it keeps an
    // entry, or a row that has kept none yet has an entry of a running
    // block in it (kernels/flash_attention.py tile_walk mirrors this).
    const int lane = threadIdx.x;
    if (lane == 0) {
      mbar_expect_tx(bar_q, hcount * L::QTILE);
      for (int i = 0; i < hcount; ++i)
        for (int x = 0; x < NB; ++x)
          tma_load(base + i * L::QTILE + x * BOX_BYTES, &mq, bar_q, x * BOX,
                   a.rows > 1 ? q0 + TQ * i : q0,
                   b * a.H + h0 + (a.rows > 1 ? 0 : i));
    }
    int kend = a.n_kpad;
    if (a.causal) {
      const int i_last = (min(q0 + nr, a.Sq) - 1) / a.bq;
      kend = min(kend, ((i_last + 1) * a.bq + a.bk - 1) / a.bk * a.bk);
    }
    const int nt = (kend + TK - 1) / TK;
    int t = 0;
    if (a.window) t = max(0, (q0 / a.bq) * a.bq - a.window - a.bk) / TK;
    // lane l judges rows q0 + l + 32 i of the block, i < 2 a.rows (the
    // row split is taken at NH 2 only); bit i of kept: that row has kept
    // an entry. At NH 2 the spans are recomputed a tile, which keeps the
    // producer's walk in its registers.
    constexpr int NJ = NH == 2 ? 4 : 2;
    const Span sp[2] = {row_span(a, q0 + lane), row_span(a, q0 + lane + 32)};
    uint32_t kept = 0;
    int s = 0;
    uint32_t ph = 0;
    for (; t < nt; ++t) {
      const int k0 = t * TK;
      const bool full = tile_full<TK>(a, q0, nr, k0);
      bool need = full;
      if (!full) {
#pragma unroll
        for (int i = 0; i < NJ; ++i) {
          const int qp = q0 + lane + 32 * i;
          if (i >= 2 * a.rows || qp >= a.Sq) continue;
          const int seen = row_seen<TK>(
              a, NH != 2 ? sp[i & 1] : row_span(a, qp), k0);
          need = need || (seen & 2) || ((seen & 1) && !((kept >> i) & 1));
          if (seen & 2) kept |= 1u << i;
        }
        need = __any_sync(0xffffffffu, need);
      }
      if (!need) continue;
      // K of a stage frees once S of its tile is done, V once P.V is: K
      // of tile i + 2 loads while P.V of tile i runs, even at 2 stages
      mbar_wait(bar_ek + 8 * s, ph ^ 1);
      if (lane == 0) {
        slots[s] = t | (full ? FULL : 0);
        mbar_expect_tx(bar_k + 8 * s, L::TILE);
        for (int x = 0; x < NB; ++x)
          tma_load(base + L::K + s * L::TILE + x * L::KBOX, &mk,
                   bar_k + 8 * s, x * BOX, k0, b * a.KVH + kvh);
      }
      __syncwarp();
      mbar_wait(bar_ev + 8 * s, ph ^ 1);
      if (lane == 0) {
        mbar_expect_tx(bar_v + 8 * s, L::TILE);
        for (int x = 0; x < NB; ++x)
          tma_load(base + L::V + s * L::TILE + x * L::KBOX, &mv,
                   bar_v + 8 * s, x * BOX, k0, b * a.KVH + kvh);
      }
      __syncwarp();
      if (++s == STAGES) { s = 0; ph ^= 1; }
    }
    mbar_wait(bar_ek + 8 * s, ph ^ 1);
    if (lane == 0) {
      slots[s] = -1;
      mbar_arrive(bar_k + 8 * s);
    }
    return;
  }

  if constexpr (NH == 2)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
  if constexpr (NH == 3)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 152;\n");
  const int c = wg - 1;
  if (c >= hcount) return;
  const int w = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = a.rows > 1 ? q0 + TQ * c : q0;  // the consumer's rows
  const int rows[2] = {r0 + 16 * w + g, r0 + 16 * w + g + 8};
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
  // O += P . V, V of stage s from shared memory as the MN-major B operand;
  // at hd 256 as two n128 products, dims 0-127 (boxes 0-1) and 128-255
  // (boxes 2-3), each on its half of the fragment
  auto issue_pv = [&](int s, uint32_t (&pa)[TK / 16][4]) {
    const uint32_t vs = base + L::V + s * L::TILE;
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      if constexpr (HD == 256) {
        mma_rs(*reinterpret_cast<float(*)[64]>(&o[0]), pa[kk],
               desc_mn<TK>(vs + kk * 2048));
        mma_rs(*reinterpret_cast<float(*)[64]>(&o[64]), pa[kk],
               desc_mn<TK>(vs + 2 * L::KBOX + kk * 2048));
      } else {
        mma_rs(o, pa[kk], desc_mn<TK>(vs + kk * 2048));
      }
    }
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
  // the tensor cores; P is packed once P.V is done, and then the next
  // tile's K and this tile's V are released. No branch lies between a
  // product's issue and its wait.
  mbar_wait(bar_q, 0);
  mbar_wait(bar_k, 0);
  int slot = slots[0];
  if (slot >= 0) {
    issue_s(0);
    wg_wait<0>();
    fence_acc(sc);
    if (EARLY_K && threadIdx.x % 128 == 0) mbar_arrive(bar_ek);
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
      if (threadIdx.x % 128 == 0) {
        mbar_arrive(bar_ek + 8 * (EARLY_K ? s1 : s));
        mbar_arrive(bar_ev + 8 * s);
      }
      pack();
      s = s1;
      ph = ph1;
    }
    rescale();                              // the last tile's P.V
    mbar_wait(bar_v + 8 * s, ph);
    issue_o(s);
    wg_wait<0>();
    fence_acc(o);
    if (threadIdx.x % 128 == 0) {
      if (!EARLY_K) mbar_arrive(bar_ek + 8 * s);
      mbar_arrive(bar_ev + 8 * s);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  // columns past a.hd (hd 80 on the 128 instance) hold zeros: not stored
  __nv_bfloat16* ob =
      a.o + ((size_t)b * a.H + h0 + (a.rows > 1 ? 0 : c)) * a.Sq * a.hd;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rows[h] >= a.Sq) continue;
    const float inv = 1.f / fmaxf(l[h], 1e-30f);
    __nv_bfloat16* orow = ob + (size_t)rows[h] * a.hd + 2 * t4;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      if (8 * j + 2 * t4 < a.hd)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2 * h] * inv,
                                  o[4 * j + 2 * h + 1] * inv);
  }
}

// A (heads, rows, hd) bf16 tensor in boxes of 64 dims x box_rows rows x 1
// head, 128-byte swizzle; rows past `rows` of a head, and dims past hd
// (hd 80: the second box's dims 80-127), read as 0.
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

template <int HD, int NH, int TK, int STAGES>
int launch(const void* q, const void* k, const void* v, int B, const Args& a,
           cudaStream_t stream) {
  const EncodeTiled encode = encoder();
  if (!encode) return (int)cudaErrorNotSupported;
  CUtensorMap mq, mk, mv;
  if (!tensor_map(encode, &mq, q, B * a.H, a.Sq, a.hd, TQ) ||
      !tensor_map(encode, &mk, k, B * a.KVH, a.Skv, a.hd, TK) ||
      !tensor_map(encode, &mv, v, B * a.KVH, a.Skv, a.hd, TK))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = Layout<HD, NH, TK, STAGES>::BYTES;
  static bool granted = false;
  if (!granted) {
    cudaError_t e = cudaFuncSetAttribute(
        tc_kernel<HD, NH, TK, STAGES>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    granted = true;
  }
  const int nr = TQ * a.rows;
  dim3 grid((a.Sq + nr - 1) / nr * a.KVH * a.ngrp, B);
  tc_kernel<HD, NH, TK, STAGES><<<grid, 128 * (NH + 1), smem, stream>>>(
      mq, mk, mv, a);
  return (int)cudaGetLastError();
}

int sm_count() {
  static int n = 0;
  if (!n) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 132;
  }
  return n;
}

// The GQA group of R = H / KVH heads in ngrp blocks of up to MAX_HEADS
// (MAX_HEADS_256 at hd 256). HD is the instance's width, a.hd the inputs'.
// A block of two consumers (two heads at hd 256, two query tiles of one
// head at R 1) where such blocks number at least the SMs; else one
// consumer a block (at hd 256 over 3 stages), so that a small grid
// spreads over more SMs.
template <int HD>
int dispatch(const void* q, const void* k, const void* v, int B, Args a,
             cudaStream_t s) {
  const int R = a.H / a.KVH;
  const long nq = (a.Sq + TQ - 1) / TQ;
  const long fill = sm_count();
  int maxh = HD == 256 ? MAX_HEADS_256 : MAX_HEADS;
  if (HD == 256 && R > 1 && nq * a.KVH * ((R + 1) / 2) * B < fill) maxh = 1;
  a.ngrp = (R + maxh - 1) / maxh;
  int nh = (R + a.ngrp - 1) / a.ngrp;
  a.rows = 1;
  if (R == 1 && nq > 1 && (nq + 1) / 2 * a.KVH * B >= fill)
    nh = a.rows = 2;
  if (nq * a.KVH * a.ngrp > 0x7fffffff) return (int)cudaErrorInvalidValue;
  // Every head at each query tile, heaviest first, when a batch's K and V
  // fit in half the L2 (phi4-mini's training cell, 16.8 MB: 0.386 against
  // 0.406 ms head by head); else one KV head's query tiles after another,
  // the blocks at the card sharing that head's K/V (gemma2-27b's prefill,
  // 62 MB: 0.877 against 0.927-0.958 ms in groups of 3 to 10 heads; H100,
  // tools/flash_bench.py).
  const bool all_heads = (long)a.KVH * a.Skv * a.hd * 4 <= L2_HALF;
  a.hgrp = all_heads ? a.KVH * a.ngrp : a.ngrp;
  if constexpr (HD == 256) {
    return nh == 1 ? launch<HD, 1, 64, 3>(q, k, v, B, a, s)
                   : launch<HD, 2, 64, 2>(q, k, v, B, a, s);
  } else {
    switch (nh) {
      case 1: return launch<HD, 1, 128, 3>(q, k, v, B, a, s);
      case 2: return launch<HD, 2, 128, 3>(q, k, v, B, a, s);
      default: return launch<HD, 3, 64, 3>(q, k, v, B, a, s);
    }
  }
}

}  // namespace tc
}  // namespace

// flash_attention's arguments (csrc/flash_attention.cu) for design 2 = tc:
// dtype 1 (bf16), hd 64, 80, 128 or 256, every pointer 16-byte aligned, hd
// a multiple of 16, H a multiple of KVH, and bq, bk >= 1 (the caller's
// block grid, already clipped to Sq and Skv). Returns cudaGetLastError()
// of the launch.
extern "C" int flash_attention_tc(const void* q, const void* k,
                                  const void* v, void* o, int B, int H,
                                  int KVH, int Sq, int Skv, int hd, int bq,
                                  int bk, int causal, int window, int stride,
                                  float cap, float scale, int dtype,
                                  int design, void* stream) {
  if (design != 2 || dtype != 1 ||
      (hd != 64 && hd != 80 && hd != 128 && hd != 256) || KVH <= 0 ||
      H % KVH || bq <= 0 || bk <= 0 || Sq <= 0 || Skv <= 0 || B <= 0 ||
      B > 65535 || H > 65535 ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16)
    return (int)cudaErrorInvalidValue;
  // hd 80 runs the 128 instances, its dims past 80 zero-filled
  tc::Args a{(__nv_bfloat16*)o, H, KVH, Sq, Skv, hd, bq, bk, causal,
             window, stride, (Skv + bk - 1) / bk * bk, 1, cap != 0.f, 1, 1,
             scale * tc::LOG2E,
             cap != 0.f ? 2.f * scale * tc::LOG2E / cap : 0.f,
             cap * tc::LOG2E};
  cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 64: return tc::dispatch<64>(q, k, v, B, a, s);
    case 256: return tc::dispatch<256>(q, k, v, B, a, s);
    default: return tc::dispatch<128>(q, k, v, B, a, s);
  }
}

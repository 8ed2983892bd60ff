// The Swin block's products on Hopper (sm_90a): every product of K1, of
// K4's forward, and K4's backward dX and dW (replaces the
// jax.lax.dot_general calls of _make_block_kernel and of
// _make_block_train_bwd_kernel in kvq_tpu/ops/window_attention.py).  One
// template, gemm_kernel<BN, EPI>, in three layouts (the epilogue EPI sets
// the layout):
//
//   forward  out (M, N) = epi(A (M, K) @ W (N, K)^T)   A, B K-major
//   dX       out (M, N) = epi(dY (M, K) @ W (K, N))    A K-major, B N-major
//   dW       out (M, N) += dY (K, M)^T @ X (K, N)      A, B M/N-major, the
//            K = token rows split over the grid, summed with f32 atomics
//
// Bound on this card: at stages 0-1 of the Swin trunk (C = 96, 192) a
// product does 2 N or 2 M FLOPs per byte it must move, under the card's
// ~295, so the bytes bound it; at stages 2-3 the products sit near the
// ridge.  The design:
//
// - Products on wgmma.mma_async m64nBNk16 (bf16 in, f32 accumulators in
//   registers), both operands read from shared memory in the 128-byte
//   swizzle.  A tile is 128 rows: two consumer warpgroups of 64 rows each
//   share the B tile.  BN, the tile width, is 96, 128, 144 or 192 (the
//   256-wide tile, 128 accumulators a thread, spills at the 168 registers
//   that 384 threads an SM leave) and is chosen on the host per product
//   (ops/gemm.py: plan_gemm), so that N = 96, 288, 384 ... fill their
//   tiles and the small-M stages still fill the card.
// - Copies by TMA (cp.async.bulk.tensor.2d) from one producer thread into a
//   ring of kStages 64-deep k-tiles, each with a full and an empty
//   mbarrier: no __syncthreads in the main loop.  K-major operands load as
//   one box of 64 k x rows; M/N-major ones (the transposes of dX and dW) as
//   boxes of 64 rows of k x 64 columns, which wgmma reads with its
//   transpose bit.  Ragged edges (M, N or K past the tensor) come in as
//   zeros from the TMA, and k16 steps wholly past K are skipped (K = 96 is
//   one and a half k-tiles).
// - Persistent CTAs, one per SM, walk the output tiles (and dW's K
//   splits); the producer runs ahead into the next tile's k-tiles while the
//   consumers run the epilogue, so a product with two k-tiles per tile
//   (K = 96) still streams.
// - The epilogue is compiled per kind (bias, GELU, GELU keeping the
//   pre-activation, residual, residual with DropPath, dX's f32 / bf16 /
//   GELU-derivative outputs, dW's sums), so that its code is straight-line.
//   It works from the accumulator registers, with no staging of the f32
//   tile.  Its (M, N) input, the residual or the GELU pre-activation, is
//   prefetched by the producer into shared memory, two tiles deep (16-
//   column boxes in the 32-byte swizzle, read without bank conflicts).
//   A quad of threads transposes its packed bf16 pairs with two shuffle
//   rounds so that each thread stores 16 contiguous bytes; f32 results
//   (dX) leave as float2, and dW adds them with float2 atomics (its output
//   is a few hundred KB, summed over about two units a SM).  The order of
//   rounding is the plain version's (ops/gemm.py): bias added in f32, the
//   pre-activation rounded, exact-erf GELU on the f32 value, then the
//   DropPath multiplier and the residual, each rounded to bf16.
//
// The tensor maps are encoded on the host at every call (the activation
// pointers change), through cuTensorMapEncodeTiled looked up in the
// driver once, and passed as __grid_constant__ kernel parameters.
//
// Variants measured and dropped (tools/torch_attention_timing.py --kernels
// gemm, PERF.md): the epilogue's bf16 tile staged in shared memory and
// written by TMA stores (slower: a warpgroup barrier per tile, and a second
// pass for the pre-activation); runtime epilogue flags in one kernel per
// layout (branches per column pair: the stage-0 qkv product took 1.8x as
// long); erf as two polynomial pieces both evaluated (no faster than erff:
// the GELU epilogues are bound by instruction issue).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace kvq {

using bf16 = __nv_bfloat16;

constexpr int kGBM = 128;        // output rows per tile: two warpgroups of 64
constexpr int kGBK = 64;         // k per ring stage: 128 bytes of bf16
constexpr int kGThreads = 384;   // warpgroup 0 copies, 1-2 multiply
constexpr int kGRing = 220 * 1024;  // shared memory for the ring

// The epilogues, each compiled into a kernel of its own so that its code
// is straight-line (a runtime flag per column pair would cut it into basic
// blocks that the compiler cannot interleave).  dX's codes are the
// wrapper's (ops/gemm.py).
enum GemmEpilogue {
  kEpiF32 = 1,        // dX: f32 out = acc
  kEpiAtomicF32 = 2,  // dW: f32 out += acc (split-K partial sums)
  kEpiBf16 = 3,       // dX: bf16 out = acc
  kEpiGeluBwd = 4,    // dX: bf16 out = acc * GELU'(aux), aux the pre-activation
  kEpiBias = 5,       // forward: bf16 out = bf16(acc + bias)
  kEpiGelu = 6,       //          bf16 out = bf16(GELU(acc + bias))
  kEpiGeluPre = 7,    //          the same, and pre = bf16(acc + bias)
  kEpiRes = 8,        //          bf16 out = res + bf16(acc + bias)
  kEpiResDp = 9,      //          bf16 out = res + bf16(dp * bf16(acc + bias))
};

template <int EPI>
struct GemmEpi {
  static constexpr bool kAMN = EPI == kEpiAtomicF32;  // dW: A and B M/N-major
  static constexpr bool kBMN = kAMN || EPI == kEpiF32 || EPI == kEpiBf16 || EPI == kEpiGeluBwd;
  static constexpr bool kBias = !kBMN;
  static constexpr bool kGelu = EPI == kEpiGelu || EPI == kEpiGeluPre;
  static constexpr bool kPre = EPI == kEpiGeluPre;
  static constexpr bool kRes = EPI == kEpiRes || EPI == kEpiResDp;
  static constexpr bool kDp = EPI == kEpiResDp;
  static constexpr bool kIn = kRes || EPI == kEpiGeluBwd;  // reads an (M, N) input
  static constexpr bool kQuads = !kAMN && EPI != kEpiF32;  // bf16 out
};

struct GemmParams {
  const bf16* bias;   // (N,)                              forward
  const bf16* res;    // (M, N) residual                   kEpiRes, kEpiResDp
  const float* dp;    // per-row-group multiplier dp[m / dp_rows]  kEpiResDp
  int dp_rows;
  bf16* pre;          // (M, N) pre-activation out        kEpiGeluPre
  const bf16* aux;    // (M, N) GELU pre-activation        kEpiGeluBwd
  bf16* out;          // (M, N) bf16 result
  float* out_f32;     // (M, N) f32 result
  int M, N, K;
  int k_chunk;        // K rows per split (a multiple of kGBK)
  int m_tiles, n_tiles, units;
};

template <int BN, int EPI>
struct GemmShape {
  static constexpr bool kBMN = GemmEpi<EPI>::kBMN;
  static constexpr int kBChunks = (BN + 63) / 64;  // 64-wide boxes of an N-major B
  static constexpr int kABytes = kGBM * kGBK * 2;
  static constexpr int kBBytes = kBMN ? kBChunks * 64 * kGBK * 2 : BN * kGBK * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  // the epilogue's (M, N) input (residual or GELU pre-activation) of a
  // tile, two tiles deep: 16-column boxes of 64 rows, 32-byte swizzle
  static constexpr int kInBytes = GemmEpi<EPI>::kIn ? kGBM * BN * 2 : 0;
  static constexpr int kRing = kGRing - 2 * kInBytes;
  static constexpr int kStages = kRing / kStageBytes < 8 ? kRing / kStageBytes : 8;
  // 1024 bytes to align the ring to the swizzle's 1024-byte period
  static constexpr size_t kSmem =
      1024 + (size_t)kStages * kStageBytes + 2 * kInBytes + 16 * kStages + 32;
  static_assert(kStages >= 3, "ring");
  static_assert(BN % 16 == 0, "16-column boxes");
  static_assert(kBBytes % 1024 == 0 && kInBytes % 1024 == 0, "swizzle period");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Waits for the phase of parity `parity` to complete.  A wait that cannot
// end (a fault in the copies) traps rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  for (long long spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1LL << 26)) __trap();
  }
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// wgmma's shared-memory matrix descriptor, 128-byte swizzle: the start
// address, the leading and stride byte offsets (16-byte units).  K-major
// tiles: rows of 128 bytes, 8-row groups 1024 bytes apart (stride), the
// leading offset unused.  M/N-major tiles: 64-column boxes `lead` bytes
// apart, 8-k-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lead) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lead >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// Byte offset of the bf16 pair at (row r, column c) of a 64 x BN tile
// half in 16-column boxes (32-byte rows, 2 KB a box) in the TMA's 32-byte
// swizzle, whose XOR of the 16-byte half with bit 2 of the row spreads a
// warp's eight rows over all 32 banks.
__device__ __forceinline__ uint32_t boxed_offset(int r, int c) {
  const int b = (c & 15) * 2;
  return (c >> 4) * 2048 + r * 32 + ((((b >> 4) ^ (r >> 2)) & 1) << 4) + (b & 15);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// One m64nBNk16 product, d (+)= A B, both from shared memory.  TA / TB: the
// operand is M/N-major (wgmma's transpose bits).  acc = 0 overwrites d.
// The accumulator lists are written out: inline PTX takes no arrays.
template <int BN, int TA, int TB>
struct Wgmma;

template <int TA, int TB>
struct Wgmma<96, TA, TB> {
  __device__ static void mma(float (&d)[48], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, %48, %49, p, 1, 1, %51, %52;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct Wgmma<128, TA, TB> {
  __device__ static void mma(float (&d)[64], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct Wgmma<144, TA, TB> {
  __device__ static void mma(float (&d)[72], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %74, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71"
        "}, %72, %73, p, 1, 1, %75, %76;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71])
        : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct Wgmma<192, TA, TB> {
  __device__ static void mma(float (&d)[96], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, %96, %97, p, 1, 1, %99, %100;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  }
};

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

// d GELU(x) / dx = Phi(x) + x phi(x), exact erf
__device__ __forceinline__ float gelu_erf_grad(float x) {
  return 0.5f * (1.f + erff(x * 0.70710678118654752f)) +
         x * 0.39894228040143268f * __expf(-0.5f * x * x);
}

__device__ __forceinline__ float2 bf2_to_f2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

__device__ __forceinline__ uint32_t f2_to_bf2(float a, float b) {
  const __nv_bfloat162 y = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&y);
}



// The bf16 epilogues of one thread's accumulator pair, packed; the forward
// also gives its pre-activation in `pre`.
template <int EPI>
__device__ __forceinline__ uint32_t gemm_epi_bf16(float v0, float v1, float dpv, uint32_t bias,
                                                  uint32_t in, uint32_t& pre) {
  using E = GemmEpi<EPI>;
  if constexpr (EPI == kEpiGeluBwd) {
    const float2 h = bf2_to_f2(in);
    return f2_to_bf2(v0 * gelu_erf_grad(h.x), v1 * gelu_erf_grad(h.y));
  } else if constexpr (EPI == kEpiBf16) {
    return f2_to_bf2(v0, v1);
  } else {
    const float2 b = bf2_to_f2(bias);
    v0 += b.x;
    v1 += b.y;
    pre = f2_to_bf2(v0, v1);
    if constexpr (E::kGelu) {
      v0 = gelu_erf(v0);
      v1 = gelu_erf(v1);
    }
    uint32_t y = f2_to_bf2(v0, v1);
    if constexpr (E::kDp) {
      const float2 f = bf2_to_f2(y);
      y = f2_to_bf2(f.x * dpv, f.y * dpv);
    }
    if constexpr (E::kRes) {
      const float2 r = bf2_to_f2(in), f = bf2_to_f2(y);
      y = f2_to_bf2(r.x + f.x, r.y + f.y);
    }
    return y;
  }
}

// The epilogue of one thread's accumulator pair at (row, col), (row, col +
// 1), stored as it lies: dW's atomic sums, dX's f32 out, and the bf16
// epilogues of the column groups that the quad transpose does not take.
template <int EPI>
__device__ __forceinline__ void gemm_epi_pair(const GemmParams& p, long long o, float v0,
                                              float v1, float dpv, uint32_t bias, uint32_t in) {
  if constexpr (EPI == kEpiAtomicF32) {
    atomicAdd(reinterpret_cast<float2*>(p.out_f32 + o), make_float2(v0, v1));
  } else if constexpr (EPI == kEpiF32) {
    *reinterpret_cast<float2*>(p.out_f32 + o) = make_float2(v0, v1);
  } else {
    uint32_t pre;
    const uint32_t y = gemm_epi_bf16<EPI>(v0, v1, dpv, bias, in, pre);
    if constexpr (GemmEpi<EPI>::kPre) *reinterpret_cast<uint32_t*>(p.pre + o) = pre;
    *reinterpret_cast<uint32_t*>(p.out + o) = y;
  }
}

// 4 x 4 transpose of packed bf16 pairs within a quad (the four lanes of
// one accumulator row): on entry x[g] is this lane's pair (columns 8g +
// 2q, +1) of groups g = 0..3, q = lane % 4; on exit x[s] is pair s
// (columns 8q + 2s, +1) of group q, so that the lane holds the 16
// contiguous bytes of group q.  Every lane of the warp takes part.
__device__ __forceinline__ void quad_transpose(uint32_t (&x)[4], int q) {
  const bool b1 = q & 2, b0 = q & 1;
  uint32_t r0 = __shfl_xor_sync(0xffffffffu, b1 ? x[0] : x[2], 2);
  uint32_t r1 = __shfl_xor_sync(0xffffffffu, b1 ? x[1] : x[3], 2);
  const uint32_t c0 = b1 ? r0 : x[0], c1 = b1 ? r1 : x[1];
  const uint32_t c2 = b1 ? x[2] : r0, c3 = b1 ? x[3] : r1;
  r0 = __shfl_xor_sync(0xffffffffu, b0 ? c0 : c1, 1);
  r1 = __shfl_xor_sync(0xffffffffu, b0 ? c2 : c3, 1);
  x[0] = b0 ? r0 : c0;
  x[1] = b0 ? c1 : r0;
  x[2] = b0 ? r1 : c2;
  x[3] = b0 ? c3 : r1;
}

struct GemmUnit {
  int mb, nb, split;  // row tile, column tile, K range
};

// The work units in launch order: dW puts the row tiles of one column tile
// and K range side by side (they read the same B rows), the other layouts
// the column tiles of one row tile (they read the same A rows).
template <bool A_MN>
__device__ __forceinline__ GemmUnit gemm_unit(const GemmParams& p, int u) {
  if (A_MN) return {u % p.m_tiles, (u / p.m_tiles) % p.n_tiles, u / (p.m_tiles * p.n_tiles)};
  return {u / p.n_tiles, u % p.n_tiles, 0};
}

// out = epilogue(op(A) @ op(B)) over 128 x BN tiles.  The epilogue sets
// the layout: dW's A is stored (K, M) (A_MN), dX's and dW's B (K, N)
// (B_MN), the others with K innermost.
template <int BN, int EPI>
__global__ void __launch_bounds__(kGThreads, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
                const __grid_constant__ CUtensorMap tm_in, const GemmParams p) {
  using E = GemmEpi<EPI>;
  constexpr bool A_MN = E::kAMN, B_MN = E::kBMN;
  using S = GemmShape<BN, EPI>;
  extern __shared__ __align__(1024) unsigned char g_smem[];
  unsigned char* ring = g_smem + ((1024 - (smem_u32(g_smem) & 1023)) & 1023);
  unsigned char* inbuf = ring + S::kStages * S::kStageBytes;  // 2 x kInBytes
  uint64_t* full = reinterpret_cast<uint64_t*>(inbuf + 2 * S::kInBytes);
  uint64_t* empty = full + S::kStages;
  uint64_t* in_full = empty + S::kStages;  // [2]
  uint64_t* in_empty = in_full + 2;        // [2]
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);  // one arrival per consumer warp
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(in_full + s, 1);
      mbar_init(in_empty + s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // the producer: one thread issues every copy
    if (threadIdx.x != 0) return;
    int stage = 0, phase = 0;
    for (int u = blockIdx.x, n = 0; u < p.units; u += gridDim.x, ++n) {
      const GemmUnit t = gemm_unit<A_MN>(p, u);
      const int m0 = t.mb * kGBM, n0 = t.nb * BN;
      const int kbeg = t.split * p.k_chunk;
      const int kend = min(p.K, kbeg + p.k_chunk);
      if constexpr (E::kIn) {  // the tile's epilogue input, ahead of its k-tiles
        const int b = n & 1;
        mbar_wait(in_empty + b, ((n >> 1) & 1) ^ 1);
        mbar_expect_tx(in_full + b, S::kInBytes);
        unsigned char* dst = inbuf + b * S::kInBytes;
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int c = 0; c < BN / 16; ++c)
            tma_load_2d(dst + h * (S::kInBytes / 2) + c * 2048, &tm_in, n0 + 16 * c, m0 + 64 * h,
                        in_full + b);
      }
      for (int k0 = kbeg; k0 < kend; k0 += kGBK) {
        mbar_wait(empty + stage, phase ^ 1);
        unsigned char* sa = ring + stage * S::kStageBytes;
        unsigned char* sb = sa + S::kABytes;
        mbar_expect_tx(full + stage, S::kStageBytes);
        if (A_MN) {
          tma_load_2d(sa, &tm_a, m0, k0, full + stage);
          tma_load_2d(sa + 8192, &tm_a, m0 + 64, k0, full + stage);
        } else {
          tma_load_2d(sa, &tm_a, k0, m0, full + stage);
        }
        if (B_MN) {
#pragma unroll
          for (int c = 0; c < S::kBChunks; ++c)
            tma_load_2d(sb + c * 8192, &tm_b, n0 + 64 * c, k0, full + stage);
        } else {
          tma_load_2d(sb, &tm_b, k0, n0, full + stage);
        }
        if (++stage == S::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // the consumers: warpgroup 1 takes rows 0-63 of each tile, 2 rows 64-127
  const int cw = wg - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  // per k16 step: 32 bytes along a K-major row, 16 k rows of an M/N-major box
  constexpr uint32_t kStepA = A_MN ? 2048 : 32, kStepB = B_MN ? 2048 : 32;
  constexpr uint32_t kLeadA = A_MN ? 8192 : 16, kLeadB = B_MN ? 8192 : 16;
  int stage = 0, phase = 0;
  float acc[BN / 2];
  for (int u = blockIdx.x, n = 0; u < p.units; u += gridDim.x, ++n) {
    const GemmUnit t = gemm_unit<A_MN>(p, u);
    const int kbeg = t.split * p.k_chunk;
    const int kend = min(p.K, kbeg + p.k_chunk);
    int prev = -1;
    for (int k0 = kbeg; k0 < kend; k0 += kGBK) {
      mbar_wait(full + stage, phase);
      const uint32_t sa = smem_u32(ring + stage * S::kStageBytes) + cw * 8192;
      const uint32_t sb = smem_u32(ring + stage * S::kStageBytes + S::kABytes);
      const int steps = min(4, (kend - k0 + 15) / 16);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk < steps)
          Wgmma<BN, A_MN, B_MN>::mma(acc, gmma_desc(sa + kk * kStepA, kLeadA),
                                     gmma_desc(sb + kk * kStepB, kLeadB),
                                     k0 > kbeg || kk > 0);
      }
      wgmma_commit();
      if (prev >= 0) {  // the previous k-tile's products are done: free its slot
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(empty + prev);
      }
      prev = stage;
      if (++stage == S::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    if (lane == 0 && prev >= 0) mbar_arrive(empty + prev);

    // accumulator layout of m64nBN: d[4j + 2i + c] is row 16 warp + lane/4
    // + 8i, column 8j + 2 (lane % 4) + c.  The epilogue input (residual or
    // GELU pre-activation) comes from the tile the producer prefetched; the
    // bias pairs of kChunk column groups load together before their use.
    // bf16 results leave in 16-byte stores: a quad transposes four groups,
    // so that a warp's store writes whole 32-byte sectors.
    constexpr int kPairs = BN / 8, kChunk = 8;
    const int q = lane % 4;
    const int r_loc = warp * 16 + lane / 4;
    const int row0 = t.mb * kGBM + cw * 64 + r_loc;
    const int col0 = t.nb * BN + 2 * q;
    const unsigned char* in_tile = inbuf + (n & 1) * S::kInBytes + cw * (S::kInBytes / 2);
    if constexpr (E::kIn) mbar_wait(in_full + (n & 1), (n >> 1) & 1);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      const bool row_ok = row < p.M;
      const float dpv = E::kDp && row_ok ? p.dp[row / p.dp_rows] : 1.f;
      const long long o0 = (long long)row * p.N;
#pragma unroll
      for (int j0 = 0; j0 < kPairs; j0 += kChunk) {
        uint32_t bias[kChunk], in[kChunk];
#pragma unroll
        for (int jj = 0; jj < kChunk && j0 + jj < kPairs; ++jj) {
          const int c = 8 * (j0 + jj) + 2 * q;  // column within the tile
          bias[jj] = in[jj] = 0;
          if constexpr (E::kBias)
            if (col0 + 8 * (j0 + jj) < p.N)
              bias[jj] = *reinterpret_cast<const uint32_t*>(p.bias + col0 + 8 * (j0 + jj));
          if constexpr (E::kIn)
            in[jj] = *reinterpret_cast<const uint32_t*>(in_tile + boxed_offset(r_loc + 8 * i, c));
        }
#pragma unroll
        for (int g0 = 0; g0 < kChunk && j0 + g0 < kPairs; g0 += 4) {
          const int jb = j0 + g0;
          if (jb + 4 <= kPairs && E::kQuads) {
            uint32_t y[4], pre[4];
#pragma unroll
            for (int g = 0; g < 4; ++g)
              y[g] = gemm_epi_bf16<EPI>(acc[4 * (jb + g) + 2 * i], acc[4 * (jb + g) + 2 * i + 1],
                                        dpv, bias[g0 + g], in[g0 + g], pre[g]);
            quad_transpose(y, q);
            const int col = t.nb * BN + 8 * (jb + q);
            const bool ok = row_ok && col < p.N;
            if (ok) *reinterpret_cast<uint4*>(p.out + o0 + col) = make_uint4(y[0], y[1], y[2], y[3]);
            if constexpr (E::kPre) {
              quad_transpose(pre, q);
              if (ok)
                *reinterpret_cast<uint4*>(p.pre + o0 + col) =
                    make_uint4(pre[0], pre[1], pre[2], pre[3]);
            }
          } else {
#pragma unroll
            for (int g = 0; g < 4 && jb + g < kPairs; ++g) {
              const int j = jb + g, col = col0 + 8 * j;
              if (row_ok && col < p.N)
                gemm_epi_pair<EPI>(p, o0 + col, acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1], dpv,
                                   bias[g0 + g], in[g0 + g]);
            }
          }
        }
      }
    }
    if constexpr (E::kIn) {  // this warp is done with the input tile
      __syncwarp();
      if (lane == 0) mbar_arrive(in_empty + (n & 1));
    }
  }
}

// ---------------------------------------------------------------------------
// host side

typedef CUresult (*TensorMapEncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                         const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                         const cuuint32_t*, CUtensorMapInterleave,
                                         CUtensorMapSwizzle, CUtensorMapL2promotion,
                                         CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, looked up once (the libraries link
// only the runtime).
inline TensorMapEncodeTiled tensor_map_encoder() {
  static const TensorMapEncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib ? reinterpret_cast<TensorMapEncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// A map of a row-major (rows, cols) bf16 matrix read in boxes of
// box_rows x box_cols: the operands' 64-column boxes in the 128-byte
// swizzle, the epilogue input's 16-column boxes in the 32-byte one.  False
// if the driver refuses it (a base or row stride that is not a multiple of
// 16 bytes).
inline bool encode_map(CUtensorMap* map, const bf16* base, int rows, int cols, int box_rows,
                       int box_cols = kGBK,
                       CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (!encode) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(base), dims, strides,
                box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline int sm_count() {
  static const int n = [] {
    int dev = 0, v = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v;
  }();
  return n;
}

// A: (M, K) row-major, or (K, M) for dW; B: (N, K) row-major, or (K, N)
// for dX and dW.  p's M, N, K, k_chunk and epilogue fields are set.
template <int BN, int EPI>
cudaError_t launch_gemm_bn(const bf16* a, const bf16* b, GemmParams p, cudaStream_t stream) {
  using E = GemmEpi<EPI>;
  constexpr bool A_MN = E::kAMN, B_MN = E::kBMN;
  using S = GemmShape<BN, EPI>;
  CUtensorMap ma, mb, mi;
  bool ok = (A_MN ? encode_map(&ma, a, p.K, p.M, 64) : encode_map(&ma, a, p.M, p.K, kGBM)) &&
            (B_MN ? encode_map(&mb, b, p.K, p.N, 64) : encode_map(&mb, b, p.N, p.K, BN));
  mi = ma;  // unused without an epilogue input
  if (E::kIn)
    ok = ok && encode_map(&mi, EPI == kEpiGeluBwd ? p.aux : p.res, p.M, p.N, 64, 16,
                          CU_TENSOR_MAP_SWIZZLE_32B);
  if (!ok) return cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_kernel<BN, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::kSmem);
  if (attr != cudaSuccess) return attr;
  p.m_tiles = (p.M + kGBM - 1) / kGBM;
  p.n_tiles = (p.N + BN - 1) / BN;
  p.units = p.m_tiles * p.n_tiles * ((p.K + p.k_chunk - 1) / p.k_chunk);
  const int grid = p.units < sm_count() ? p.units : sm_count();
  gemm_kernel<BN, EPI><<<grid, kGThreads, S::kSmem, stream>>>(ma, mb, mi, p);
  return cudaGetLastError();
}

template <int EPI>
cudaError_t launch_gemm_epi(const bf16* a, const bf16* b, const GemmParams& p, int bn,
                            cudaStream_t stream) {
  switch (bn) {
    case 96: return launch_gemm_bn<96, EPI>(a, b, p, stream);
    case 128: return launch_gemm_bn<128, EPI>(a, b, p, stream);
    case 144: return launch_gemm_bn<144, EPI>(a, b, p, stream);
    case 192: return launch_gemm_bn<192, EPI>(a, b, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

// Launches the product with epilogue `epi` (GemmEpilogue) for a runtime
// tile width bn (ops/gemm.py: WIDTHS).
inline cudaError_t launch_gemm(const bf16* a, const bf16* b, const GemmParams& p, int epi, int bn,
                               cudaStream_t stream) {
  if (p.M <= 0 || p.N <= 0 || p.K <= 0 || p.N % 8 || p.k_chunk <= 0 || p.k_chunk % kGBK)
    return cudaErrorInvalidValue;
  switch (epi) {
    case kEpiF32: return launch_gemm_epi<kEpiF32>(a, b, p, bn, stream);
    case kEpiAtomicF32: return launch_gemm_epi<kEpiAtomicF32>(a, b, p, bn, stream);
    case kEpiBf16: return launch_gemm_epi<kEpiBf16>(a, b, p, bn, stream);
    case kEpiGeluBwd: return launch_gemm_epi<kEpiGeluBwd>(a, b, p, bn, stream);
    case kEpiBias: return launch_gemm_epi<kEpiBias>(a, b, p, bn, stream);
    case kEpiGelu: return launch_gemm_epi<kEpiGelu>(a, b, p, bn, stream);
    case kEpiGeluPre: return launch_gemm_epi<kEpiGeluPre>(a, b, p, bn, stream);
    case kEpiRes: return launch_gemm_epi<kEpiRes>(a, b, p, bn, stream);
    case kEpiResDp: return launch_gemm_epi<kEpiResDp>(a, b, p, bn, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace kvq

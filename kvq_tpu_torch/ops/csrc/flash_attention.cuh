// Flash-style multi-head attention forward for Hopper (sm_90a), bf16 in /
// bf16 out, f32 softmax statistics.  One body serves every forward
// attention of the port, each layout read through the per-tensor strides of
// AttnParams:
//
//   WINDOW = true   Swin window attention over partitioned, rolled tokens
//                   (padded to whole windows), with the bias
//                   rel * gate + frag * (1 - gate) and the -100 seam mask,
//                   both rebuilt here from token coordinates: the attention
//                   core of K1 and K4's forward, K3 on the qkv product, K5's
//                   forward and K6 on head-major q, k, v;
//   WINDOW = false  batched attention with no bias or mask: K2 with heads
//                   split along the channel axis, K7 on head-major tensors.
//
// Replaces the Pallas kernels _make_block_kernel (attention part),
// _make_kernel (K3, K6), _make_nobias_cl_kernel (K2), _make_nobias_kernel
// (K7) and, with the row log-sum-exp written out, _make_train_fwd_kernel
// (K5's forward) of kvq_tpu/ops/window_attention.py.
//
// Bound on this card: the larger of the bytes (q, k, v and out once, the
// f32 bias planes once) over 3.35 TB/s and the two products' 4 * hd FLOPs
// per score over 989 TFLOP/s; at the Swin shapes (hd = 32) that is the
// bytes, 0.066 ms for a stage-0 call of swin_tiny_grpb.  The body runs at
// ~13x that: per score it reads 8 bytes of bias planes, runs the gate, the
// blend, the seam test and an exp on the CUDA cores, and each 64-key tile
// ends in a barrier, so the time goes to latency that too few warps cover
// (128 registers a thread hold an SM to 16 warps).  The design:
//
// - Four warps own 64 query rows of one (window, head); a warp owns 16.
//   Products run on mma.sync m16n8k16 (bf16 in, f32 accumulate), K fed by
//   ldmatrix and V by ldmatrix.trans.  A warp's 16 x 64 score tile stays in
//   registers as eight n8 accumulators (32 floats a thread, two rows); the
//   row max and sum take two quad shuffles; the accumulators, rounded to
//   bf16, are the A operand of the PV product; O accumulates and is
//   rescaled in registers.  q is read once, straight into its A fragments.
// - K, V and the bias tiles stream through a two-stage cp.async ring: tile
//   t + 1 loads while tile t computes, one barrier per tile.  Each token's
//   packed ids (fragment ids, seam segment) are computed once per CTA into
//   shared memory, so the key loop does no integer division.
// - The bias planes are the same for every window, so a CTA serves two
//   windows (eight warps) and stages each 64 x 64 f32 rel (and frag) tile
//   once for both: half the L2 reads of one window per CTA.  The tile rows
//   are unpadded, their 16-byte chunks XOR-swizzled by row, so that a CTA
//   takes 110 KB and two fit on an SM.  Measured on an H100 at K3's stage-0
//   shape (tools/torch_attention_timing.py, PERF.md): each thread's bias
//   prefetched into registers a tile ahead, one window per CTA, 166
//   registers and 27 KB, 3 CTAs of 4 warps per SM: 0.99 ms; bias tiles in
//   the ring, one window per CTA, 101 KB, 2 per SM: 1.11 ms; shared by four
//   windows, 183 KB, 1 CTA of 16 warps per SM: 0.89-0.93 ms; shared by two
//   windows, 2 CTAs of 8 warps per SM, whose barriers interleave: 0.84 ms.
// - Warps whose 16 rows all lie past n_q (the ragged last query tile: at
//   N = 392, three of the last tile's four) and the warps of an empty
//   window slot skip the math and only share the copies and barriers.
// - wgmma and TMA are not used: at hd = 32 a warp's products are 32
//   mma.sync per key tile and the tensor cores are idle most of the time.
//   A warpgroup-wide product, TMA-fed tiles and warp specialisation (a
//   producer warp for the copies, so that no barrier stalls the math) are
//   a later step.
//
// Rounding order (matches the TPU kernels): q is scaled in f32 and rounded
// to bf16, scores and exp are f32, p is rounded to bf16 for the PV product,
// the row sum is taken over the f32 p, and the division by it comes after
// PV.  Keys past n_kv score -inf.
//
// The backward (train_attention.cu) rebuilds the forward's scores from the
// helpers here (token_meta, window_score, bias_off, copy_tile, the
// fragment helpers) by the same method.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace kvq {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;    // query rows per CTA
constexpr int kBKV = 64;   // keys per streamed tile
constexpr int kWarps = 4;  // each warp owns 16 query rows
constexpr int kThreads = kWarps * 32;

struct AttnParams {
  const bf16* q;  // element (b, h, row, d) at b*sq + h*hq + row*ldq + d
  const bf16* k;
  const bf16* v;
  bf16* out;
  long long ldq, ldk, ldv, ldo;   // row strides, elements
  long long sq, sk, sv, so;       // batch strides, elements
  long long hq, hk, hv, ho;       // head strides, elements
  int n_q, n_kv;                  // rows of q / of k and v per batch entry
  int heads;
  float scale;
  float* lse;  // (batch, heads, n_q) row log-sum-exp, or nullptr
  // WINDOW only: bias planes (heads, N, N) f32 and the window geometry
  const float* rel;
  const float* frag;  // nullptr when the stage has no fragment bias
  int dims[3], win[3], shift[3], frags[3];
};

// WINDOW only: the padded token volume, effective window and shift, and
// fragment grid of the windows (token_meta derives the window grid from
// dims / win, so dims must be the padded volume).
inline void set_geometry(AttnParams& p, const int* dims, const int* win,
                         const int* shift, const int* frags) {
  for (int a = 0; a < 3; ++a) {
    p.dims[a] = dims[a];
    p.win[a] = win[a];
    p.shift[a] = shift[a];
    p.frags[a] = frags[a];
  }
}

// Per-token packed ids: fragment id of the pre-roll coordinate on each axis
// (8 bits each) and the combined seam segment (segd*9 + segh*3 + segw).
__device__ __forceinline__ int token_meta(const AttnParams& p, int window,
                                          int tok) {
  const int Dw = p.dims[0] / p.win[0];
  const int Hw = p.dims[1] / p.win[1];
  const int Ww = p.dims[2] / p.win[2];
  const int w_idx = window % Ww;
  const int h_idx = (window / Ww) % Hw;
  const int d_idx = (window / (Ww * Hw)) % Dw;
  const int off[3] = {tok / (p.win[1] * p.win[2]), (tok / p.win[2]) % p.win[1],
                      tok % p.win[2]};
  const int idx[3] = {d_idx, h_idx, w_idx};
  int packed = 0, seg = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int dim = p.dims[a], w = p.win[a], s = p.shift[a];
    const int g = idx[a] * w + off[a];                 // rolled coordinate
    const int fid = ((g + s) % dim) * p.frags[a] / dim;  // pre-roll fragment
    const int sg = g < dim - w ? 0 : (g < dim - s ? 1 : 2);
    packed |= fid << (24 - 8 * a);
    seg = seg * 3 + sg;
  }
  return packed | seg;
}

// The fragment gate of two tokens: the summed |difference| of their three
// fragment ids (one byte each; the seam byte masked off).
__device__ __forceinline__ float frag_gate(int a, int b) {
  return static_cast<float>(__vsadu4(static_cast<unsigned>(a) & ~0xffu,
                                     static_cast<unsigned>(b) & ~0xffu));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The score rule of every window attention, forward and backward: score s
// plus the bias, rel * gate + frag * (1 - gate) (rel alone without a
// fragment bias), minus 100 across a shifted-window seam.  gate: the summed
// |difference| of the two tokens' fragment ids (a small integer).
__device__ __forceinline__ float window_score(float s, float rel, float frag,
                                              bool has_frag, float gate,
                                              bool seam) {
  float bias = rel;
  if (has_frag) bias = bias * gate + frag * (1.f - gate);
  s += bias;
  if (seam) s -= 100.f;
  return s;
}

// ---------------------------------------------------------------------------
// Register-fragment helpers: asynchronous copies, ldmatrix, mma.sync.

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; zero-fills when !full.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0));
}

// 4-byte asynchronous copy global -> shared; zero-fills when !full.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(full ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 and receives, of each matrix, row l / 4, elements 2 (l % 4) + {0, 1}
// (TRANS: column l / 4, rows 2 (l % 4) + {0, 1}).
template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  if (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

// d += a b on a 16x8x16 tile: a the row-major 16x16 bf16 A fragment, (b0,
// b1) the column-major 16x8 B fragment, d the f32 16x8 accumulator (lane l
// holds rows l / 4 and l / 4 + 8, columns 2 (l % 4) + {0, 1}).
__device__ __forceinline__ void mma_16816(float (&d)[4], const unsigned (&a)[4],
                                          unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// ---------------------------------------------------------------------------
// The forward body.

// Windows one CTA serves: WINDOW shares each bias tile staged in the ring
// between the CTA's two windows, since the planes are the same for every
// window.
template <bool WINDOW>
__host__ __device__ constexpr int fwd_windows() {
  return WINDOW ? 2 : 1;
}

// Float offset of element (r, c) of a staged 64 x 64 f32 bias tile: rows of
// 64 floats whose 16-byte chunks are XOR-swizzled by row, so that the float2
// reads of a half-warp (four rows, eight columns each) hit distinct banks.
__device__ __forceinline__ int bias_off(int r, int c) {
  return r * kBKV + ((((c >> 2) ^ ((r & 3) << 1))) << 2) + (c & 3);
}

// One ring stage: K and V of each window and the rel (and frag) tiles of
// the CTA's 64 query rows.
template <int HD, bool WINDOW, bool FRAG>
__host__ __device__ constexpr size_t fwd_stage_bytes() {
  return sizeof(bf16) * fwd_windows<WINDOW>() * 2 * kBKV * (HD + 8) +
         (WINDOW ? sizeof(float) * (FRAG ? 2 : 1) * kBQ * kBKV : 0);
}

// Shared memory of one CTA: two ring stages and each window's token ids
// (WINDOW).
template <int HD, bool WINDOW, bool FRAG>
size_t fwd_smem_bytes(int n_kv) {
  constexpr int kWin = fwd_windows<WINDOW>();
  const int n_tiles = (n_kv + kBKV - 1) / kBKV;
  return 2 * fwd_stage_bytes<HD, WINDOW, FRAG>() +
         (WINDOW ? sizeof(int) * kWin * n_tiles * kBKV : 0);
}

// Copies rows [r0, r0 + 64) x [0, HD) of one head into shared memory (row
// stride HD + 8), zero past n, by the 128 threads of one window (ltid).
template <int HD>
__device__ __forceinline__ void cp_async_rows(bf16* dst, const bf16* src,
                                              long long ld, int r0, int n,
                                              int ltid) {
  constexpr int kRowChunks = HD / 8;
  for (int c = ltid; c < kBKV * kRowChunks; c += kThreads) {
    const int r = c / kRowChunks, col = (c % kRowChunks) * 8;
    const bool ok = r0 + r < n;
    cp_async16(dst + r * (HD + 8) + col,
               src + (ok ? (long long)(r0 + r) * ld + col : 0), ok);
  }
}

// Starts the copies of key tile [k0, k0 + 64) into a ring stage: this
// window's K and V rows (zero past n_kv, or for an empty window slot) and,
// WINDOW, by all the CTA's threads, the 64 x 64 tiles of the bias planes at
// query rows q0.. (zero past n_q / n_kv).
template <int HD, bool WINDOW, bool FRAG>
__device__ __forceinline__ void copy_tile(unsigned char* stage, const AttnParams& p,
                                           const bf16* kb, const bf16* vb, bool valid,
                                           int slot, int ltid, int head, int q0,
                                           int k0) {
  constexpr int kLd = HD + 8;
  constexpr int kWin = fwd_windows<WINDOW>();
  bf16* sK = reinterpret_cast<bf16*>(stage) + slot * 2 * kBKV * kLd;
  const int n = valid ? p.n_kv : 0;
  cp_async_rows<HD>(sK, kb, p.ldk, k0, n, ltid);
  cp_async_rows<HD>(sK + kBKV * kLd, vb, p.ldv, k0, n, ltid);
  if (WINDOW) {
    float* sRel = reinterpret_cast<float*>(reinterpret_cast<bf16*>(stage) +
                                           kWin * 2 * kBKV * kLd);
    float* sFrag = sRel + kBQ * kBKV;
    const long long base = (long long)head * p.n_q * p.n_kv;
    if (p.n_kv % 4 == 0) {  // 16-byte chunks stay aligned and whole
      for (int c = threadIdx.x; c < kBQ * kBKV / 4; c += kThreads * kWin) {
        const int r = c / (kBKV / 4), col = (c % (kBKV / 4)) * 4;
        const bool ok = q0 + r < p.n_q && k0 + col < p.n_kv;
        const long long off = ok ? base + (long long)(q0 + r) * p.n_kv + k0 + col : 0;
        cp_async16(sRel + bias_off(r, col), p.rel + off, ok);
        if (FRAG) cp_async16(sFrag + bias_off(r, col), p.frag + off, ok);
      }
    } else {
      for (int c = threadIdx.x; c < kBQ * kBKV; c += kThreads * kWin) {
        const int r = c / kBKV, col = c % kBKV;
        const bool ok = q0 + r < p.n_q && k0 + col < p.n_kv;
        const long long off = ok ? base + (long long)(q0 + r) * p.n_kv + k0 + col : 0;
        cp_async4(sRel + bias_off(r, col), p.rel + off, ok);
        if (FRAG) cp_async4(sFrag + bias_off(r, col), p.frag + off, ok);
      }
    }
  }
}

// A bf16 pair times s in f32, rounded back to bf16 (the q scaling).
__device__ __forceinline__ unsigned scale_bf16x2(unsigned x, float s) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
  return pack_bf16(f.x * s, f.y * s);
}

// One CTA: 64 query rows of one head for fwd_windows windows (n_batch
// windows in all); 128 threads, four warps of 16 rows, per window.
template <int HD, bool WINDOW, bool FRAG>
__global__ void __launch_bounds__(kThreads * fwd_windows<WINDOW>(),
                                  WINDOW && HD == 32 ? 2 : 1)
flash_attention_kernel(const AttnParams p, int n_batch) {
  static_assert(HD == 32 || HD == 64, "head dim");
  static_assert(WINDOW || !FRAG, "fragment bias without a window");
  constexpr int kWin = fwd_windows<WINDOW>();
  constexpr int kLd = HD + 8;     // bf16 q/k/v row stride in shared memory
  constexpr int kN8 = kBKV / 8;   // n8 accumulators of a score row
  constexpr int kD8 = HD / 8;     // n8 accumulators of an output row
  constexpr size_t kStage = fwd_stage_bytes<HD, WINDOW, FRAG>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int n_tiles = (p.n_kv + kBKV - 1) / kBKV;
  const int slot = threadIdx.x / kThreads;  // this thread's window of the CTA
  const int ltid = threadIdx.x % kThreads;
  const int warp = ltid / 32;               // its 16 rows of the window's 64
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;    // accumulator row / column group
  const int q0 = blockIdx.x * kBQ;
  const int head = blockIdx.y;
  const int batch = blockIdx.z * kWin + slot;
  const bool valid = batch < n_batch;
  const int b = valid ? batch : 0;          // addresses of an empty slot
  const int row0 = q0 + warp * 16 + g;      // this thread's rows: row0, row0 + 8
  const bool active = valid && q0 + warp * 16 < p.n_q;  // warp-uniform
  unsigned char* ring = smem_raw;
  int* sId = reinterpret_cast<int*>(ring + 2 * kStage) + slot * n_tiles * kBKV;

  const bf16* kb = p.k + b * p.sk + head * p.hk;
  const bf16* vb = p.v + b * p.sv + head * p.hv;
  copy_tile<HD, WINDOW, FRAG>(ring, p, kb, vb, valid, slot, ltid, head, q0, 0);
  cp_async_commit();
  int qid[2];    // the packed ids of this thread's two query rows
  bool brow[2];  // rows that take the bias
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    brow[r] = WINDOW && active && row0 + 8 * r < p.n_q;
    qid[r] = brow[r] ? token_meta(p, b, row0 + 8 * r) : 0;
  }
  if (WINDOW) {
    for (int i = ltid; i < n_tiles * kBKV; i += kThreads)
      sId[i] = valid && i < p.n_kv ? token_meta(p, b, i) : 0;
  }
  // this warp's 16 q rows, scaled in f32 and rounded to bf16, as the A
  // fragments of the HD / 16 k steps, read from device memory in their
  // register layout (rows row0 / row0 + 8, columns 2 t + {0, 1, 8, 9})
  unsigned qf[HD / 16][4];
  const bf16* qb = p.q + b * p.sq + head * p.hq;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + 8 * (i & 1);
      qf[kk][i] = active && row < p.n_q
          ? scale_bf16x2(*reinterpret_cast<const unsigned*>(
                             qb + (long long)row * p.ldq + 16 * kk + 2 * t + 8 * (i >> 1)),
                         p.scale)
          : 0u;
    }
  cp_async_wait<0>();
  __syncthreads();  // key tile 0, ids

  float o[kD8][4];
#pragma unroll
  for (int d = 0; d < kD8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's part of the row sums

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kBKV;
    if (it > 0) {
      cp_async_wait<0>();
      // tile it has landed for every thread, and every warp is done with
      // tile it - 1, whose stage tile it + 1 takes
      __syncthreads();
    }
    if (it + 1 < n_tiles) {
      copy_tile<HD, WINDOW, FRAG>(ring + ((it + 1) & 1) * kStage, p, kb, vb, valid,
                                   slot, ltid, head, q0, k0 + kBKV);
      cp_async_commit();
    }
    if (!active) continue;
    const bf16* stage = reinterpret_cast<const bf16*>(ring + (it & 1) * kStage);
    const bf16* sK = stage + slot * 2 * kBKV * kLd;
    const bf16* sV = sK + kBKV * kLd;

    // S = Q K^T: 16 rows x 64 keys in eight n8 accumulators
    float s[kN8][4];
#pragma unroll
    for (int j = 0; j < kN8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int h = 0; h < HD / 32; ++h) {
        unsigned kf[4];  // keys 8j.., dims 32h + 8 (lane / 8)..
        ldsm_x4<false>(kf, sK + (8 * j + (lane & 7)) * kLd + 32 * h + (lane >> 3) * 8);
        mma_16816(s[j], qf[2 * h], kf[0], kf[1]);
        mma_16816(s[j], qf[2 * h + 1], kf[2], kf[3]);
      }
    }

    if (WINDOW) {  // the score rule on the staged bias tiles
      const float* sRel = reinterpret_cast<const float*>(stage + kWin * 2 * kBKV * kLd);
      const float* sFrag = sRel + kBQ * kBKV;
#pragma unroll
      for (int j = 0; j < kN8; ++j) {
        const int2 kid = *reinterpret_cast<const int2*>(sId + k0 + 8 * j + 2 * t);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (!brow[r]) continue;
          const int br = bias_off(warp * 16 + g + 8 * r, 8 * j + 2 * t);
          const float2 rv = *reinterpret_cast<const float2*>(sRel + br);
          const float2 fv = FRAG ? *reinterpret_cast<const float2*>(sFrag + br)
                                 : make_float2(0.f, 0.f);
          s[j][2 * r] = window_score(s[j][2 * r], rv.x, fv.x, FRAG,
                                     FRAG ? frag_gate(qid[r], kid.x) : 0.f,
                                     (qid[r] & 0xff) != (kid.x & 0xff));
          s[j][2 * r + 1] = window_score(s[j][2 * r + 1], rv.y, fv.y, FRAG,
                                         FRAG ? frag_gate(qid[r], kid.y) : 0.f,
                                         (qid[r] & 0xff) != (kid.y & 0xff));
        }
      }
    }
    if (k0 + kBKV > p.n_kv) {  // ragged key tail
#pragma unroll
      for (int j = 0; j < kN8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 8 * j + 2 * t + (e & 1) >= p.n_kv) s[j][e] = -INFINITY;
    }

    // online softmax of rows g (e = 0, 1) and g + 8 (e = 2, 3)
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < kN8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    // p = exp(s - m) as __expf(s - m), the exp of the backward's rebuild,
    // so that the probabilities it rebuilds from the lse are this pass's
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = __expf(m_run[r] - mx[r]);
      m_run[r] = mx[r];
    }
    // p, rounded to bf16, as the A fragments of the four k16 steps of PV
    unsigned pf[kN8 / 2][4];
#pragma unroll
    for (int j = 0; j < kN8; ++j) {
      const float p0 = __expf(s[j][0] - m_run[0]);
      const float p1 = __expf(s[j][1] - m_run[0]);
      const float p2 = __expf(s[j][2] - m_run[1]);
      const float p3 = __expf(s[j][3] - m_run[1]);
      sum[0] += p0 + p1;
      sum[1] += p2 + p3;
      pf[j / 2][(j & 1) * 2] = pack_bf16(p0, p1);
      pf[j / 2][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * corr[r] + sum[r];
#pragma unroll
    for (int d = 0; d < kD8; ++d) {
      o[d][0] *= corr[0];
      o[d][1] *= corr[0];
      o[d][2] *= corr[1];
      o[d][3] *= corr[1];
    }

    // O += P V
#pragma unroll
    for (int kk = 0; kk < kBKV / 16; ++kk)
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        unsigned vf[4];  // keys 16kk.., dims 16dp + 8 (lane / 16)..
        ldsm_x4<true>(vf, sV + (16 * kk + ((lane >> 3) & 1) * 8 + (lane & 7)) * kLd +
                              16 * dp + (lane >> 4) * 8);
        mma_16816(o[2 * dp], pf[kk], vf[0], vf[1]);
        mma_16816(o[2 * dp + 1], pf[kk], vf[2], vf[3]);
      }
  }

  if (!active) return;
  // out = O / l in bf16, and the row log-sum-exp
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    const int row = row0 + 8 * r;
    if (row >= p.n_q) continue;
    const float inv = 1.f / l_run[r];
    bf16* dst = p.out + b * p.so + (long long)row * p.ldo + head * p.ho + 2 * t;
#pragma unroll
    for (int d = 0; d < kD8; ++d)
      *reinterpret_cast<unsigned*>(dst + 8 * d) =
          pack_bf16(o[d][2 * r] * inv, o[d][2 * r + 1] * inv);
    if (p.lse && t == 0)
      p.lse[((long long)b * p.heads + head) * p.n_q + row] = m_run[r] + logf(l_run[r]);
  }
}

template <int HD, bool WINDOW, bool FRAG>
cudaError_t launch_fwd(const AttnParams& p, int batch, cudaStream_t stream) {
  constexpr int kWin = fwd_windows<WINDOW>();
  const size_t smem = fwd_smem_bytes<HD, WINDOW, FRAG>(p.n_kv);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<HD, WINDOW, FRAG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.n_q + kBQ - 1) / kBQ, p.heads, (batch + kWin - 1) / kWin);
  flash_attention_kernel<HD, WINDOW, FRAG><<<grid, kThreads * kWin, smem, stream>>>(p, batch);
  return cudaGetLastError();
}

template <int HD, bool WINDOW>
cudaError_t launch_fwd_hd(const AttnParams& p, int batch, cudaStream_t stream) {
  return WINDOW && p.frag ? launch_fwd<HD, WINDOW, WINDOW>(p, batch, stream)
                          : launch_fwd<HD, WINDOW, false>(p, batch, stream);
}

// Launches the forward for a runtime head dim; returns the launch error.
template <bool WINDOW>
cudaError_t launch_flash_attention(const AttnParams& p, int head_dim,
                                   int batch, cudaStream_t stream) {
  if (head_dim == 32) return launch_fwd_hd<32, WINDOW>(p, batch, stream);
  if (head_dim == 64) return launch_fwd_hd<64, WINDOW>(p, batch, stream);
  return cudaErrorInvalidValue;
}

}  // namespace kvq

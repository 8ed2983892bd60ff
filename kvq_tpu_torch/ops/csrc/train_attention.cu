// K5 (window_attention_train) and the attention backward shared by K4 and
// K5 (replace _train_attention_fwd_impl / _train_attention_bwd_impl and the
// attention part of _make_block_train_bwd_kernel in
// kvq_tpu/ops/window_attention.py).
//
// Forward: the WINDOW template of flash_attention.cuh on head-major
// (BW, h, N, hd) q, k, v, which also writes each row's log-sum-exp so that
// the backward rebuilds the probabilities without recomputing row maxima.
//
// Backward (flash style, nothing (N, N) reaches device memory): with
// p = exp(s - lse) rebuilt from the same scores as the forward (window_score
// on staged bias tiles and the coordinate-rebuilt token ids) and
// D = rowsum(dout * out), ds = p * (dout @ v^T - D), then
//   dq = scale * ds @ k,   dk = ds^T @ (scale * q),   dv = p^T @ dout,
//   drel += ds * gate,     dfrag += ds * (1 - gate)   (f32, over windows).
// Three passes share the score rebuild, so that no output needs atomics
// except the bias planes: one CTA per (query tile, head, two windows) sums
// dq over the key tiles; one per (key tile, head, two windows) sums dk and
// dv over the query tiles; one per (query tile, key tile, head, window
// chunk) sums ds * gate over its chunk of windows in registers and adds it
// to the planes once (f32 atomics, a few chunks per entry).
//
// Bound on this card: the bytes (q, k, v, out, dout, dq, dk, dv once, the
// bias planes and their gradients once; 0.020 ms per stage-3 call of the
// KSVQE train step) over the operations (five hd-deep products per score,
// 2.5x the forward's).  The passes run at 15-25x it: each rebuilds the
// scores (the exp, gate, blend and seam test on the CUDA cores), and the
// DQ and DK/DV passes copy the bias tiles of every key (query) tile for
// each pair of windows, 32 of the 48 KB a CTA copies per tile.  Measured
// on an H100 at train stage 0 (tools/torch_attention_timing.py, PERF.md):
// a conflict-free swizzle for the DK/DV pass's column-wise bias reads
// gained nothing over bias_off; the bias pass at 2, 3 and 4 CTAs an SM took
// 1.18, 0.92 and 1.31 ms.
//
// Design, the forward body's method (flash_attention.cuh) in each pass:
// - Products on mma.sync m16n8k16 fed by ldmatrix; the scores and dP of a
//   warp's 16 x 16 chunk stay in accumulator registers (rows g and g + 8,
//   columns 2t + {0, 1}), become p and ds there, and are packed to bf16 A
//   fragments for the next product, as the forward packs P.  Working one
//   16-wide chunk at a time (no row max is needed: p = exp(s - lse)) keeps
//   a thread's live scores at 16 floats.
// - DQ pass: a warp owns 16 query rows; its scaled q and dout A fragments
//   are read once from device memory.  K, V and the bias tiles stream
//   through the forward's own two-stage cp.async ring (copy_tile): one
//   barrier per key tile, two windows a CTA sharing each staged bias tile.
//   dq += ds k takes K through ldmatrix.trans; dq is scaled in f32 at the
//   store.
// - DK/DV pass: a warp owns 16 keys and computes the transposed tiles,
//   s^T = k (scale q)^T and dP^T = v dout^T, so that p^T and ds^T leave
//   the accumulators already as A operands of dv += p^T dout and
//   dk += ds^T (scale q): no shared-memory p / ds tile and no barrier
//   between the warps.  The k and v A fragments are read once; q, dout,
//   their lse and D (indexed by column) and the bias tiles stream through
//   a two-stage ring.  The bias is read down its columns, one float per
//   lane, from the tiles as the forward stages them (bias_off): a swizzle
//   that made those reads free of bank conflicts measured no faster.
// - Bias pass: the (query tile, key tile) of a CTA is fixed, so its rel
//   and frag tiles are staged once per CTA, not once per window; each
//   window's q, dout, k, v tiles, lse, D and token ids stream through a
//   two-stage ring, window b + 1's copies in flight while window b
//   computes; the ds * gate and ds * (1 - gate) sums stay in registers.
// - Each token's packed ids are computed once per CTA (once per window in
//   the bias pass).  Warps with no row (the ragged last tile: at N = 392,
//   three of its four) skip the math but keep the copies and barriers;
//   p is zero past n_q and n_kv.
//
// Rounding (the plain version's and the TPU kernel's): q is scaled in f32
// and rounded to bf16; scores, p = __expf(s - lse), dP and ds are f32; p
// is rounded to bf16 for dv and ds for dq and dk; the bias sums are f32.
//
// Plain C interface for ctypes (kvq_tpu_torch/ops/build.py); every entry
// returns the CUDA error of its launches.
#include "flash_attention.cuh"

namespace kvq {

enum BwdPass { kPassDQ = 0, kPassDKDV = 1, kPassBias = 2 };

// Windows a CTA of the DQ and DK/DV passes serves, sharing each staged
// bias tile: the forward's ring layout, whose copy_tile feeds the DQ pass.
constexpr int kBwdWin = fwd_windows<true>();

struct AttnBwdParams {
  AttnParams a;        // q, k, v, strides, geometry, bias planes, scale
  const bf16* o;       // forward output, a's out strides (ldo, so, ho)
  const bf16* dout;    // its gradient, same layout
  const float* lse;    // (batch, heads, n) row log-sum-exp of the forward
  float* dsum;         // (batch, heads, n) rowsum(dout * out), scratch
  bf16* dq;            // layouts of q, k, v
  bf16* dk;
  bf16* dv;
  float* drel;         // (heads, n, n) f32, accumulated
  float* dfrag;        // same, or nullptr without a fragment bias
  int batch;           // windows
  int win_chunk;       // windows per CTA in the bias pass
};

// D[b, h, row] = sum_d dout * out, one thread per row.
__global__ void __launch_bounds__(256)
attn_dsum_kernel(const bf16* o, const bf16* dout, long long ldo, long long so,
                 long long ho, float* dsum, int batch, int heads, int n, int hd) {
  const long long i = blockIdx.x * 256LL + threadIdx.x;
  if (i >= (long long)batch * heads * n) return;
  const int row = (int)(i % n);
  const long long bh = i / n;
  const int h = (int)(bh % heads);
  const long long b = bh / heads;
  const long long off = b * so + h * ho + row * ldo;
  float acc = 0.f;
  for (int d = 0; d < hd; d += 8) {
    const uint4 ov = *reinterpret_cast<const uint4*>(o + off + d);
    const uint4 gv = *reinterpret_cast<const uint4*>(dout + off + d);
    const bf16* oe = reinterpret_cast<const bf16*>(&ov);
    const bf16* ge = reinterpret_cast<const bf16*>(&gv);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc += __bfloat162float(oe[e]) * __bfloat162float(ge[e]);
  }
  dsum[i] = acc;
}

// ---------------------------------------------------------------------------
// Copies and fragments.

// Starts the copies of the 64 x 64 tiles of the bias planes at query rows
// q0.., keys k0.. (zero past n_q / n_kv) by nthr threads, laid out by
// bias_off.
template <bool FRAG>
__device__ __forceinline__ void cp_async_bias(float* sRel, const AttnParams& p,
                                              int head, int q0, int k0, int tid,
                                              int nthr) {
  float* sFrag = sRel + kBQ * kBKV;
  const long long base = (long long)head * p.n_q * p.n_kv;
  if (p.n_kv % 4 == 0) {  // 16-byte chunks stay aligned and whole
    for (int c = tid; c < kBQ * kBKV / 4; c += nthr) {
      const int r = c / (kBKV / 4), col = (c % (kBKV / 4)) * 4;
      const bool ok = q0 + r < p.n_q && k0 + col < p.n_kv;
      const long long off = ok ? base + (long long)(q0 + r) * p.n_kv + k0 + col : 0;
      const int o = bias_off(r, col);
      cp_async16(sRel + o, p.rel + off, ok);
      if (FRAG) cp_async16(sFrag + o, p.frag + off, ok);
    }
  } else {
    for (int c = tid; c < kBQ * kBKV; c += nthr) {
      const int r = c / kBKV, col = c % kBKV;
      const bool ok = q0 + r < p.n_q && k0 + col < p.n_kv;
      const long long off = ok ? base + (long long)(q0 + r) * p.n_kv + k0 + col : 0;
      const int o = bias_off(r, col);
      cp_async4(sRel + o, p.rel + off, ok);
      if (FRAG) cp_async4(sFrag + o, p.frag + off, ok);
    }
  }
}

// Starts the copy of element i of 64 f32 of a per-row statistic (lse or D)
// from row r0, zero past n.
__device__ __forceinline__ void cp_async_stat(float* dst, const float* src, int r0,
                                              int n, int i) {
  const bool ok = r0 + i < n;
  cp_async4(dst + i, src + (ok ? r0 + i : 0), ok);
}

// A fragments of 16 rows of one head read from device memory in their
// register layout (this thread's rows row0 and row0 + 8, columns
// 2t + {0, 1, 8, 9} of each k16 step), zero past n or when !active;
// SCALE: times s in f32, rounded back to bf16 (the q scaling).
template <int HD, bool SCALE>
__device__ __forceinline__ void load_a_frags(unsigned (&f)[HD / 16][4], const bf16* src,
                                             long long ld, int row0, int n, bool active,
                                             int t, float s) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + 8 * (i & 1);
      const unsigned x = active && row < n
          ? *reinterpret_cast<const unsigned*>(src + (long long)row * ld + 16 * kk +
                                               2 * t + 8 * (i >> 1))
          : 0u;
      f[kk][i] = SCALE ? scale_bf16x2(x, s) : x;
    }
}

// A fragments of rows r0 .. r0 + 15 of a staged tile (row stride HD + 8).
template <int HD, bool SCALE>
__device__ __forceinline__ void ldsm_a_frags(unsigned (&f)[HD / 16][4], const bf16* tile,
                                             int r0, int lane, float s) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    ldsm_x4<false>(f[kk], tile + (r0 + (lane & 15)) * (HD + 8) + 16 * kk + (lane >> 4) * 8);
    if (SCALE) {
#pragma unroll
      for (int i = 0; i < 4; ++i) f[kk][i] = scale_bf16x2(f[kk][i], s);
    }
  }
}

// acc = a x^T for rows 16c .. 16c + 15 of a staged tile x (the scores
// against 16 keys, or dP against 16 rows of v): two n8 accumulators, the
// tile's rows as column-major B operands through ldmatrix.  SCALE scales x
// (the streamed q of the DK/DV pass).
template <int HD, bool SCALE>
__device__ __forceinline__ void mma_abt(float (&acc)[2][4], const unsigned (&a)[HD / 16][4],
                                        const bf16* tile, int c, int lane, float s) {
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    acc[jj][0] = acc[jj][1] = acc[jj][2] = acc[jj][3] = 0.f;
#pragma unroll
    for (int h = 0; h < HD / 32; ++h) {
      unsigned b[4];  // rows 16c + 8jj.., columns 32h + 8 (lane / 8)..
      ldsm_x4<false>(b, tile + (16 * c + 8 * jj + (lane & 7)) * (HD + 8) + 32 * h +
                            (lane >> 3) * 8);
      if (SCALE) {
#pragma unroll
        for (int i = 0; i < 4; ++i) b[i] = scale_bf16x2(b[i], s);
      }
      mma_16816(acc[jj], a[2 * h], b[0], b[1]);
      mma_16816(acc[jj], a[2 * h + 1], b[2], b[3]);
    }
  }
}

// acc += a x for the 16 x 16 A fragment a over rows 16c .. 16c + 15 of a
// staged tile x (dq += ds k, dv += p^T dout, dk += ds^T (scale q)): the
// rows as row-major B operands through ldmatrix.trans.
template <int HD, bool SCALE>
__device__ __forceinline__ void mma_ab(float (&acc)[HD / 8][4], const unsigned (&a)[4],
                                       const bf16* tile, int c, int lane, float s) {
#pragma unroll
  for (int dp = 0; dp < HD / 16; ++dp) {
    unsigned b[4];  // rows 16c.., columns 16dp + 8 (lane / 16)..
    ldsm_x4<true>(b, tile + (16 * c + ((lane >> 3) & 1) * 8 + (lane & 7)) * (HD + 8) +
                         16 * dp + (lane >> 4) * 8);
    if (SCALE) {
#pragma unroll
      for (int i = 0; i < 4; ++i) b[i] = scale_bf16x2(b[i], s);
    }
    mma_16816(acc[2 * dp], a, b[0], b[1]);
    mma_16816(acc[2 * dp + 1], a, b[2], b[3]);
  }
}

// Stores a 16 x HD accumulator (this thread's rows row0, row0 + 8) times
// mul as bf16 rows of one head; rows past n are skipped.
template <int HD>
__device__ __forceinline__ void store_acc(bf16* dst, long long ld, const float (&acc)[HD / 8][4],
                                          int row0, int n, bool active, int t, float mul) {
  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= n) continue;
    bf16* d = dst + (long long)row * ld + 2 * t;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i)
      *reinterpret_cast<unsigned*>(d + 8 * i) =
          pack_bf16(acc[i][2 * r] * mul, acc[i][2 * r + 1] * mul);
  }
}

// ---------------------------------------------------------------------------
// The three passes.

// DQ: 64 query rows of one head for kBwdWin windows; per window four warps
// of 16 rows.  The ring is the forward's: K, V of each window and the bias
// tiles at (q0, k0), staged by copy_tile.
template <int HD, bool FRAG>
__device__ __forceinline__ void bwd_dq(const AttnBwdParams& P, unsigned char* smem) {
  constexpr int kLd = HD + 8;
  constexpr size_t kStage = fwd_stage_bytes<HD, true, FRAG>();
  const AttnParams& p = P.a;
  const int n_tiles = (p.n_kv + kBKV - 1) / kBKV;
  const int slot = threadIdx.x / kThreads, ltid = threadIdx.x % kThreads;
  const int warp = ltid / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kBQ, head = blockIdx.y;
  const int batch = blockIdx.z * kBwdWin + slot;
  const bool valid = batch < P.batch;
  const int b = valid ? batch : 0;           // addresses of an empty slot
  const int row0 = q0 + warp * 16 + g;       // this thread's rows: row0, row0 + 8
  const bool active = valid && q0 + warp * 16 < p.n_q;  // warp-uniform
  int* sId = reinterpret_cast<int*>(smem + 2 * kStage) + slot * n_tiles * kBKV;

  const bf16* kb = p.k + b * p.sk + head * p.hk;
  const bf16* vb = p.v + b * p.sv + head * p.hv;
  copy_tile<HD, true, FRAG>(smem, p, kb, vb, valid, slot, ltid, head, q0, 0);
  cp_async_commit();
  for (int i = ltid; i < n_tiles * kBKV; i += kThreads)
    sId[i] = valid && i < p.n_kv ? token_meta(p, b, i) : 0;
  unsigned qf[HD / 16][4], df[HD / 16][4];  // scaled q and dout, A fragments
  load_a_frags<HD, true>(qf, p.q + b * p.sq + head * p.hq, p.ldq, row0, p.n_q, active, t,
                         p.scale);
  load_a_frags<HD, false>(df, P.dout + b * p.so + head * p.ho, p.ldo, row0, p.n_q, active,
                          t, 0.f);
  float lse[2], dsum[2];
  bool rok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    rok[r] = active && row < p.n_q;
    const long long i = ((long long)b * p.heads + head) * p.n_q + row;
    lse[r] = rok[r] ? P.lse[i] : 0.f;
    dsum[r] = rok[r] ? P.dsum[i] : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();  // key tile 0, ids
  int qid[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) qid[r] = rok[r] ? sId[row0 + 8 * r] : 0;

  float acc[HD / 8][4] = {};
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kBKV;
    if (it > 0) {
      cp_async_wait<0>();
      __syncthreads();  // tile it landed; every warp is done with tile it - 1
    }
    if (it + 1 < n_tiles) {
      copy_tile<HD, true, FRAG>(smem + ((it + 1) & 1) * kStage, p, kb, vb, valid, slot, ltid,
                                head, q0, k0 + kBKV);
      cp_async_commit();
    }
    if (!active) continue;
    const bf16* stage = reinterpret_cast<const bf16*>(smem + (it & 1) * kStage);
    const bf16* sK = stage + slot * 2 * kBKV * kLd;
    const bf16* sV = sK + kBKV * kLd;
    const float* sRel = reinterpret_cast<const float*>(stage + kBwdWin * 2 * kBKV * kLd);
    const float* sFrag = sRel + kBQ * kBKV;
#pragma unroll
    for (int c = 0; c < kBKV / 16; ++c) {  // 16 keys at a time
      float s[2][4], dp[2][4];
      mma_abt<HD, false>(s, qf, sK, c, lane, 0.f);
      mma_abt<HD, false>(dp, df, sV, c, lane, 0.f);
      unsigned a[4];  // ds, the A fragment of dq += ds k
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int col = 16 * c + 8 * jj + 2 * t;  // this thread's keys col, col + 1
        const int2 kid = *reinterpret_cast<const int2*>(sId + k0 + col);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int br = bias_off(warp * 16 + g + 8 * r, col);
          const float2 rv = *reinterpret_cast<const float2*>(sRel + br);
          const float2 fv = FRAG ? *reinterpret_cast<const float2*>(sFrag + br)
                                 : make_float2(0.f, 0.f);
          float ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int ki = e ? kid.y : kid.x;
            const float sc = window_score(s[jj][2 * r + e], e ? rv.y : rv.x,
                                          e ? fv.y : fv.x, FRAG,
                                          FRAG ? frag_gate(qid[r], ki) : 0.f,
                                          (qid[r] & 0xff) != (ki & 0xff));
            const float pe = rok[r] && k0 + col + e < p.n_kv ? __expf(sc - lse[r]) : 0.f;
            ds[e] = pe * (dp[jj][2 * r + e] - dsum[r]);
          }
          a[2 * jj + r] = pack_bf16(ds[0], ds[1]);
        }
      }
      mma_ab<HD, false>(acc, a, sK, c, lane, 0.f);
    }
  }
  store_acc<HD>(P.dq + b * p.sq + head * p.hq, p.ldq, acc, row0, p.n_q, active, t, p.scale);
}

// One DK/DV ring stage: q and dout rows of each window, their lse and D,
// and the bias tiles at (q0, k0) in the column-read layout.
template <int HD, bool FRAG>
__host__ __device__ constexpr size_t dkdv_stage_bytes() {
  return sizeof(bf16) * kBwdWin * 2 * kBQ * (HD + 8) + sizeof(float) * kBwdWin * 2 * kBQ +
         sizeof(float) * (FRAG ? 2 : 1) * kBQ * kBKV;
}

// Starts the copies of query tile [q0, q0 + 64) of window slot `slot` into
// a DK/DV ring stage (zero past n_q, or for an empty slot) and, by all the
// CTA's threads, the bias tiles at (q0, k0).
template <int HD, bool FRAG>
__device__ __forceinline__ void copy_query_tile(unsigned char* stage, const AttnBwdParams& P,
                                                const bf16* qb, const bf16* ob,
                                                const float* lseb, const float* db,
                                                bool valid, int slot, int ltid, int head,
                                                int q0, int k0) {
  constexpr int kLd = HD + 8;
  const AttnParams& p = P.a;
  bf16* sQ = reinterpret_cast<bf16*>(stage) + slot * 2 * kBQ * kLd;
  float* stats = reinterpret_cast<float*>(reinterpret_cast<bf16*>(stage) +
                                          kBwdWin * 2 * kBQ * kLd);
  const int n = valid ? p.n_q : 0;
  cp_async_rows<HD>(sQ, qb, p.ldq, q0, n, ltid);
  cp_async_rows<HD>(sQ + kBQ * kLd, ob, p.ldo, q0, n, ltid);
  // lse by threads 0..63, D by 64..127
  cp_async_stat(stats + slot * 2 * kBQ + ltid / kBQ * kBQ, ltid < kBQ ? lseb : db, q0, n,
                ltid % kBQ);
  cp_async_bias<FRAG>(stats + kBwdWin * 2 * kBQ, p, head, q0, k0, threadIdx.x,
                            kThreads * kBwdWin);
}

// DK/DV: 64 keys of one head for kBwdWin windows; per window four warps of
// 16 keys, each computing the transposed tiles s^T and dP^T.
template <int HD, bool FRAG>
__device__ __forceinline__ void bwd_dkdv(const AttnBwdParams& P, unsigned char* smem) {
  constexpr int kLd = HD + 8;
  constexpr size_t kStage = dkdv_stage_bytes<HD, FRAG>();
  const AttnParams& p = P.a;
  const int n_tiles = (p.n_q + kBQ - 1) / kBQ;
  const int slot = threadIdx.x / kThreads, ltid = threadIdx.x % kThreads;
  const int warp = ltid / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kBKV, head = blockIdx.y;
  const int batch = blockIdx.z * kBwdWin + slot;
  const bool valid = batch < P.batch;
  const int b = valid ? batch : 0;
  const int key0 = k0 + warp * 16 + g;  // this thread's keys: key0, key0 + 8
  const bool active = valid && k0 + warp * 16 < p.n_kv;
  int* sId = reinterpret_cast<int*>(smem + 2 * kStage) + slot * n_tiles * kBQ;

  const bf16* qb = p.q + b * p.sq + head * p.hq;
  const bf16* ob = P.dout + b * p.so + head * p.ho;
  const long long sb = ((long long)b * p.heads + head) * p.n_q;
  copy_query_tile<HD, FRAG>(smem, P, qb, ob, P.lse + sb, P.dsum + sb, valid, slot, ltid,
                            head, 0, k0);
  cp_async_commit();
  for (int i = ltid; i < n_tiles * kBQ; i += kThreads)
    sId[i] = valid && i < p.n_q ? token_meta(p, b, i) : 0;
  unsigned kf[HD / 16][4], vf[HD / 16][4];  // k and v, A fragments
  load_a_frags<HD, false>(kf, p.k + b * p.sk + head * p.hk, p.ldk, key0, p.n_kv, active, t,
                          0.f);
  load_a_frags<HD, false>(vf, p.v + b * p.sv + head * p.hv, p.ldv, key0, p.n_kv, active, t,
                          0.f);
  cp_async_wait<0>();
  __syncthreads();  // query tile 0, ids
  bool kok[2];
  int kid[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    kok[r] = active && key0 + 8 * r < p.n_kv;
    kid[r] = kok[r] ? sId[key0 + 8 * r] : 0;
  }

  float dk[HD / 8][4] = {}, dv[HD / 8][4] = {};
  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = it * kBQ;
    if (it > 0) {
      cp_async_wait<0>();
      __syncthreads();
    }
    if (it + 1 < n_tiles) {
      copy_query_tile<HD, FRAG>(smem + ((it + 1) & 1) * kStage, P, qb, ob, P.lse + sb,
                                P.dsum + sb, valid, slot, ltid, head, q0 + kBQ, k0);
      cp_async_commit();
    }
    if (!active) continue;
    const bf16* stage = reinterpret_cast<const bf16*>(smem + (it & 1) * kStage);
    const bf16* sQ = stage + slot * 2 * kBQ * kLd;
    const bf16* sdO = sQ + kBQ * kLd;
    const float* stats = reinterpret_cast<const float*>(stage + kBwdWin * 2 * kBQ * kLd);
    const float* sLse = stats + slot * 2 * kBQ;
    const float* sD = sLse + kBQ;
    const float* sRel = stats + kBwdWin * 2 * kBQ;
    const float* sFrag = sRel + kBQ * kBKV;
#pragma unroll
    for (int c = 0; c < kBQ / 16; ++c) {  // 16 queries at a time
      float st[2][4], dpt[2][4];
      mma_abt<HD, true>(st, kf, sQ, c, lane, p.scale);
      mma_abt<HD, false>(dpt, vf, sdO, c, lane, 0.f);
      unsigned pa[4], da[4];  // p^T and ds^T, A fragments
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int col = 16 * c + 8 * jj + 2 * t;  // this thread's queries col, col + 1
        const float2 l2 = *reinterpret_cast<const float2*>(sLse + col);
        const float2 d2 = *reinterpret_cast<const float2*>(sD + col);
        const int2 qid = *reinterpret_cast<const int2*>(sId + q0 + col);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float pe[2], ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qi = e ? qid.y : qid.x;
            const int o = bias_off(col + e, warp * 16 + g + 8 * r);
            const float sc = window_score(st[jj][2 * r + e], sRel[o], FRAG ? sFrag[o] : 0.f,
                                          FRAG, FRAG ? frag_gate(kid[r], qi) : 0.f,
                                          (kid[r] & 0xff) != (qi & 0xff));
            pe[e] = kok[r] && q0 + col + e < p.n_q ? __expf(sc - (e ? l2.y : l2.x)) : 0.f;
            ds[e] = pe[e] * (dpt[jj][2 * r + e] - (e ? d2.y : d2.x));
          }
          pa[2 * jj + r] = pack_bf16(pe[0], pe[1]);
          da[2 * jj + r] = pack_bf16(ds[0], ds[1]);
        }
      }
      mma_ab<HD, false>(dv, pa, sdO, c, lane, 0.f);
      mma_ab<HD, true>(dk, da, sQ, c, lane, p.scale);
    }
  }
  store_acc<HD>(P.dk + b * p.sk + head * p.hk, p.ldk, dk, key0, p.n_kv, active, t, 1.f);
  store_acc<HD>(P.dv + b * p.sv + head * p.hv, p.ldv, dv, key0, p.n_kv, active, t, 1.f);
}

// One bias-pass ring stage: a window's q, dout, k and v tiles, the lse and
// D of its query rows, and the token ids of its query and key tiles.
template <int HD>
__host__ __device__ constexpr size_t bias_stage_bytes() {
  return sizeof(bf16) * 4 * kBQ * (HD + 8) + sizeof(float) * 2 * kBQ + sizeof(int) * 2 * kBQ;
}

// Starts the copies of window b's tiles at (q0, k0) into a bias-pass ring
// stage and writes its token ids (plain stores, read after the next
// barrier); 128 threads.
template <int HD>
__device__ __forceinline__ void copy_window(unsigned char* stage, const AttnBwdParams& P,
                                            int b, int head, int q0, int k0) {
  constexpr int kLd = HD + 8;
  const AttnParams& p = P.a;
  const int tid = threadIdx.x;
  bf16* sQ = reinterpret_cast<bf16*>(stage);
  cp_async_rows<HD>(sQ, p.q + b * p.sq + head * p.hq, p.ldq, q0, p.n_q, tid);
  cp_async_rows<HD>(sQ + kBQ * kLd, P.dout + b * p.so + head * p.ho, p.ldo, q0, p.n_q, tid);
  cp_async_rows<HD>(sQ + 2 * kBQ * kLd, p.k + b * p.sk + head * p.hk, p.ldk, k0, p.n_kv, tid);
  cp_async_rows<HD>(sQ + 3 * kBQ * kLd, p.v + b * p.sv + head * p.hv, p.ldv, k0, p.n_kv, tid);
  float* stats = reinterpret_cast<float*>(sQ + 4 * kBQ * kLd);  // lse, then D
  const long long sb = ((long long)b * p.heads + head) * p.n_q;
  cp_async_stat(stats + tid / kBQ * kBQ, (tid < kBQ ? P.lse : P.dsum) + sb, q0, p.n_q,
                tid % kBQ);
  // query ids by threads 0..63, key ids by 64..127
  const int i = tid % kBQ, r0 = tid < kBQ ? q0 : k0, n = tid < kBQ ? p.n_q : p.n_kv;
  reinterpret_cast<int*>(stats + 2 * kBQ)[tid] = r0 + i < n ? token_meta(p, b, r0 + i) : 0;
}

// Bias: the 64 x 64 (query tile, key tile) of one head over a chunk of
// windows; four warps of 16 query rows.
template <int HD, bool FRAG>
__device__ __forceinline__ void bwd_bias(const AttnBwdParams& P, unsigned char* smem) {
  constexpr int kLd = HD + 8;
  constexpr int kN8 = kBKV / 8;
  constexpr size_t kStage = bias_stage_bytes<HD>();
  const AttnParams& p = P.a;
  const int ntile = (p.n_q + kBQ - 1) / kBQ;
  const int q0 = (blockIdx.x / ntile) * kBQ, k0 = (blockIdx.x % ntile) * kBKV;
  const int head = blockIdx.y;
  const int b0 = blockIdx.z * P.win_chunk, b1 = min(P.batch, b0 + P.win_chunk);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int lrow = warp * 16 + g;  // this thread's tile rows: lrow, lrow + 8
  const bool active = q0 + warp * 16 < p.n_q;
  float* sRel = reinterpret_cast<float*>(smem);  // the CTA's bias tiles, staged once
  const float* sFrag = sRel + kBQ * kBKV;
  unsigned char* ring = smem + sizeof(float) * (FRAG ? 2 : 1) * kBQ * kBKV;
  cp_async_bias<FRAG>(sRel, p, head, q0, k0, threadIdx.x, kThreads);
  copy_window<HD>(ring, P, b0, head, q0, k0);
  cp_async_commit();
  bool rok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) rok[r] = q0 + lrow + 8 * r < p.n_q;

  float arel[kN8][4] = {}, afrag[kN8][4] = {};  // sums over the windows
  for (int b = b0; b < b1; ++b) {
    const int it = b - b0;
    cp_async_wait<0>();
    __syncthreads();  // window b landed; every warp is done with window b - 1
    if (b + 1 < b1) {
      copy_window<HD>(ring + ((it + 1) & 1) * kStage, P, b + 1, head, q0, k0);
      cp_async_commit();
    }
    if (!active) continue;
    const bf16* sQ = reinterpret_cast<const bf16*>(ring + (it & 1) * kStage);
    const bf16* sdO = sQ + kBQ * kLd;
    const bf16* sK = sQ + 2 * kBQ * kLd;
    const bf16* sV = sQ + 3 * kBQ * kLd;
    const float* sLse = reinterpret_cast<const float*>(sQ + 4 * kBQ * kLd);
    const float* sD = sLse + kBQ;
    const int* sQid = reinterpret_cast<const int*>(sD + kBQ);
    const int* sKid = sQid + kBQ;
    unsigned qa[HD / 16][4], da[HD / 16][4];  // scaled q and dout, A fragments
    ldsm_a_frags<HD, true>(qa, sQ, warp * 16, lane, p.scale);
    ldsm_a_frags<HD, false>(da, sdO, warp * 16, lane, 0.f);
    float lse[2], dsum[2];
    int qid[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lse[r] = sLse[lrow + 8 * r];
      dsum[r] = sD[lrow + 8 * r];
      qid[r] = sQid[lrow + 8 * r];
    }
#pragma unroll
    for (int c = 0; c < kBKV / 16; ++c) {
      float s[2][4], dp[2][4];
      mma_abt<HD, false>(s, qa, sK, c, lane, 0.f);
      mma_abt<HD, false>(dp, da, sV, c, lane, 0.f);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * c + jj, col = 8 * j + 2 * t;
        const int2 kid = *reinterpret_cast<const int2*>(sKid + col);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int br = bias_off(lrow + 8 * r, col);
          const float2 rv = *reinterpret_cast<const float2*>(sRel + br);
          const float2 fv = FRAG ? *reinterpret_cast<const float2*>(sFrag + br)
                                 : make_float2(0.f, 0.f);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int ki = e ? kid.y : kid.x;
            const float gate = FRAG ? frag_gate(qid[r], ki) : 0.f;
            const float sc = window_score(s[jj][2 * r + e], e ? rv.y : rv.x,
                                          e ? fv.y : fv.x, FRAG, gate,
                                          (qid[r] & 0xff) != (ki & 0xff));
            const float pe = rok[r] && k0 + col + e < p.n_kv ? __expf(sc - lse[r]) : 0.f;
            const float ds = pe * (dp[jj][2 * r + e] - dsum[r]);
            if (FRAG) {
              arel[j][2 * r + e] += ds * gate;
              afrag[j][2 * r + e] += ds * (1.f - gate);
            } else {
              arel[j][2 * r + e] += ds;
            }
          }
        }
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!rok[r]) continue;
    const long long base = ((long long)head * p.n_q + q0 + lrow + 8 * r) * p.n_kv;
#pragma unroll
    for (int j = 0; j < kN8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = k0 + 8 * j + 2 * t + e;
        if (c >= p.n_kv) continue;
        atomicAdd(P.drel + base + c, arel[j][2 * r + e]);
        if (FRAG) atomicAdd(P.dfrag + base + c, afrag[j][2 * r + e]);
      }
  }
}

template <int PASS>
__host__ __device__ constexpr int bwd_threads() {
  return PASS == kPassBias ? kThreads : kThreads * kBwdWin;
}

// Shared memory of one CTA of a pass at n tokens a window.
template <int HD, int PASS, bool FRAG>
size_t bwd_smem_bytes(int n) {
  const size_t ids = sizeof(int) * kBwdWin * ((n + kBQ - 1) / kBQ) * kBQ;
  if (PASS == kPassDQ) return fwd_smem_bytes<HD, true, FRAG>(n);
  if (PASS == kPassDKDV) return 2 * dkdv_stage_bytes<HD, FRAG>() + ids;
  return sizeof(float) * (FRAG ? 2 : 1) * kBQ * kBKV + 2 * bias_stage_bytes<HD>();
}

// One template for the three passes, so that a profile names each by its
// PASS argument.  DQ and DK/DV take ~110 KB (two CTAs of eight warps per
// SM), the bias pass 74 KB (three of four warps).
template <int HD, int PASS, bool FRAG>
__global__ void __launch_bounds__(bwd_threads<PASS>(), PASS == kPassBias ? 3 : 2)
attention_bwd_kernel(const AttnBwdParams P) {
  static_assert(HD % 32 == 0, "head dim");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  if constexpr (PASS == kPassDQ)
    bwd_dq<HD, FRAG>(P, smem_raw);
  else if constexpr (PASS == kPassDKDV)
    bwd_dkdv<HD, FRAG>(P, smem_raw);
  else
    bwd_bias<HD, FRAG>(P, smem_raw);
}

// The card's SM count and opt-in shared memory per block, read once.
struct DeviceLimits {
  int sms = 132;
  int smem_optin = 232448;
};

inline const DeviceLimits& device_limits() {
  static const DeviceLimits lim = [] {
    DeviceLimits l;
    int dev = 0;
    if (cudaGetDevice(&dev) == cudaSuccess) {
      cudaDeviceGetAttribute(&l.sms, cudaDevAttrMultiProcessorCount, dev);
      cudaDeviceGetAttribute(&l.smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    }
    return l;
  }();
  return lim;
}

template <int HD, int PASS, bool FRAG>
cudaError_t launch_bwd_pass(const AttnBwdParams& P, dim3 grid, cudaStream_t stream) {
  // once per instantiation: allow the card's whole opt-in shared memory
  static const cudaError_t attr = cudaFuncSetAttribute(
      attention_bwd_kernel<HD, PASS, FRAG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      device_limits().smem_optin);
  if (attr != cudaSuccess) return attr;
  attention_bwd_kernel<HD, PASS, FRAG><<<grid, bwd_threads<PASS>(),
                                         bwd_smem_bytes<HD, PASS, FRAG>(P.a.n_q), stream>>>(P);
  return cudaGetLastError();
}

template <int HD, bool FRAG>
cudaError_t launch_attention_bwd(AttnBwdParams& P, cudaStream_t stream) {
  const int n = P.a.n_q, heads = P.a.heads;
  const int ntile = (n + kBQ - 1) / kBQ;
  const long long rows = (long long)P.batch * heads * n;
  attn_dsum_kernel<<<(unsigned)((rows + 255) / 256), 256, 0, stream>>>(
      P.o, P.dout, P.a.ldo, P.a.so, P.a.ho, P.dsum, P.batch, heads, n, HD);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(ntile, heads, (P.batch + kBwdWin - 1) / kBwdWin);
  if ((err = launch_bwd_pass<HD, kPassDQ, FRAG>(P, grid, stream)) != cudaSuccess) return err;
  if ((err = launch_bwd_pass<HD, kPassDKDV, FRAG>(P, grid, stream)) != cudaSuccess) return err;
  // about eight CTAs per SM's worth of work in the bias pass
  const int tiles = ntile * ntile * heads;
  int chunks = (device_limits().sms * 8 + tiles - 1) / tiles;
  chunks = chunks < 1 ? 1 : (chunks > P.batch ? P.batch : chunks);
  P.win_chunk = (P.batch + chunks - 1) / chunks;
  chunks = (P.batch + P.win_chunk - 1) / P.win_chunk;
  return launch_bwd_pass<HD, kPassBias, FRAG>(P, dim3(ntile * ntile, heads, chunks), stream);
}

// Strides of the two layouts: head-major (BW, h, N, hd) tensors (K5), or
// K4's packed rows, q/k/v as column blocks of (BW*N, 3C) and out/dout as
// (BW*N, C) with heads along the channels.
void set_layout(AttnParams& p, int packed, int N, int heads, int hd) {
  const long long C = (long long)heads * hd;
  if (packed) {
    p.ldq = p.ldk = p.ldv = 3 * C;
    p.sq = p.sk = p.sv = 3 * C * N;
    p.ldo = C;
    p.so = C * N;
    p.hq = p.hk = p.hv = p.ho = hd;
  } else {
    p.ldq = p.ldk = p.ldv = p.ldo = hd;
    p.sq = p.sk = p.sv = p.so = C * N;
    p.hq = p.hk = p.hv = p.ho = (long long)N * hd;
  }
}

}  // namespace kvq

using kvq::bf16;

// K5 forward: q, k, v, out (BW, heads, N, hd) bf16; rel/frag (heads, N, N)
// f32 (frag may be null); lse (BW, heads, N) f32.
extern "C" int kvq_window_attention_train(
    const bf16* q, const bf16* k, const bf16* v, const float* rel,
    const float* frag, bf16* out, float* lse, int BW, int N, int heads, int hd,
    const int* dims, const int* win, const int* shift, const int* frags,
    float scale, cudaStream_t stream) {
  kvq::AttnParams p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  kvq::set_layout(p, 0, N, heads, hd);
  p.n_q = p.n_kv = N;
  p.heads = heads;
  p.scale = scale;
  p.lse = lse;
  p.rel = rel;
  p.frag = frag;
  kvq::set_geometry(p, dims, win, shift, frags);
  return (int)kvq::launch_flash_attention<true>(p, hd, BW, stream);
}

// Attention backward of K4 (packed = 1: q = qkv, out/dout (BW*N, C), dq =
// dqkv in qkv's layout) and K5 (packed = 0: head-major).  lse from the
// forward; dsum: (BW, heads, N) f32 scratch; drel/dfrag (heads, N, N) f32,
// zeroed by the caller (dfrag null without a fragment bias).
extern "C" int kvq_window_attention_bwd(
    const bf16* q, const bf16* k, const bf16* v, const bf16* out,
    const bf16* dout, const float* lse, float* dsum, bf16* dq, bf16* dk,
    bf16* dv, float* drel, float* dfrag, const float* rel, const float* frag,
    int BW, int N, int heads, int hd, int packed, const int* dims,
    const int* win, const int* shift, const int* frags, float scale,
    cudaStream_t stream) {
  kvq::AttnBwdParams P{};
  kvq::AttnParams& p = P.a;
  p.q = q;
  p.k = k;
  p.v = v;
  kvq::set_layout(p, packed, N, heads, hd);
  p.n_q = p.n_kv = N;
  p.heads = heads;
  p.scale = scale;
  p.rel = rel;
  p.frag = frag;
  kvq::set_geometry(p, dims, win, shift, frags);
  P.o = out;
  P.dout = dout;
  P.lse = lse;
  P.dsum = dsum;
  P.dq = dq;
  P.dk = dk;
  P.dv = dv;
  P.drel = drel;
  P.dfrag = dfrag;
  P.batch = BW;
  // every train stage of Swin-T has head_dim 32
  if (hd != 32) return (int)cudaErrorInvalidValue;
  return (int)(frag ? kvq::launch_attention_bwd<32, true>(P, stream)
                    : kvq::launch_attention_bwd<32, false>(P, stream));
}

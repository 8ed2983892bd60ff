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
// p = exp(s - lse) rebuilt from the same scores as the forward (the
// coordinate-rebuilt gate and seam mask of flash_attention.cuh) and
// D = rowsum(dout * out), ds = p * (dout @ v^T - D), then
//   dq = scale * ds @ k,   dk = ds^T @ (scale * q),   dv = p^T @ dout,
//   drel += ds * gate,     dfrag += ds * (1 - gate)   (f32, over windows).
// Three passes share the score rebuild, so that no output needs atomics
// except the bias planes: one CTA per (query tile, head, window) sums dq
// over the key tiles; one per (key tile, head, window) sums dk and dv over
// the query tiles; one per (query tile, key tile, head, window chunk) sums
// ds * gate over its chunk of windows in registers and adds it to the
// planes once (f32 atomics, a few chunks per entry).
//
// Bound on this card: operations.  At hd = 32 each score carries 2*hd
// FLOPs per product; the backward runs five products per score (two of
// them rebuilt in each pass) against the forward's two, and the
// per-score exp / bias / gate work on the CUDA cores, not the tensor
// cores, sets the pace, as in the forward.  The three passes recompute the
// scores three times: the price of an atomic-free dq/dk/dv.
//
// Plain C interface for ctypes (kvq_tpu_torch/ops/build.py); every entry
// returns the CUDA error of its launches.
#include "flash_attention.cuh"

namespace kvq {

enum BwdPass { kPassDQ = 0, kPassDKDV = 1, kPassBias = 2 };

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

template <int HD>
constexpr size_t bwd_smem_bytes() {
  return sizeof(bf16) * 4 * kBQ * (HD + 8)          // sQ, sK, sV, sdO
         + sizeof(float) * 2 * kWarps * 16 * kSLd   // sS, sdP
         + sizeof(bf16) * 2 * kBQ * kPLd            // sP, sdS
         + sizeof(float) * kBQ * (HD + 4)           // output staging
         + sizeof(int) * 2 * kBQ + sizeof(float) * 2 * kBQ;  // ids, lse, D
}

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

template <int HD>
struct BwdSmem {
  static constexpr int kLd = HD + 8;
  bf16 *sQ, *sK, *sV, *sdO, *sP, *sdS;
  float *sS, *sdP, *sOut, *sLse, *sD;
  int *sQid, *sKid;
  __device__ explicit BwdSmem(unsigned char* raw) {
    sQ = reinterpret_cast<bf16*>(raw);
    sK = sQ + kBQ * kLd;
    sV = sK + kBKV * kLd;
    sdO = sV + kBKV * kLd;
    sS = reinterpret_cast<float*>(sdO + kBQ * kLd);
    sdP = sS + kWarps * 16 * kSLd;
    sP = reinterpret_cast<bf16*>(sdP + kWarps * 16 * kSLd);
    sdS = sP + kBQ * kPLd;
    sOut = reinterpret_cast<float*>(sdS + kBQ * kPLd);
    sQid = reinterpret_cast<int*>(sOut + kBQ * (HD + 4));
    sKid = sQid + kBQ;
    sLse = reinterpret_cast<float*>(sKid + kBKV);
    sD = sLse + kBQ;
  }
};

// Query side of window b: scaled q, dout, token ids, lse and D of rows q0..
template <int HD>
__device__ __forceinline__ void load_query_side(const AttnBwdParams& P,
                                                const BwdSmem<HD>& m, int b,
                                                int head, int q0) {
  const AttnParams& p = P.a;
  load_tile<HD, kBQ, true>(m.sQ, p.q + b * p.sq + head * p.hq, p.ldq, q0, p.n_q,
                           p.scale);
  load_tile<HD, kBQ, false>(m.sdO, P.dout + b * p.so + head * p.ho, p.ldo, q0,
                            p.n_q, 0.f);
  for (int i = threadIdx.x; i < kBQ; i += kThreads) {
    const bool ok = q0 + i < p.n_q;
    const long long r = ((long long)b * p.heads + head) * p.n_q + q0 + i;
    m.sQid[i] = ok ? token_meta(p, b, q0 + i) : 0;
    m.sLse[i] = ok ? P.lse[r] : 0.f;
    m.sD[i] = ok ? P.dsum[r] : 0.f;
  }
}

template <int HD>
__device__ __forceinline__ void load_key_side(const AttnBwdParams& P,
                                              const BwdSmem<HD>& m, int b,
                                              int head, int k0) {
  const AttnParams& p = P.a;
  load_tile<HD, kBKV, false>(m.sK, p.k + b * p.sk + head * p.hk, p.ldk, k0,
                             p.n_kv, 0.f);
  load_tile<HD, kBKV, false>(m.sV, p.v + b * p.sv + head * p.hv, p.ldv, k0,
                             p.n_kv, 0.f);
  for (int i = threadIdx.x; i < kBKV; i += kThreads)
    m.sKid[i] = k0 + i < p.n_kv ? token_meta(p, b, k0 + i) : 0;
}

// For the loaded tiles: this lane's 32 entries of p and ds (row r of the
// warp's 16, columns hc + 8*j + [0, 4)), zero outside the window.
template <int HD>
__device__ __forceinline__ void tile_grads(const AttnBwdParams& P,
                                           const BwdSmem<HD>& m, int head,
                                           int q0, int k0, float (&pr)[32],
                                           float (&ds)[32]) {
  constexpr int kLd = HD + 8;
  const AttnParams& p = P.a;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane >> 1, hc = (lane & 1) * 4;
  float* wS = m.sS + warp * 16 * kSLd;
  float* wdP = m.sdP + warp * 16 * kSLd;
#pragma unroll
  for (int nf = 0; nf < kBKV / 16; ++nf) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> s, dp;
    wmma::fill_fragment(s, 0.f);
    wmma::fill_fragment(dp, 0.f);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bk;
      wmma::load_matrix_sync(a, m.sQ + warp * 16 * kLd + kk * 16, kLd);
      wmma::load_matrix_sync(bk, m.sK + nf * 16 * kLd + kk * 16, kLd);
      wmma::mma_sync(s, a, bk, s);
      wmma::load_matrix_sync(a, m.sdO + warp * 16 * kLd + kk * 16, kLd);
      wmma::load_matrix_sync(bk, m.sV + nf * 16 * kLd + kk * 16, kLd);
      wmma::mma_sync(dp, a, bk, dp);
    }
    wmma::store_matrix_sync(wS + nf * 16, s, kSLd, wmma::mem_row_major);
    wmma::store_matrix_sync(wdP + nf * 16, dp, kSLd, wmma::mem_row_major);
  }
  __syncwarp();
  const int row = q0 + warp * 16 + r;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 v = *reinterpret_cast<const float4*>(wS + r * kSLd + hc + 8 * j);
    pr[4 * j] = v.x;
    pr[4 * j + 1] = v.y;
    pr[4 * j + 2] = v.z;
    pr[4 * j + 3] = v.w;
  }
  const bool row_ok = row < p.n_q;
  if (row_ok) {
    const float* rel_r = p.rel + ((long long)head * p.n_q + row) * p.n_kv;
    const float* frag_r =
        p.frag ? p.frag + ((long long)head * p.n_q + row) * p.n_kv : nullptr;
    add_window_bias(pr, p.n_kv, rel_r, frag_r, m.sQid[warp * 16 + r], m.sKid,
                    k0, hc);
  }
  const float lse = m.sLse[warp * 16 + r];
  const float dsum = m.sD[warp * 16 + r];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = hc + 8 * j + e;
      const bool ok = row_ok && k0 + c < p.n_kv;
      const float pe = ok ? __expf(pr[4 * j + e] - lse) : 0.f;
      pr[4 * j + e] = pe;
      ds[4 * j + e] = pe * (wdP[r * kSLd + c] - dsum);
    }
  __syncwarp();  // wS / wdP are rewritten by the next tile
}

// Writes a 64 x HD f32 staging tile (times `mul`) as bf16 rows r0.. of one
// head of a (b, h, row, d) tensor.
template <int HD>
__device__ __forceinline__ void store_rows(bf16* dst, long long ld,
                                           const float* src, int r0, int n,
                                           float mul) {
  for (int c = threadIdx.x; c < kBQ * HD / 8; c += kThreads) {
    const int r = c / (HD / 8), col = (c % (HD / 8)) * 8;
    if (r0 + r >= n) continue;
    __align__(16) bf16 y[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) y[e] = __float2bfloat16(src[r * (HD + 4) + col + e] * mul);
    *reinterpret_cast<uint4*>(dst + (long long)(r0 + r) * ld + col) =
        *reinterpret_cast<const uint4*>(y);
  }
}

template <int HD, int PASS>
__global__ void __launch_bounds__(kThreads)
attention_bwd_kernel(const AttnBwdParams P) {
  constexpr int kLd = HD + 8;
  constexpr int kF = HD / 16;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const BwdSmem<HD> m(smem_raw);
  const AttnParams& p = P.a;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane >> 1, hc = (lane & 1) * 4;
  const int head = blockIdx.y;
  const int ntile = (p.n_q + kBQ - 1) / kBQ;
  float pr[32], ds[32];

  if (PASS == kPassDQ) {
    const int b = blockIdx.z, q0 = blockIdx.x * kBQ;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kF];
#pragma unroll
    for (int f = 0; f < kF; ++f) wmma::fill_fragment(acc[f], 0.f);
    load_query_side<HD>(P, m, b, head, q0);
    for (int k0 = 0; k0 < p.n_kv; k0 += kBKV) {
      __syncthreads();
      load_key_side<HD>(P, m, b, head, k0);
      __syncthreads();
      tile_grads<HD>(P, m, head, q0, k0, pr, ds);
      bf16* wdS = m.sdS + warp * 16 * kPLd;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        __align__(8) bf16 t[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) t[e] = __float2bfloat16(ds[4 * j + e]);
        *reinterpret_cast<uint2*>(wdS + r * kPLd + hc + 8 * j) =
            *reinterpret_cast<const uint2*>(t);
      }
      __syncwarp();
#pragma unroll
      for (int f = 0; f < kF; ++f)
#pragma unroll
        for (int kk = 0; kk < kBKV / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bk;
          wmma::load_matrix_sync(a, wdS + kk * 16, kPLd);
          wmma::load_matrix_sync(bk, m.sK + kk * 16 * kLd + f * 16, kLd);
          wmma::mma_sync(acc[f], a, bk, acc[f]);
        }
    }
#pragma unroll
    for (int f = 0; f < kF; ++f)
      wmma::store_matrix_sync(m.sOut + warp * 16 * (HD + 4) + f * 16, acc[f],
                              HD + 4, wmma::mem_row_major);
    __syncthreads();
    store_rows<HD>(P.dq + b * p.sq + head * p.hq, p.ldq, m.sOut, q0, p.n_q,
                   p.scale);
  } else if (PASS == kPassDKDV) {
    const int b = blockIdx.z, k0 = blockIdx.x * kBKV;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> adk[kF], adv[kF];
#pragma unroll
    for (int f = 0; f < kF; ++f) {
      wmma::fill_fragment(adk[f], 0.f);
      wmma::fill_fragment(adv[f], 0.f);
    }
    load_key_side<HD>(P, m, b, head, k0);
    for (int q0 = 0; q0 < p.n_q; q0 += kBQ) {
      __syncthreads();
      load_query_side<HD>(P, m, b, head, q0);
      __syncthreads();
      tile_grads<HD>(P, m, head, q0, k0, pr, ds);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        __align__(8) bf16 tp[4], td[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          tp[e] = __float2bfloat16(pr[4 * j + e]);
          td[e] = __float2bfloat16(ds[4 * j + e]);
        }
        const int o = (warp * 16 + r) * kPLd + hc + 8 * j;
        *reinterpret_cast<uint2*>(m.sP + o) = *reinterpret_cast<const uint2*>(tp);
        *reinterpret_cast<uint2*>(m.sdS + o) = *reinterpret_cast<const uint2*>(td);
      }
      __syncthreads();  // every warp's rows of p and ds
      // this warp's 16 keys: dv += p^T dout, dk += ds^T (scale q)
#pragma unroll
      for (int f = 0; f < kF; ++f)
#pragma unroll
        for (int kk = 0; kk < kBQ / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bq;
          wmma::load_matrix_sync(a, m.sP + kk * 16 * kPLd + warp * 16, kPLd);
          wmma::load_matrix_sync(bq, m.sdO + kk * 16 * kLd + f * 16, kLd);
          wmma::mma_sync(adv[f], a, bq, adv[f]);
          wmma::load_matrix_sync(a, m.sdS + kk * 16 * kPLd + warp * 16, kPLd);
          wmma::load_matrix_sync(bq, m.sQ + kk * 16 * kLd + f * 16, kLd);
          wmma::mma_sync(adk[f], a, bq, adk[f]);
        }
    }
    __syncthreads();
#pragma unroll
    for (int f = 0; f < kF; ++f)
      wmma::store_matrix_sync(m.sOut + warp * 16 * (HD + 4) + f * 16, adk[f],
                              HD + 4, wmma::mem_row_major);
    __syncthreads();
    store_rows<HD>(P.dk + b * p.sk + head * p.hk, p.ldk, m.sOut, k0, p.n_kv, 1.f);
    __syncthreads();
#pragma unroll
    for (int f = 0; f < kF; ++f)
      wmma::store_matrix_sync(m.sOut + warp * 16 * (HD + 4) + f * 16, adv[f],
                              HD + 4, wmma::mem_row_major);
    __syncthreads();
    store_rows<HD>(P.dv + b * p.sv + head * p.hv, p.ldv, m.sOut, k0, p.n_kv, 1.f);
  } else {
    const int q0 = (blockIdx.x / ntile) * kBQ;
    const int k0 = (blockIdx.x % ntile) * kBKV;
    const int b0 = blockIdx.z * P.win_chunk;
    const int b1 = min(P.batch, b0 + P.win_chunk);
    float arel[32], afrag[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) arel[i] = afrag[i] = 0.f;
    for (int b = b0; b < b1; ++b) {
      __syncthreads();
      load_query_side<HD>(P, m, b, head, q0);
      load_key_side<HD>(P, m, b, head, k0);
      __syncthreads();
      tile_grads<HD>(P, m, head, q0, k0, pr, ds);
      const int qi = m.sQid[warp * 16 + r];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float g = p.frag ? frag_gate(qi, m.sKid[hc + 8 * j + e]) : 1.f;
          arel[4 * j + e] += ds[4 * j + e] * g;
          afrag[4 * j + e] += ds[4 * j + e] * (1.f - g);
        }
    }
    const int row = q0 + warp * 16 + r;
    if (row < p.n_q) {
      const long long base = ((long long)head * p.n_q + row) * p.n_kv;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = k0 + hc + 8 * j + e;
          if (c >= p.n_kv) continue;
          atomicAdd(P.drel + base + c, arel[4 * j + e]);
          if (P.dfrag) atomicAdd(P.dfrag + base + c, afrag[4 * j + e]);
        }
    }
  }
}

template <int HD, int PASS>
cudaError_t launch_bwd_pass(const AttnBwdParams& P, dim3 grid,
                            cudaStream_t stream) {
  constexpr size_t smem = bwd_smem_bytes<HD>();
  cudaFuncSetAttribute(attention_bwd_kernel<HD, PASS>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  attention_bwd_kernel<HD, PASS><<<grid, kThreads, smem, stream>>>(P);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_attention_bwd(AttnBwdParams& P, cudaStream_t stream) {
  const int n = P.a.n_q, heads = P.a.heads;
  const int ntile = (n + kBQ - 1) / kBQ;
  const long long rows = (long long)P.batch * heads * n;
  attn_dsum_kernel<<<(unsigned)((rows + 255) / 256), 256, 0, stream>>>(
      P.o, P.dout, P.a.ldo, P.a.so, P.a.ho, P.dsum,
      P.batch, heads, n, HD);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(ntile, heads, P.batch);
  if ((err = launch_bwd_pass<HD, kPassDQ>(P, grid, stream)) != cudaSuccess) return err;
  if ((err = launch_bwd_pass<HD, kPassDKDV>(P, grid, stream)) != cudaSuccess) return err;
  // about eight CTAs per SM's worth of work in the bias pass
  const int tiles = ntile * ntile * heads;
  int chunks = (132 * 8 + tiles - 1) / tiles;
  chunks = chunks < 1 ? 1 : (chunks > P.batch ? P.batch : chunks);
  P.win_chunk = (P.batch + chunks - 1) / chunks;
  chunks = (P.batch + P.win_chunk - 1) / P.win_chunk;
  return launch_bwd_pass<HD, kPassBias>(P, dim3(ntile * ntile, heads, chunks), stream);
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
  if (hd == 32) return (int)kvq::launch_attention_bwd<32>(P, stream);
  return (int)cudaErrorInvalidValue;
}

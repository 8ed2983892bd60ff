// Flash-style multi-head attention for Hopper (sm_90a), bf16 in / bf16 out,
// f32 softmax statistics.  One template serves every forward attention of
// the port, each layout read through the per-tensor strides of AttnParams:
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
// Bound on this card: at hd = 32/64 the two products do 2*hd FLOPs per
// score, so the exp and the bias arithmetic per score, not the tensor
// cores, set the pace; the bytes (q, k, v, out and the f32 bias planes,
// which stay L2-resident) are small beside that.  Design: one CTA of four
// warps owns 64 query rows of one (batch, head); keys stream through shared
// memory in tiles of 64 with an online softmax, so no (N, M) score matrix
// ever reaches device memory.  Products run on the tensor cores through
// WMMA (16x16x16 bf16, f32 accumulate).  The softmax gives each lane half a
// score row (32 scores): the row statistics take one shuffle, and the bias
// planes are read as independent float4 loads.  Shared-memory rows are
// padded so that these row-half accesses and the WMMA tiles spread over the
// banks.  Ragged tails (N = 392 is not a multiple of 64) are masked:
// missing keys score -inf, missing query rows are computed on zeros and not
// stored.
//
// Rounding order (matches the TPU kernels): q is scaled in f32 and rounded
// to bf16, scores and exp are f32, p is rounded to bf16 for the PV product,
// and the division by the row sum comes after PV.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace kvq {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kBQ = 64;    // query rows per CTA
constexpr int kBKV = 64;   // keys per streamed tile
constexpr int kWarps = 4;  // each warp owns 16 query rows
constexpr int kThreads = kWarps * 32;
constexpr int kSLd = kBKV + 8;  // f32 score row stride
constexpr int kPLd = kBKV + 8;  // bf16 probability row stride

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

__device__ __forceinline__ float frag_gate(int a, int b) {
  const int dd = abs(((a >> 24) & 0xff) - ((b >> 24) & 0xff));
  const int dh = abs(((a >> 16) & 0xff) - ((b >> 16) & 0xff));
  const int dw = abs(((a >> 8) & 0xff) - ((b >> 8) & 0xff));
  return static_cast<float>(dd + dh + dw);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Adds the gate-blended bias and the -100 seam mask to one lane's 32 scores
// of a query row (token ids qi; bias rows rel_r / frag_r, frag_r null
// without a fragment bias) against the key tile starting at k0.  Lane
// columns are hc + 8*j + [0, 4).  Shared by the forward and the backward
// so that both see the same scores.
__device__ __forceinline__ void add_window_bias(float (&s)[32], int n_kv,
                                                const float* rel_r,
                                                const float* frag_r, int qi,
                                                const int* sKid, int k0,
                                                int hc) {
  const bool vec_bias = n_kv % 4 == 0;  // float4 loads stay aligned
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = hc + 8 * j;
    float rb[4] = {0.f, 0.f, 0.f, 0.f}, fb[4] = {0.f, 0.f, 0.f, 0.f};
    if (vec_bias) {
      if (k0 + c < n_kv) {
        const float4 rv = *reinterpret_cast<const float4*>(rel_r + k0 + c);
        rb[0] = rv.x; rb[1] = rv.y; rb[2] = rv.z; rb[3] = rv.w;
        if (frag_r) {
          const float4 fv = *reinterpret_cast<const float4*>(frag_r + k0 + c);
          fb[0] = fv.x; fb[1] = fv.y; fb[2] = fv.z; fb[3] = fv.w;
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (k0 + c + e < n_kv) {
          rb[e] = rel_r[k0 + c + e];
          if (frag_r) fb[e] = frag_r[k0 + c + e];
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ki = sKid[c + e];
      float bias = rb[e];
      if (frag_r) {
        const float g = frag_gate(qi, ki);
        bias = bias * g + fb[e] * (1.f - g);
      }
      s[4 * j + e] += bias;
      if ((qi & 0xff) != (ki & 0xff)) s[4 * j + e] -= 100.f;
    }
  }
}

template <int HD>
constexpr size_t attn_smem_bytes() {
  return sizeof(bf16) * (kBQ + 2 * kBKV) * (HD + 8)    // sQ, sK, sV
         + sizeof(float) * kWarps * 16 * kSLd          // sS
         + sizeof(bf16) * kWarps * 16 * kPLd           // sP
         + sizeof(float) * kWarps * 16 * (HD + 4)      // sO
         + sizeof(int) * (kBQ + kBKV);                 // token ids
}

// Loads rows [r0, r0 + ROWS) x [0, HD) of one head into shared memory (row
// stride HD + 8), zero-filling rows >= n.  Optionally scales by `scale` in
// f32 and rounds back to bf16 (the q tile).
template <int HD, int ROWS, bool SCALE>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long ld, int r0, int n,
                                          float scale) {
  constexpr int kChunks = ROWS * HD / 8;
  for (int c = threadIdx.x; c < kChunks; c += kThreads) {
    const int r = c / (HD / 8);
    const int col = (c % (HD / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < n) {
      val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * ld + col);
      if (SCALE) {
        bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          e[i] = __float2bfloat16(__bfloat162float(e[i]) * scale);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * (HD + 8) + col) = val;
  }
}

template <int HD, bool WINDOW>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const AttnParams p) {
  static_assert(HD % 16 == 0 && HD <= 128, "head dim");
  constexpr int kLd = HD + 8;   // bf16 q/k/v row stride
  constexpr int kOLd = HD + 4;  // f32 output-accumulator row stride
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + kBQ * kLd;
  bf16* sV = sK + kBKV * kLd;
  float* sS = reinterpret_cast<float*>(sV + kBKV * kLd);
  bf16* sP = reinterpret_cast<bf16*>(sS + kWarps * 16 * kSLd);
  float* sO = reinterpret_cast<float*>(sP + kWarps * 16 * kPLd);
  int* sQid = reinterpret_cast<int*>(sO + kWarps * 16 * kOLd);
  int* sKid = sQid + kBQ;

  const int q0 = blockIdx.x * kBQ;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // softmax layout: lane owns row r of the warp's 16, columns
  // hc + 8*j + [0, 4) of each key tile (j < 8); its partner lane ^ 1 owns
  // the other half of the row
  const int r = lane >> 1;
  const int hc = (lane & 1) * 4;
  const int row = q0 + warp * 16 + r;

  const bf16* qb = p.q + batch * p.sq + head * p.hq;
  const bf16* kb = p.k + batch * p.sk + head * p.hk;
  const bf16* vb = p.v + batch * p.sv + head * p.hv;

  load_tile<HD, kBQ, true>(sQ, qb, p.ldq, q0, p.n_q, p.scale);
  if (WINDOW) {
    for (int i = threadIdx.x; i < kBQ; i += kThreads)
      sQid[i] = q0 + i < p.n_q ? token_meta(p, batch, q0 + i) : 0;
  }
  float* wS = sS + warp * 16 * kSLd;
  bf16* wP = sP + warp * 16 * kPLd;
  float* wO = sO + warp * 16 * kOLd;
  for (int i = lane; i < 16 * kOLd; i += 32) wO[i] = 0.f;

  float m_run = -INFINITY, l_run = 0.f;  // equal in both lanes of a row
  const bool bias_row = WINDOW && row < p.n_q;
  const float* rel_r =
      bias_row ? p.rel + ((long long)head * p.n_q + row) * p.n_kv : nullptr;
  const float* frag_r = (bias_row && p.frag)
      ? p.frag + ((long long)head * p.n_q + row) * p.n_kv : nullptr;

  for (int k0 = 0; k0 < p.n_kv; k0 += kBKV) {
    __syncthreads();  // previous tile fully consumed
    load_tile<HD, kBKV, false>(sK, kb, p.ldk, k0, p.n_kv, 0.f);
    load_tile<HD, kBKV, false>(sV, vb, p.ldv, k0, p.n_kv, 0.f);
    if (WINDOW) {
      for (int i = threadIdx.x; i < kBKV; i += kThreads)
        sKid[i] = k0 + i < p.n_kv ? token_meta(p, batch, k0 + i) : 0;
    }
    __syncthreads();

    // S = Q_w K^T for this warp's 16 rows and the 64 keys of the tile
#pragma unroll
    for (int nf = 0; nf < kBKV / 16; ++nf) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, sQ + warp * 16 * kLd + kk * 16, kLd);
        wmma::load_matrix_sync(b, sK + nf * 16 * kLd + kk * 16, kLd);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(wS + nf * 16, acc, kSLd, wmma::mem_row_major);
    }
    __syncwarp();

    // bias, mask and the online softmax over this lane's 32 scores
    float s[32];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 v = *reinterpret_cast<const float4*>(wS + r * kSLd + hc + 8 * j);
      s[4 * j] = v.x;
      s[4 * j + 1] = v.y;
      s[4 * j + 2] = v.z;
      s[4 * j + 3] = v.w;
    }
    if (bias_row) add_window_bias(s, p.n_kv, rel_r, frag_r, sQid[warp * 16 + r], sKid, k0, hc);
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (k0 + hc + 8 * j + e >= p.n_kv) s[4 * j + e] = -INFINITY;
        mx = fmaxf(mx, s[4 * j + e]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_run, mx);
    const float corr = __expf(m_run - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      __align__(8) bf16 pb[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = __expf(s[4 * j + e] - m_new);
        sum += pe;
        pb[e] = __float2bfloat16(pe);
      }
      *reinterpret_cast<uint2*>(wP + r * kPLd + hc + 8 * j) =
          *reinterpret_cast<const uint2*>(pb);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_run = l_run * corr + sum;
    m_run = m_new;
    {
      float* o = wO + r * kOLd + (lane & 1) * (HD / 2);
#pragma unroll
      for (int d = 0; d < HD / 2; d += 4) {
        float4 t = *reinterpret_cast<float4*>(o + d);
        t.x *= corr; t.y *= corr; t.z *= corr; t.w *= corr;
        *reinterpret_cast<float4*>(o + d) = t;
      }
    }
    __syncwarp();

    // O_w += P_w V
#pragma unroll
    for (int df = 0; df < HD / 16; ++df) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, wO + df * 16, kOLd, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBKV / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, wP + kk * 16, kPLd);
        wmma::load_matrix_sync(b, sV + kk * 16 * kLd + df * 16, kLd);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(wO + df * 16, acc, kOLd, wmma::mem_row_major);
    }
    __syncwarp();
  }

  if (row < p.n_q) {
    const float inv = 1.f / l_run;
    const float* o = wO + r * kOLd + (lane & 1) * (HD / 2);
    bf16* dst = p.out + batch * p.so + (long long)row * p.ldo + head * p.ho +
                (lane & 1) * (HD / 2);
#pragma unroll
    for (int d = 0; d < HD / 2; d += 8) {
      __align__(16) bf16 ob[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) ob[e] = __float2bfloat16(o[d + e] * inv);
      *reinterpret_cast<uint4*>(dst + d) = *reinterpret_cast<const uint4*>(ob);
    }
    if (p.lse && (lane & 1) == 0)
      p.lse[((long long)batch * p.heads + head) * p.n_q + row] = m_run + logf(l_run);
  }
}

// Launches the template for a runtime head dim; returns the launch error.
template <bool WINDOW>
cudaError_t launch_flash_attention(const AttnParams& p, int head_dim,
                                   int batch, cudaStream_t stream) {
  const dim3 grid((p.n_q + kBQ - 1) / kBQ, p.heads, batch);
  if (head_dim == 32) {
    constexpr size_t smem = attn_smem_bytes<32>();
    cudaFuncSetAttribute(flash_attention_kernel<32, WINDOW>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    flash_attention_kernel<32, WINDOW><<<grid, kThreads, smem, stream>>>(p);
  } else if (head_dim == 64) {
    constexpr size_t smem = attn_smem_bytes<64>();
    cudaFuncSetAttribute(flash_attention_kernel<64, WINDOW>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    flash_attention_kernel<64, WINDOW><<<grid, kThreads, smem, stream>>>(p);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace kvq

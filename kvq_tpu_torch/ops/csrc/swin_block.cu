// K1 and K4: the fused Swin block of the eval and train paths, as short
// sequences of this file's kernels and gemm.cu's products (replace fused_swin_block /
// _make_block_kernel and train_swin_block / _make_block_train_bwd_kernel in
// kvq_tpu/ops/window_attention.py).  Forward (K1; K4 adds the DropPath
// multipliers dp1, dp2 of each window to the two residual branches):
//
//   y1  = LN1(x)                        kvq_layernorm
//   qkv = y1 @ Wqkv^T + b               kvq_gemm
//   att = window attention(qkv)         kvq_window_attention
//   x1  = x + dp1 * (att @ Wproj^T + b) kvq_gemm, residual epilogue
//   y2  = LN2(x1)                       kvq_layernorm
//   h   = GELU(y2 @ Wfc1^T + b)         kvq_gemm, GELU epilogue
//   out = x1 + dp2 * (h @ Wfc2^T + b)   kvq_gemm, residual epilogue
//
// K4's forward keeps its intermediates (the fc1 pre-activation and the
// attention's row log-sum-exp among them); its backward reads them and runs
// the products backward on the same GEMM in its other two layouts:
// dX = dY @ W (kvq_gemm_bwd, A (M, K), B (K, N)) and dW = dY^T @ X (A and
// B both (K, *), the rows as the reduction axis, split into K ranges over
// the CTAs and summed with f32 atomics, since the master weights are f32).
// Column sums (kvq_colsum) give the bias gradients, kvq_layernorm_bwd the
// LayerNorm input and affine gradients, the GELU derivative is an epilogue,
// and the attention backward is train_attention.cu.
//
// The TPU kernel holds a whole block's weights in VMEM; at stage 3 they are
// ~14 MB, against 227 KB of shared memory per CTA here, so the block is
// split at its products.  Bound on this card: counting each input and output
// once, the block's products bound it at every stage (~4x more time at
// 989 TFLOP/s than its bytes take at 3.35 TB/s); this split adds round trips
// of the token tensor through device memory, which the L2 partly absorbs at
// stages 2-3.  The products are gemm.cu's wgmma GEMM (TMA-fed tiles, a
// producer thread and two consumer warpgroups, the epilogues from the
// accumulator registers), built as a library of its own; the LayerNorm
// runs as its own bandwidth-bound pass, one warp per row, so the GEMM's
// inner loop carries no normalisation.  The attention is
// flash_attention.cuh.
//
// Plain C interface, built with nvcc into a shared library and called with
// ctypes (kvq_tpu_torch/ops/build.py).  Every entry returns the CUDA error
// of its launch.
#include "flash_attention.cuh"

namespace kvq {

// y = LayerNorm(x) over rows of K (a multiple of 8), one warp per row:
// flax's statistics in f32 (var = mean(x^2) - mean(x)^2), the output
// rounded to bf16 as the next product's input.
__global__ void __launch_bounds__(256) layernorm_kernel(const bf16* x, const bf16* g,
                                                        const bf16* b, bf16* y, int M,
                                                        int K, float eps) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;  // whole warps: a row belongs to one warp
  const bf16* xr = x + (long long)row * K;
  float s = 0.f, s2 = 0.f;
  for (int c = lane * 8; c < K; c += 256) {
    const uint4 v = *reinterpret_cast<const uint4*>(xr + c);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float f = __bfloat162float(e[i]);
      s += f;
      s2 += f * f;
    }
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float mu = s / K;
  const float rs = rsqrtf(fmaxf(0.f, s2 / K - mu * mu) + eps);
  bf16* yr = y + (long long)row * K;
  for (int c = lane * 8; c < K; c += 256) {
    const uint4 v = *reinterpret_cast<const uint4*>(xr + c);
    const uint4 gv = *reinterpret_cast<const uint4*>(g + c);
    const uint4 bv = *reinterpret_cast<const uint4*>(b + c);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
    const bf16* ge = reinterpret_cast<const bf16*>(&gv);
    const bf16* be = reinterpret_cast<const bf16*>(&bv);
    __align__(16) bf16 out[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float t = (__bfloat162float(e[i]) - mu) * rs;
      out[i] = __float2bfloat16(t * __bfloat162float(ge[i]) + __bfloat162float(be[i]));
    }
    *reinterpret_cast<uint4*>(yr + c) = *reinterpret_cast<const uint4*>(out);
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float& d, float v) { d = v; }
__device__ __forceinline__ void from_f32(bf16& d, float v) { d = __float2bfloat16(v); }

constexpr int kLnMaxK = 768;            // widest block (stage 3)
constexpr int kLnPer = kLnMaxK / 32;    // channels per lane

// LayerNorm backward over rows of K <= 768, one warp per row, rows strided
// over the grid.  Recomputes the row statistics from x (flax's formula),
// then dx = res + rs * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat))
// with dxhat = dy * gamma; dgamma += dy * xhat and dbeta += dy are summed
// per CTA in shared memory and added to the f32 outputs once per CTA.
// With `dp`, also writes scaled = bf16(dx * dp[row / dp_rows]).
template <typename TRES, typename TOUT>
__global__ void __launch_bounds__(256)
layernorm_bwd_kernel(const bf16* x, const bf16* g, const float* dy,
                     const TRES* res, TOUT* dx, float* dg, float* db,
                     const float* dp, int dp_rows, bf16* scaled, int M, int K,
                     float eps) {
  __shared__ float s_dg[kLnMaxK], s_db[kLnMaxK];
  for (int c = threadIdx.x; c < K; c += blockDim.x) s_dg[c] = s_db[c] = 0.f;
  __syncthreads();
  const int lane = threadIdx.x % 32;
  float pg[kLnPer], pb[kLnPer];
#pragma unroll
  for (int i = 0; i < kLnPer; ++i) pg[i] = pb[i] = 0.f;
  for (int row = blockIdx.x * 8 + threadIdx.x / 32; row < M; row += gridDim.x * 8) {
    const long long o = (long long)row * K;
    float xv[kLnPer], dv[kLnPer];
    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < kLnPer; ++i) {
      const int c = lane + 32 * i;
      xv[i] = c < K ? __bfloat162float(x[o + c]) : 0.f;
      dv[i] = c < K ? dy[o + c] : 0.f;
      s += xv[i];
      s2 += xv[i] * xv[i];
    }
    s = warp_sum(s);
    s2 = warp_sum(s2);
    const float mu = s / K;
    const float rs = rsqrtf(fmaxf(0.f, s2 / K - mu * mu) + eps);
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int i = 0; i < kLnPer; ++i) {
      const int c = lane + 32 * i;
      xv[i] = (xv[i] - mu) * rs;  // xhat
      const float dxh = c < K ? dv[i] * __bfloat162float(g[c]) : 0.f;
      m1 += dxh;
      m2 += dxh * xv[i];
      pg[i] += dv[i] * xv[i];
      pb[i] += dv[i];
      dv[i] = dxh;
    }
    m1 = warp_sum(m1) / K;
    m2 = warp_sum(m2) / K;
    const float dps = dp ? dp[row / dp_rows] : 1.f;
#pragma unroll
    for (int i = 0; i < kLnPer; ++i) {
      const int c = lane + 32 * i;
      if (c >= K) continue;
      const float d = to_f32(res[o + c]) + rs * (dv[i] - m1 - xv[i] * m2);
      from_f32(dx[o + c], d);
      if (scaled) scaled[o + c] = __float2bfloat16(d * dps);
    }
  }
#pragma unroll
  for (int i = 0; i < kLnPer; ++i) {
    const int c = lane + 32 * i;
    if (c < K) {
      atomicAdd(s_dg + c, pg[i]);
      atomicAdd(s_db + c, pb[i]);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < K; c += blockDim.x) {
    atomicAdd(dg + c, s_dg[c]);
    atomicAdd(db + c, s_db[c]);
  }
}

// out[c] += sum over rows m of scale(m) * a[m, c], scale(m) = dp[m / dp_rows]
// or 1: 32 columns x 8 row lanes per CTA over a chunk of rows, one f32
// atomic per column per CTA.
template <typename T>
__global__ void __launch_bounds__(256)
colsum_kernel(const T* a, const float* dp, int dp_rows, float* out, int M,
              int N, int rows_per_cta) {
  __shared__ float part[8][33];
  const int c = blockIdx.x * 32 + threadIdx.x % 32;
  const int ty = threadIdx.x / 32;
  const int r0 = blockIdx.y * rows_per_cta;
  const int r1 = min(M, r0 + rows_per_cta);
  float acc = 0.f;
  if (c < N) {
    for (int m = r0 + ty; m < r1; m += 8) {
      const float v = to_f32(a[(long long)m * N + c]);
      acc += dp ? v * dp[m / dp_rows] : v;
    }
  }
  part[ty][threadIdx.x % 32] = acc;
  __syncthreads();
  if (ty == 0 && c < N) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) t += part[i][threadIdx.x % 32];
    atomicAdd(out + c, t);
  }
}

// dst = bf16(src * dp[m / dp_rows]) over (M, N) rows, eight per thread
__global__ void __launch_bounds__(256)
scale_rows_kernel(const bf16* src, const float* dp, int dp_rows, bf16* dst,
                  int M, int N) {
  const long long chunks = (long long)M * N / 8;
  for (long long c = blockIdx.x * 256LL + threadIdx.x; c < chunks;
       c += (long long)gridDim.x * 256) {
    const long long o = c * 8;
    const float s = dp[(o / N) / dp_rows];
    const uint4 v = *reinterpret_cast<const uint4*>(src + o);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
    __align__(16) bf16 y[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) y[i] = __float2bfloat16(__bfloat162float(e[i]) * s);
    *reinterpret_cast<uint4*>(dst + o) = *reinterpret_cast<const uint4*>(y);
  }
}

}  // namespace kvq

using kvq::bf16;

extern "C" int kvq_layernorm(const bf16* x, const bf16* g, const bf16* b,
                             bf16* y, int M, int K, float eps,
                             cudaStream_t stream) {
  kvq::layernorm_kernel<<<(M + 7) / 8, 256, 0, stream>>>(x, g, b, y, M, K, eps);
  return (int)cudaGetLastError();
}

// LayerNorm backward (K4).  res_f32 selects the residual gradient's type
// (f32, else bf16); out_f32 selects dx's.  dg/db: (K,) f32, accumulated.
extern "C" int kvq_layernorm_bwd(const bf16* x, const bf16* g, const float* dy,
                                 const void* res, int res_f32, void* dx,
                                 int out_f32, float* dg, float* db,
                                 const float* dp, int dp_rows, bf16* scaled,
                                 int M, int K, float eps, cudaStream_t stream) {
  if (K > kvq::kLnMaxK) return (int)cudaErrorInvalidValue;
  const int rows8 = (M + 7) / 8;
  const int grid = rows8 < 528 ? rows8 : 528;
  if (res_f32 && out_f32)
    kvq::layernorm_bwd_kernel<float, float><<<grid, 256, 0, stream>>>(
        x, g, dy, (const float*)res, (float*)dx, dg, db, dp, dp_rows, scaled, M, K, eps);
  else if (res_f32)
    kvq::layernorm_bwd_kernel<float, bf16><<<grid, 256, 0, stream>>>(
        x, g, dy, (const float*)res, (bf16*)dx, dg, db, dp, dp_rows, scaled, M, K, eps);
  else if (out_f32)
    kvq::layernorm_bwd_kernel<bf16, float><<<grid, 256, 0, stream>>>(
        x, g, dy, (const bf16*)res, (float*)dx, dg, db, dp, dp_rows, scaled, M, K, eps);
  else
    kvq::layernorm_bwd_kernel<bf16, bf16><<<grid, 256, 0, stream>>>(
        x, g, dy, (const bf16*)res, (bf16*)dx, dg, db, dp, dp_rows, scaled, M, K, eps);
  return (int)cudaGetLastError();
}

// out[c] += sum_m dp[m / dp_rows] * a[m, c] (dp may be null); a f32 when
// a_f32, else bf16.
extern "C" int kvq_colsum(const void* a, int a_f32, const float* dp,
                          int dp_rows, float* out, int M, int N,
                          cudaStream_t stream) {
  const int rows = 512;
  const dim3 grid((N + 31) / 32, (M + rows - 1) / rows);
  if (a_f32)
    kvq::colsum_kernel<float><<<grid, 256, 0, stream>>>(
        (const float*)a, dp, dp_rows, out, M, N, rows);
  else
    kvq::colsum_kernel<bf16><<<grid, 256, 0, stream>>>(
        (const bf16*)a, dp, dp_rows, out, M, N, rows);
  return (int)cudaGetLastError();
}

extern "C" int kvq_scale_rows(const bf16* src, const float* dp, int dp_rows,
                              bf16* dst, int M, int N, cudaStream_t stream) {
  const long long chunks = (long long)M * N / 8;
  const long long blocks = (chunks + 255) / 256;
  const int grid = (int)(blocks < 4096 ? blocks : 4096);
  kvq::scale_rows_kernel<<<grid, 256, 0, stream>>>(src, dp, dp_rows, dst, M, N);
  return (int)cudaGetLastError();
}

// The window attention on the qkv product of K1 and K4's forward, and K3
// (flash_window_attention_packed, the eval blocks that pad to the window)
// on its own.  qkv: (BW*N, 3C) from the qkv product; out: (BW*N, C), heads
// concatenated along C.  rel/frag: (heads, N, N) f32; frag may be null.
// dims: the padded token volume.  lse: (BW, heads, N) f32 row log-sum-exp
// for the backward, or null.
extern "C" int kvq_window_attention(const bf16* qkv, const float* rel,
                                    const float* frag, bf16* out, int BW,
                                    int N, int C, int heads, const int* dims,
                                    const int* win, const int* shift,
                                    const int* frags, float scale, float* lse,
                                    cudaStream_t stream) {
  kvq::AttnParams p{};
  p.q = qkv;
  p.k = qkv + C;
  p.v = qkv + 2 * C;
  p.out = out;
  p.ldq = p.ldk = p.ldv = 3LL * C;
  p.ldo = C;
  p.sq = p.sk = p.sv = 3LL * C * N;
  p.so = (long long)C * N;
  p.hq = p.hk = p.hv = p.ho = C / heads;
  p.n_q = p.n_kv = N;
  p.heads = heads;
  p.scale = scale;
  p.lse = lse;
  p.rel = rel;
  p.frag = frag;
  kvq::set_geometry(p, dims, win, shift, frags);
  return (int)kvq::launch_flash_attention<true>(p, C / heads, BW, stream);
}

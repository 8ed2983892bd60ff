// K1 and K4: the fused Swin block of the eval and train paths, as short
// sequences of this file's kernels (replace fused_swin_block /
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
// K4's backward recomputes that forward (keeping the fc1 pre-activation and
// the attention's row log-sum-exp) and runs the products backward on the
// same GEMM in its other two layouts: dX = dY @ W (kvq_gemm_bwd, A (M, K),
// B (K, N)) and dW = dY^T @ X (A and B both (K, *), the rows as the
// reduction axis, split over blockIdx.z and summed with f32 atomics, since
// the master weights are f32).  Column sums (kvq_colsum) give the bias
// gradients, kvq_layernorm_bwd the LayerNorm input and affine gradients,
// the GELU derivative is an epilogue, and the attention backward is
// train_attention.cu.
//
// The TPU kernel holds a whole block's weights in VMEM; at stage 3 they are
// ~14 MB, against 227 KB of shared memory per CTA here, so the block is
// split at its products.  Bound on this card: counting each input and output
// once, the block's products bound it at every stage (~4x more time at
// 989 TFLOP/s than its bytes take at 3.35 TB/s); this split adds round trips
// of the token tensor through device memory, which the L2 partly absorbs at
// stages 2-3.  The GEMM is a 128x128x32 WMMA tile on eight warps with a
// three-stage cp.async ring, so the next tiles' loads overlap the current
// tile's products; the LayerNorm runs as its own bandwidth-bound pass, one
// warp per row, so the GEMM's inner loop carries no normalisation.  The
// attention is flash_attention.cuh.
//
// Plain C interface, built with nvcc into a shared library and called with
// ctypes (kvq_tpu_torch/ops/build.py).  Every entry returns the CUDA error
// of its launch.
#include "flash_attention.cuh"

namespace kvq {

constexpr int kGM = 128, kGN = 128, kGK = 32;
constexpr int kGStages = 3;
constexpr int kGThreads = 256;   // 2 x 4 warps, each 64 x 32 of the tile
constexpr int kGLd = kGK + 8;    // ring row stride of a k-contiguous tile
constexpr int kGTLd = kGM + 8;   // ring row stride of an m/n-contiguous tile
constexpr int kGSlot = kGM * kGLd;  // one operand's ring slot (>= 32 x kGTLd)
constexpr int kGCLd = kGN + 4;   // f32 epilogue staging row stride
static_assert(kGM == kGN, "one loader serves both operands");
static_assert(kGSlot >= kGK * kGTLd, "ring slot");

enum GemmEpilogue {
  kEpiForward = 0,  // bf16 out = [res +] [dp *] bf16([GELU](acc + bias))
  kEpiF32 = 1,      // f32 out = acc
  kEpiAtomicF32 = 2,  // f32 out += acc (split-K partial sums)
  kEpiBf16 = 3,     // bf16 out = acc
  kEpiGeluBwd = 4,  // bf16 out = acc * GELU'(aux), aux the pre-activation
};

struct GemmParams {
  const bf16* a;      // (M, K) row-major; (K, M) when the A tile is transposed
  const bf16* w;      // (N, K) row-major (nn.Linear's weight); (K, N) when not
  const bf16* bias;   // (N,)                          kEpiForward
  const bf16* res;    // (M, N) residual, or nullptr   kEpiForward
  const float* dp;    // per-row-group branch scale dp[m / dp_rows], or nullptr
  int dp_rows;
  bf16* pre;          // (M, N) pre-activation out, or nullptr  kEpiForward
  const bf16* aux;    // (M, N) GELU pre-activation   kEpiGeluBwd
  bf16* out;          // (M, N) bf16 result
  float* out_f32;     // (M, N) f32 result
  int M, N, K;
  int gelu;
  int epi;
  int k_chunk;        // rows of K per blockIdx.z
};

constexpr size_t gemm_smem_bytes() {
  const size_t ring = sizeof(bf16) * kGStages * 2 * kGSlot;
  const size_t stage = sizeof(float) * kGM * kGCLd;
  return ring > stage ? ring : stage;
}

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

// d GELU(x) / dx = Phi(x) + x phi(x), exact erf
__device__ __forceinline__ float gelu_erf_grad(float x) {
  return 0.5f * (1.f + erff(x * 0.70710678118654752f)) +
         x * 0.39894228040143268f * __expf(-0.5f * x * x);
}

// One operand tile into a ring slot.  K_MINOR: a 128 x 32 tile of a
// (rows, ld) matrix whose k axis is contiguous (rows r0.., cols k0..);
// otherwise a 32 x 128 tile whose rows are k (k0..) and whose 128 columns
// (r0..) are contiguous.  Entries past `rows` or past `kend` are zero-filled
// (the contiguous extent is a multiple of 8).
template <bool K_MINOR>
__device__ __forceinline__ void gemm_load_tile(bf16* dst, const bf16* src,
                                               int rows, int ld, int r0,
                                               int k0, int kend) {
  for (int c = threadIdx.x; c < kGM * kGK / 8; c += kGThreads) {
    if (K_MINOR) {
      const int r = c / (kGK / 8), col = (c % (kGK / 8)) * 8;
      const bool v = k0 + col < kend && r0 + r < rows;
      cp_async16(dst + r * kGLd + col,
                 v ? src + (long long)(r0 + r) * ld + k0 + col : src, v);
    } else {
      const int r = c / (kGM / 8), col = (c % (kGM / 8)) * 8;
      const bool v = k0 + r < kend && r0 + col < rows;
      cp_async16(dst + r * kGTLd + col,
                 v ? src + (long long)(k0 + r) * ld + r0 + col : src, v);
    }
  }
}

// out = epilogue(op(A) @ op(B)) over one 128 x 128 tile; A_T: A is stored
// (K, M); B_KN: B is stored (K, N).  The forward epilogue rounds
// (acc + bias [, GELU]) to bf16, scales it by the row's DropPath multiplier
// (rounding again) and adds the residual, as the TPU kernel does; with no
// multiplier it is the eval kernel's epilogue unchanged.
template <bool A_T, bool B_KN>
__global__ void __launch_bounds__(kGThreads) gemm_kernel(const GemmParams p) {
  extern __shared__ __align__(128) unsigned char g_smem[];
  bf16* ring = reinterpret_cast<bf16*>(g_smem);

  const int m0 = blockIdx.y * kGM;
  const int n0 = blockIdx.x * kGN;
  const int kbeg = blockIdx.z * p.k_chunk;
  const int kend = min(p.K, kbeg + p.k_chunk);
  const int warp = threadIdx.x / 32;
  const int wm = warp / 4, wn = warp % 4;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int kt_n = kend > kbeg ? (kend - kbeg + kGK - 1) / kGK : 0;
  auto load = [&](int slot, int kt) {
    bf16* sA = ring + slot * 2 * kGSlot;
    const int k0 = kbeg + kt * kGK;
    gemm_load_tile<!A_T>(sA, p.a, p.M, A_T ? p.M : p.K, m0, k0, kend);
    gemm_load_tile<!B_KN>(sA + kGSlot, p.w, p.N, B_KN ? p.N : p.K, n0, k0, kend);
  };
#pragma unroll
  for (int s = 0; s < kGStages - 1; ++s) {
    if (s < kt_n) load(s, s);
    cp_async_commit();
  }
  using LayoutA = typename std::conditional<A_T, wmma::col_major, wmma::row_major>::type;
  using LayoutB = typename std::conditional<B_KN, wmma::row_major, wmma::col_major>::type;
  for (int kt = 0; kt < kt_n; ++kt) {
    cp_async_wait<kGStages - 2>();  // tile kt has landed
    __syncthreads();                // ... for every thread; slot kt-1 is free
    const int nxt = kt + kGStages - 1;
    if (nxt < kt_n) load(nxt % kGStages, nxt);
    cp_async_commit();
    const bf16* sA = ring + (kt % kGStages) * 2 * kGSlot;
    const bf16* sB = sA + kGSlot;
#pragma unroll
    for (int kk = 0; kk < kGK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LayoutA> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LayoutB> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int mo = wm * 64 + i * 16;
        if (A_T)
          wmma::load_matrix_sync(fa[i], sA + kk * 16 * kGTLd + mo, kGTLd);
        else
          wmma::load_matrix_sync(fa[i], sA + mo * kGLd + kk * 16, kGLd);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int no = wn * 32 + j * 16;
        if (B_KN)
          wmma::load_matrix_sync(fb[j], sB + kk * 16 * kGTLd + no, kGTLd);
        else
          wmma::load_matrix_sync(fb[j], sB + no * kGLd + kk * 16, kGLd);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring becomes the epilogue's staging tile

  float* sC = reinterpret_cast<float*>(g_smem);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(sC + (wm * 64 + i * 16) * kGCLd + wn * 32 + j * 16,
                              acc[i][j], kGCLd, wmma::mem_row_major);
  __syncthreads();

  // eight consecutive outputs per step (N is a multiple of 8)
  for (int c = threadIdx.x; c < kGM * kGN / 8; c += kGThreads) {
    const int r = c / (kGN / 8), col = (c % (kGN / 8)) * 8;
    const int row = m0 + r, gc = n0 + col;
    if (row >= p.M || gc >= p.N) continue;
    const float4 c0 = *reinterpret_cast<const float4*>(sC + r * kGCLd + col);
    const float4 c1 = *reinterpret_cast<const float4*>(sC + r * kGCLd + col + 4);
    const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
    const long long o = (long long)row * p.N + gc;
    if (p.epi == kEpiF32) {
      *reinterpret_cast<float4*>(p.out_f32 + o) = c0;
      *reinterpret_cast<float4*>(p.out_f32 + o + 4) = c1;
      continue;
    }
    if (p.epi == kEpiAtomicF32) {
#pragma unroll
      for (int i = 0; i < 8; ++i) atomicAdd(p.out_f32 + o + i, cv[i]);
      continue;
    }
    __align__(16) bf16 y[8];
    if (p.epi == kEpiBf16) {
#pragma unroll
      for (int i = 0; i < 8; ++i) y[i] = __float2bfloat16(cv[i]);
    } else if (p.epi == kEpiGeluBwd) {
      const uint4 hv = *reinterpret_cast<const uint4*>(p.aux + o);
      const bf16* he = reinterpret_cast<const bf16*>(&hv);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        y[i] = __float2bfloat16(cv[i] * gelu_erf_grad(__bfloat162float(he[i])));
    } else {
      const uint4 bv = *reinterpret_cast<const uint4*>(p.bias + gc);
      const bf16* be = reinterpret_cast<const bf16*>(&bv);
      uint4 rv = make_uint4(0, 0, 0, 0);
      if (p.res) rv = *reinterpret_cast<const uint4*>(p.res + o);
      const bf16* re = reinterpret_cast<const bf16*>(&rv);
      const float dpv = p.dp ? p.dp[row / p.dp_rows] : 1.f;
      __align__(16) bf16 pre[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float v = cv[i] + __bfloat162float(be[i]);
        pre[i] = __float2bfloat16(v);
        if (p.gelu) v = gelu_erf(v);
        y[i] = __float2bfloat16(v);
        if (p.dp) y[i] = __float2bfloat16(__bfloat162float(y[i]) * dpv);
        if (p.res) y[i] = __float2bfloat16(__bfloat162float(re[i]) + __bfloat162float(y[i]));
      }
      if (p.pre)
        *reinterpret_cast<uint4*>(p.pre + o) = *reinterpret_cast<const uint4*>(pre);
    }
    *reinterpret_cast<uint4*>(p.out + o) = *reinterpret_cast<const uint4*>(y);
  }
}

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

template <bool A_T, bool B_KN>
cudaError_t launch_gemm(const GemmParams& p, int splits, cudaStream_t stream) {
  const dim3 grid((p.N + kGN - 1) / kGN, (p.M + kGM - 1) / kGM, splits);
  constexpr size_t smem = gemm_smem_bytes();
  cudaFuncSetAttribute(gemm_kernel<A_T, B_KN>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  gemm_kernel<A_T, B_KN><<<grid, kGThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace kvq

using kvq::bf16;

// Forward product out = epilogue(a @ w^T + bias) (K1 and K4).  dp: (M /
// dp_rows,) f32 DropPath multipliers of the residual branch, or null (the
// eval call); pre: where to keep the pre-activation, or null.
extern "C" int kvq_gemm(const bf16* a, const bf16* w, const bf16* bias,
                        const bf16* res, bf16* out, int M, int N, int K,
                        int gelu, const float* dp, int dp_rows, bf16* pre,
                        cudaStream_t stream) {
  kvq::GemmParams p{};
  p.a = a;
  p.w = w;
  p.bias = bias;
  p.res = res;
  p.dp = dp;
  p.dp_rows = dp_rows;
  p.pre = pre;
  p.out = out;
  p.M = M;
  p.N = N;
  p.K = K;
  p.gelu = gelu;
  p.epi = kvq::kEpiForward;
  p.k_chunk = K;
  return (int)kvq::launch_gemm<false, false>(p, 1, stream);
}

// Backward products (K4).  weight_grad = 0: out = epi(a @ w) with a (M, K)
// and w (K, N) row-major (dX = dY @ W; epi kEpiF32, kEpiBf16, or
// kEpiGeluBwd with aux the (M, N) pre-activation).  weight_grad = 1:
// out_f32 += a^T @ w with a (K, M) and w (K, N) row-major (dW = dY^T @ X),
// K split over `splits` CTAs along z.
extern "C" int kvq_gemm_bwd(const bf16* a, const bf16* w, const bf16* aux,
                            bf16* out, float* out_f32, int M, int N, int K,
                            int weight_grad, int epi, int splits,
                            cudaStream_t stream) {
  kvq::GemmParams p{};
  p.a = a;
  p.w = w;
  p.aux = aux;
  p.out = out;
  p.out_f32 = out_f32;
  p.M = M;
  p.N = N;
  p.K = K;
  p.epi = weight_grad ? kvq::kEpiAtomicF32 : epi;
  if (!weight_grad) splits = 1;
  splits = splits < 1 ? 1 : splits;
  const int kc = (K + splits - 1) / splits;
  p.k_chunk = (kc + kvq::kGK - 1) / kvq::kGK * kvq::kGK;
  splits = (K + p.k_chunk - 1) / p.k_chunk;
  if (weight_grad) return (int)kvq::launch_gemm<true, true>(p, splits, stream);
  return (int)kvq::launch_gemm<false, true>(p, 1, stream);
}

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

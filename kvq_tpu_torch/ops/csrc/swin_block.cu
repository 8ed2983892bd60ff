// K1: the fused Swin block of the eval path, as a short sequence of this
// file's kernels (replaces fused_swin_block / _make_block_kernel in
// kvq_tpu/ops/window_attention.py):
//
//   y1  = LN1(x)                        kvq_layernorm
//   qkv = y1 @ Wqkv^T + b               kvq_gemm
//   att = window attention(qkv)         kvq_window_attention
//   x1  = x + att @ Wproj^T + b         kvq_gemm, residual epilogue
//   y2  = LN2(x1)                       kvq_layernorm
//   h   = GELU(y2 @ Wfc1^T + b)         kvq_gemm, GELU epilogue
//   out = x1 + h @ Wfc2^T + b           kvq_gemm, residual epilogue
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
constexpr int kGLd = kGK + 8;    // bf16 ring row stride (spreads the banks)
constexpr int kGCLd = kGN + 4;   // f32 epilogue staging row stride
static_assert(kGM == kGN, "one loader serves both operands");

struct GemmParams {
  const bf16* a;      // (M, K) row-major
  const bf16* w;      // (N, K) row-major: nn.Linear's weight
  const bf16* bias;   // (N,)
  const bf16* res;    // (M, N) residual, or nullptr
  bf16* out;          // (M, N)
  int M, N, K;
  int gelu;
};

constexpr size_t gemm_smem_bytes() {
  const size_t ring = sizeof(bf16) * kGStages * (kGM + kGN) * kGLd;
  const size_t stage = sizeof(float) * kGM * kGCLd;
  return ring > stage ? ring : stage;
}

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

// 16-byte asynchronous copy global -> shared; zero-fills when !full.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = full ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One 128 x 32 tile of A and of W into ring slot (sA, sB).  Rows past M or
// N and columns past K are zero-filled (K is a multiple of 8).
__device__ __forceinline__ void gemm_load(const GemmParams& p, bf16* sA,
                                          bf16* sB, int m0, int n0, int k0) {
  for (int c = threadIdx.x; c < kGM * kGK / 8; c += kGThreads) {
    const int r = c / (kGK / 8), col = (c % (kGK / 8)) * 8;
    const bool kin = k0 + col < p.K;
    const bool va = kin && m0 + r < p.M;
    const bool vb = kin && n0 + r < p.N;
    cp_async16(sA + r * kGLd + col,
               va ? p.a + (long long)(m0 + r) * p.K + k0 + col : p.a, va);
    cp_async16(sB + r * kGLd + col,
               vb ? p.w + (long long)(n0 + r) * p.K + k0 + col : p.w, vb);
  }
}

// out = epilogue(a @ w^T + bias): the epilogue rounds (acc + bias [, GELU])
// to bf16 and then adds the residual, as the TPU kernel does.
__global__ void __launch_bounds__(kGThreads) gemm_kernel(const GemmParams p) {
  extern __shared__ __align__(128) unsigned char g_smem[];
  bf16* ring = reinterpret_cast<bf16*>(g_smem);
  constexpr int kSlot = (kGM + kGN) * kGLd;

  const int m0 = blockIdx.y * kGM;
  const int n0 = blockIdx.x * kGN;
  const int warp = threadIdx.x / 32;
  const int wm = warp / 4, wn = warp % 4;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int kt_n = (p.K + kGK - 1) / kGK;
#pragma unroll
  for (int s = 0; s < kGStages - 1; ++s) {
    if (s < kt_n)
      gemm_load(p, ring + s * kSlot, ring + s * kSlot + kGM * kGLd, m0, n0, s * kGK);
    cp_async_commit();
  }
  for (int kt = 0; kt < kt_n; ++kt) {
    cp_async_wait<kGStages - 2>();  // tile kt has landed
    __syncthreads();                // ... for every thread; slot kt-1 is free
    const int nxt = kt + kGStages - 1;
    if (nxt < kt_n) {
      bf16* slot = ring + (nxt % kGStages) * kSlot;
      gemm_load(p, slot, slot + kGM * kGLd, m0, n0, nxt * kGK);
    }
    cp_async_commit();
    const bf16* sA = ring + (kt % kGStages) * kSlot;
    const bf16* sB = sA + kGM * kGLd;
#pragma unroll
    for (int kk = 0; kk < kGK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], sA + (wm * 64 + i * 16) * kGLd + kk * 16, kGLd);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], sB + (wn * 32 + j * 16) * kGLd + kk * 16, kGLd);
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
    const uint4 bv = *reinterpret_cast<const uint4*>(p.bias + gc);
    const bf16* be = reinterpret_cast<const bf16*>(&bv);
    const long long o = (long long)row * p.N + gc;
    uint4 rv = make_uint4(0, 0, 0, 0);
    if (p.res) rv = *reinterpret_cast<const uint4*>(p.res + o);
    const bf16* re = reinterpret_cast<const bf16*>(&rv);
    __align__(16) bf16 y[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float v = cv[i] + __bfloat162float(be[i]);
      if (p.gelu) v = gelu_erf(v);
      y[i] = __float2bfloat16(v);
      if (p.res) y[i] = __float2bfloat16(__bfloat162float(re[i]) + __bfloat162float(y[i]));
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

}  // namespace kvq

using kvq::bf16;

extern "C" int kvq_gemm(const bf16* a, const bf16* w, const bf16* bias,
                        const bf16* res, bf16* out, int M, int N, int K,
                        int gelu, cudaStream_t stream) {
  const kvq::GemmParams p{a, w, bias, res, out, M, N, K, gelu};
  const dim3 grid((N + kvq::kGN - 1) / kvq::kGN, (M + kvq::kGM - 1) / kvq::kGM);
  constexpr size_t smem = kvq::gemm_smem_bytes();
  cudaFuncSetAttribute(kvq::gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  kvq::gemm_kernel<<<grid, kvq::kGThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int kvq_layernorm(const bf16* x, const bf16* g, const bf16* b,
                             bf16* y, int M, int K, float eps,
                             cudaStream_t stream) {
  kvq::layernorm_kernel<<<(M + 7) / 8, 256, 0, stream>>>(x, g, b, y, M, K, eps);
  return (int)cudaGetLastError();
}

// qkv: (BW*N, 3C) from the qkv product; out: (BW*N, C), heads concatenated
// along C.  rel/frag: (heads, N, N) f32; frag may be null.
extern "C" int kvq_window_attention(const bf16* qkv, const float* rel,
                                    const float* frag, bf16* out, int BW,
                                    int N, int C, int heads, const int* dims,
                                    const int* win, const int* shift,
                                    const int* frags, float scale,
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
  p.n_q = p.n_kv = N;
  p.heads = heads;
  p.scale = scale;
  p.rel = rel;
  p.frag = frag;
  for (int a = 0; a < 3; ++a) {
    p.dims[a] = dims[a];
    p.win[a] = win[a];
    p.shift[a] = shift[a];
    p.frags[a] = frags[a];
  }
  return (int)kvq::launch_flash_attention<true>(p, C / heads, BW, stream);
}

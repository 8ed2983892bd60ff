// The C entries of the Swin block's products (gemm.cuh), for K1 and K4
// (ops/gemm.py).  Plain C interface, built with nvcc into a shared library
// and called with ctypes (kvq_tpu_torch/ops/build.py).  Every entry returns
// the CUDA error of its launch.
#include "gemm.cuh"

using kvq::bf16;

// Forward product out = epilogue(a @ w^T + bias) (K1 and K4): bias only,
// GELU (keeping the pre-activation in `pre` when it is not null), or the
// residual `res` (scaled first by the (M / dp_rows,) f32 DropPath
// multipliers `dp` when they are not null); other combinations are
// refused.  bn: the tile width (ops/gemm.py: plan_gemm).
extern "C" int kvq_gemm(const bf16* a, const bf16* w, const bf16* bias,
                        const bf16* res, bf16* out, int M, int N, int K,
                        int gelu, const float* dp, int dp_rows, bf16* pre,
                        int bn, cudaStream_t stream) {
  int epi;
  if (gelu && !res && !dp)
    epi = pre ? kvq::kEpiGeluPre : kvq::kEpiGelu;
  else if (!gelu && res && !pre)
    epi = dp ? kvq::kEpiResDp : kvq::kEpiRes;
  else if (!gelu && !res && !dp && !pre)
    epi = kvq::kEpiBias;
  else
    return (int)cudaErrorInvalidValue;
  kvq::GemmParams p{};
  p.bias = bias;
  p.res = res;
  p.dp = dp;
  p.dp_rows = dp_rows;
  p.pre = pre;
  p.out = out;
  p.M = M;
  p.N = N;
  p.K = K;
  p.k_chunk = (K + kvq::kGBK - 1) / kvq::kGBK * kvq::kGBK;
  return (int)kvq::launch_gemm(a, w, p, epi, bn, stream);
}

// Backward products (K4).  weight_grad = 0: out = epi(a @ w) with a (M, K)
// and w (K, N) row-major (dX = dY @ W; epi kEpiF32, kEpiBf16, or
// kEpiGeluBwd with aux the (M, N) pre-activation).  weight_grad = 1:
// out_f32 += a^T @ w with a (K, M) and w (K, N) row-major (dW = dY^T @ X),
// K split into chunks of k_chunk rows (a multiple of 64), one per CTA
// unit.  bn: the tile width.
extern "C" int kvq_gemm_bwd(const bf16* a, const bf16* w, const bf16* aux,
                            bf16* out, float* out_f32, int M, int N, int K,
                            int weight_grad, int epi, int bn, int k_chunk,
                            cudaStream_t stream) {
  kvq::GemmParams p{};
  p.aux = aux;
  p.out = out;
  p.out_f32 = out_f32;
  p.M = M;
  p.N = N;
  p.K = K;
  if (weight_grad) {
    p.k_chunk = k_chunk;
    return (int)kvq::launch_gemm(a, w, p, kvq::kEpiAtomicF32, bn, stream);
  }
  if (epi != kvq::kEpiF32 && epi != kvq::kEpiBf16 && epi != kvq::kEpiGeluBwd)
    return (int)cudaErrorInvalidValue;
  p.k_chunk = (K + kvq::kGBK - 1) / kvq::kGBK * kvq::kGBK;
  return (int)kvq::launch_gemm(a, w, p, epi, bn, stream);
}

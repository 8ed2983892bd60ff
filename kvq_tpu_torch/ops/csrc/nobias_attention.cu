// K2: batched multi-head attention with no bias or mask, channel layout
// (replaces flash_attention_nobias_cl / _make_nobias_cl_kernel in
// kvq_tpu/ops/window_attention.py).  q (X, N, C), k and v (X, M, C) with
// heads split along C; each may be a strided view (row stride ld) such as
// one third of a fused qkv product.  The block-diagonal window packing of
// the TPU kernel (_plan_nobias) is a TPU tiling choice and is not ported:
// here one CTA owns 64 query rows of one (x, head) and streams the keys
// through a cp.async ring (flash_attention.cuh, WINDOW = false).  Bound on
// this card: the bytes of q, k, v and the output (at most ~16 MB per call
// at the CDM shapes); the scores never leave registers, so the kernel
// reads each input once per query tile, and M <= 196 keys keep that to a
// few tiles.
//
// Plain C interface for ctypes (kvq_tpu_torch/ops/build.py); returns the
// CUDA error of the launch.
#include "flash_attention.cuh"

using kvq::bf16;

extern "C" int kvq_attention_nobias(const bf16* q, const bf16* k,
                                    const bf16* v, bf16* out, int X, int N,
                                    int M, int C, int heads, long long ldq,
                                    long long ldk, long long ldv, float scale,
                                    cudaStream_t stream) {
  kvq::AttnParams p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.ldq = ldq;
  p.ldk = ldk;
  p.ldv = ldv;
  p.ldo = C;
  p.sq = ldq * N;
  p.sk = ldk * M;
  p.sv = ldv * M;
  p.so = (long long)C * N;
  p.hq = p.hk = p.hv = p.ho = C / heads;
  p.n_q = N;
  p.n_kv = M;
  p.heads = heads;
  p.scale = scale;
  return (int)kvq::launch_flash_attention<false>(p, C / heads, X, stream);
}

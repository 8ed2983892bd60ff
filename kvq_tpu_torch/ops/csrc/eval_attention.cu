// The eval attentions on head-major tensors, each on the flash template of
// flash_attention.cuh, which reads any layout through the per-tensor row,
// head and batch strides of AttnParams.  (K3, the window attention on the
// (BW*N, 3C) qkv product, is kvq_window_attention of swin_block.cu, the
// entry K1 uses.)
//
//   K6  kvq_window_attention_heads: window attention on head-major q, k, v
//       (BW, h, N, hd), any strides that keep rows of hd contiguous; out
//       (BW, h, N, hd).  Replaces flash_window_attention (kernel
//       _make_kernel) of kvq_tpu/ops/window_attention.py.
//   K7  kvq_attention_nobias_heads: attention with no bias or mask on
//       head-major q (X, h, N, hd) and k, v (X, h, M, hd); out (X, h, N, hd).
//       Replaces flash_attention_nobias (kernel _make_nobias_kernel); its
//       window packing (_plan_nobias, pack_override) is a TPU tiling choice
//       and is not ported.
//
// The window kernel rebuilds the fragment gate and the seam mask from token
// coordinates at the geometry it is given, which must be the PADDED token
// volume (Dp, Hp, Wp) the windows were partitioned from: token_meta derives
// the window grid from dims / win.  Padded tokens are not masked; they
// attend and are attended to, as in the reference.
//
// Bound on this card: the bytes (q, k, v and out once, the f32 planes
// once) for both at their shapes; the window kernel's pace is set by the
// per-score bias reads from L2 and the exp and blend on the CUDA cores.
// The design is the shared body's (flash_attention.cuh): four warps per 64
// query rows of one (batch, head), two windows a CTA sharing the staged
// bias tiles, scores, probabilities and output in mma.sync registers, K, V
// and bias streamed in tiles of 64 keys through a cp.async ring with an
// online softmax, no score matrix in device memory.  Ragged tails (N = 392,
// 64 at clamped or small windows) are masked there.
//
// Plain C interface for ctypes (kvq_tpu_torch/ops/build.py); each entry
// returns the CUDA error of its launch.
#include "flash_attention.cuh"

using kvq::bf16;

namespace {

// strides: (batch, head, row) of q, then of k, then of v, in elements; the
// output is contiguous (batch, heads, rows, hd).
void set_head_major(kvq::AttnParams& p, const long long* strides, int n_q,
                    int heads, int hd) {
  p.sq = strides[0];
  p.hq = strides[1];
  p.ldq = strides[2];
  p.sk = strides[3];
  p.hk = strides[4];
  p.ldk = strides[5];
  p.sv = strides[6];
  p.hv = strides[7];
  p.ldv = strides[8];
  p.ldo = hd;
  p.ho = (long long)n_q * hd;
  p.so = (long long)heads * n_q * hd;
}

}  // namespace

// K6.  q, k, v: (BW, heads, N, hd) bf16 at `strides`; out: contiguous
// (BW, heads, N, hd) bf16; rel/frag: (heads, N, N) f32, frag null without a
// fragment bias; dims: the padded token volume.
extern "C" int kvq_window_attention_heads(
    const bf16* q, const bf16* k, const bf16* v, const float* rel,
    const float* frag, bf16* out, int BW, int N, int heads, int hd,
    const long long* strides, const int* dims, const int* win,
    const int* shift, const int* frags, float scale, cudaStream_t stream) {
  kvq::AttnParams p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  set_head_major(p, strides, N, heads, hd);
  p.n_q = p.n_kv = N;
  p.heads = heads;
  p.scale = scale;
  p.rel = rel;
  p.frag = frag;
  kvq::set_geometry(p, dims, win, shift, frags);
  return (int)kvq::launch_flash_attention<true>(p, hd, BW, stream);
}

// K7.  q: (X, heads, N, hd), k and v: (X, heads, M, hd) bf16 at `strides`;
// out: contiguous (X, heads, N, hd) bf16.
extern "C" int kvq_attention_nobias_heads(
    const bf16* q, const bf16* k, const bf16* v, bf16* out, int X, int N,
    int M, int heads, int hd, const long long* strides, float scale,
    cudaStream_t stream) {
  kvq::AttnParams p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  set_head_major(p, strides, N, heads, hd);
  p.n_q = N;
  p.n_kv = M;
  p.heads = heads;
  p.scale = scale;
  return (int)kvq::launch_flash_attention<false>(p, hd, X, stream);
}

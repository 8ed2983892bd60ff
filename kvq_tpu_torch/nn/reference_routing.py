"""The JAX package's rule for which Swin block takes the fused block kernel,
kept here so that the port routes every block where the reference does.

The reference gates its fused block on estimates of the TPU kernels' VMEM
footprints (``fused_block_vmem_bytes`` in kvq_tpu/nn/swin.py;
``_plan_bias_cache``, ``_train_bwd_vmem_at``, ``_train_bwd_pb`` and
``train_block_vmem_bytes`` in kvq_tpu/ops/window_attention.py), each held
to 80 MB.  These are copies of those estimates, TPU bytes and all: they say
nothing about this card's memory, only which route a block takes.  At the
shipped train shapes (B=4, T=32) stages 0-2 fit both gates and take the
fused train block (K4); stage 3's backward estimate exceeds 80 MB, so it
takes the differentiable window attention (K5).
"""

from __future__ import annotations

GATE_BYTES = 80 * 1024 * 1024
BIAS_CACHE_BUDGET = 40 * 1024 * 1024  # reference BIAS_CACHE_BUDGET
BIAS_CACHE_ITEMSIZE = 4               # reference BIAS_CACHE_DTYPE: float32


def plan_bias_cache(geo):
    """(p_eff, mode, pb): distinct bias patterns, cache mode and cache slab
    depth of the reference's fused block kernel."""
    _, Hw, Ww = geo.wgrid
    P = Hw * Ww
    _, sh, sw = geo.shift
    n = geo.n_tokens
    p_eff = P if (geo.use_frag or sh or sw) else 1
    bpp = geo.num_heads * n * n * BIAS_CACHE_ITEMSIZE
    if p_eff * bpp <= BIAS_CACHE_BUDGET:
        return p_eff, "resident", p_eff
    for g in (8, 4, 2, 1):
        if p_eff % g == 0 and g * bpp <= BIAS_CACHE_BUDGET:
            return p_eff, "major", g
    return p_eff, "major", 1


def fused_block_vmem_bytes(geo, C: int, hidden: int) -> int:
    """The reference's estimate for the fused eval / train-forward block."""
    N = geo.n_tokens
    _, _, cache_pats = plan_bias_cache(geo)
    if not (geo.use_frag or geo.shift[1] or geo.shift[2]):
        cache_pats = 0
    per_window = 2 * N * C * 2
    g_tiles = next(
        (g * per_window for g in (8, 4, 2, 1)
         if g * per_window <= 4 * 1024 * 1024),
        per_window,
    )
    return ((1 + int(geo.use_frag) + cache_pats) * geo.num_heads * N * N * 4
            + (4 * C * C + 2 * C * hidden) * 2 + g_tiles + 1024 * 1024)


def _train_bwd_vmem_at(geo, C: int, hidden: int, pb: int) -> int:
    N = geo.n_tokens
    h = geo.num_heads
    need_cache = geo.use_frag or bool(geo.shift[1] or geo.shift[2])
    n_planes = 1 + int(geo.use_frag)
    est = 0
    if need_cache:
        est += pb * h * N * N * 4
    if geo.use_frag:
        est += pb * N * N * 4
    est += 2 * n_planes * h * N * N * 4
    wbytes = 3 * C * C + C * C + 2 * C * hidden
    est += wbytes * 2 + wbytes * 4
    est += 10 * N * N * 4
    est += 4 * N * 3 * C * 4
    est += 3 * 8 * N * C * 2
    est += 2 * 1024 * 1024
    return est


def train_block_vmem_bytes(geo, C: int, hidden: int) -> int:
    """The reference's estimate for the fused train block's backward, at
    the cache slab depth that kernel would use."""
    _, Hw, Ww = geo.wgrid
    P = Hw * Ww
    p_eff, _, pb = plan_bias_cache(geo)
    if p_eff <= 1:
        return _train_bwd_vmem_at(geo, C, hidden, 0)
    while pb > 1 and _train_bwd_vmem_at(geo, C, hidden, pb) > GATE_BYTES \
            and P % (pb // 2) == 0:
        pb //= 2
    return _train_bwd_vmem_at(geo, C, hidden, pb)


def takes_fused_block(geo, C: int, hidden: int, train: bool) -> bool:
    """Whether the reference sends a pad-free block to its fused kernel:
    at eval when the forward estimate fits, in training when both the
    forward and the backward estimates do."""
    if fused_block_vmem_bytes(geo, C, hidden) > GATE_BYTES:
        return False
    return not train or train_block_vmem_bytes(geo, C, hidden) <= GATE_BYTES

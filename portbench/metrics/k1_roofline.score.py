"""K1 (``fused_swin_block``, every Swin block of a KSVQE eval forward)
against its roofline, in %: the least time of the traced window's K1
calls (each block's bytes over 3.35 TB/s or operations over 989 TFLOP/s,
the larger, summed over the 12 blocks of a forward, times the forwards
the calls make) over the device time of the kernel families that only K1
launches in this cell (the window attention, the GEMM, the LayerNorm).
Nothing when no K1 call was traced."""

from portbench.harness.work import bound_s, swin_block_cost, swin_stages

FAMILIES = ("kvq_window_attention", "kvq_gemm", "kvq_layernorm")


def read(r):
    t = r.trace
    calls = t["counts"]["k1"]
    spent = sum(t["families_s"].get(f, 0.0) for f in FAMILIES)
    if not calls or not spent:
        return None
    stages = swin_stages(r.ctx.config, r.ctx.mix)
    per_forward = sum(
        s["depth"] * bound_s(*reversed(swin_block_cost(
            s["batch"], s["dims"], s["window"], s["C"], s["heads"],
            s["frag"])[:2]))
        for s in stages)
    blocks = sum(s["depth"] for s in stages)
    return 100.0 * per_forward * (calls / blocks) / spent

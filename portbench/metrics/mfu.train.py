"""The training window's share of the card's peak bf16 rate, in %: the
reference's operations of one step (forward and backward at the mix's
batch, frozen parts without weight gradients, no recompute; counted on
the meta device) times the steps a second over the window outside its
traced span (the profiler slows the host), over 989 TFLOP/s."""

from portbench.harness.work import PEAK_BF16_FLOPS, model_flops


def read(r):
    w, t = r.window, r.trace
    per_s = (w["done"] - t["units"]) / (w["elapsed"] - t["span_s"])
    flops = model_flops(r.ctx.config, r.ctx.mix, train=True)
    return 100.0 * flops * per_s / PEAK_BF16_FLOPS

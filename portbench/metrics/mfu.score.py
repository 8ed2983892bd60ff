"""The scoring window's share of the card's peak bf16 rate, in %: the
reference's operations for one video (a forward at the mix's shapes,
counted on the meta device) times the videos scored a second over the
window outside its traced span (the profiler slows the host), over
989 TFLOP/s."""

from portbench.harness.work import PEAK_BF16_FLOPS, model_flops


def read(r):
    w, t = r.window, r.trace
    b = r.ctx.mix["batch_size"]
    per_s = (w["done"] - t["units"] * b) / (w["elapsed"] - t["span_s"]) / b
    flops = model_flops(r.ctx.config, r.ctx.mix, train=False)
    return 100.0 * flops * per_s / PEAK_BF16_FLOPS

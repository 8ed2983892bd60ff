"""K4 (``train_swin_block``: KSVQE's pad-free blocks of stages 0-2) and
K5 (``window_attention_train``: stage 3) together against their
roofline, in %: the least time of the forward and backward each traced
train step needs of them (operations over 989 TFLOP/s or bytes over
3.35 TB/s, the larger; K4 for a whole block, K5 for its attention) times
the steps traced, over the device time of all the port's ``kvq_*``
kernel families, which share kernel names between K4 and K5.  Stages
0-2 take K4 and stage 3 takes K5 at these shapes, as the program routes
them (kvq_tpu's gate on its kernels' memory estimates).  Nothing when
neither ran in the traced window."""

from portbench.harness.work import (
    bound_s,
    swin_block_cost,
    swin_stages,
    window_attention_cost,
)


def read(r):
    t = r.trace
    steps = t["counts"]["units"]
    spent = sum(v for f, v in t["families_s"].items()
                if f.startswith("kvq_"))
    if not (t["counts"]["k4"] or t["counts"]["k5"]) or not spent or not steps:
        return None
    need = 0.0
    for i, s in enumerate(swin_stages(r.ctx.config, r.ctx.mix)):
        if i < 3:
            fo, fb, bo, bb = swin_block_cost(s["batch"], s["dims"],
                                             s["window"], s["C"], s["heads"],
                                             s["frag"])
        else:
            fo, fb, bo, bb = window_attention_cost(
                s["batch"], s["padded"], s["window"], s["heads"],
                s["C"] // s["heads"], s["frag"])
        need += s["depth"] * (bound_s(fb, fo) + bound_s(bb, bo))
    return 100.0 * need * steps / spent

"""Kernels launched on the card a scored video: the traced window's
kernels over the forwards dispatched in it (the model's calls)."""


def read(r):
    t = r.trace
    units = t["counts"]["units"] * r.ctx.mix["batch_size"]
    return t["kernels"] / units if units else None

"""Kernels launched on the card a train step: the traced window's kernels
over the steps the Trainer took in it (its ``step`` counter)."""


def read(r):
    t = r.trace
    units = t["counts"]["units"]
    return t["kernels"] / units if units else None

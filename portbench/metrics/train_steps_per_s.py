"""Optimizer steps a second: every step the window took over the
window's whole time, from the first hand-off to the losses read back
after the last step (host clock)."""


def read(r):
    return r.window["done"] / r.window["elapsed"]

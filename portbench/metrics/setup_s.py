"""Seconds from the process's start to the window's first hand-off:
imports, the weights drawn on the card from the seed, the model and its
optimizer, the traffic pool, the warm-up (and, in a checkout's first run,
the kernels' build) (host clock)."""


def read(r):
    return r.setup_s

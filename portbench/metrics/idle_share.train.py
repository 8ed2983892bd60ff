"""Share of the traced window in which no kernel ran on the card, in %:
100 x (1 - busy / window), busy being the union of the kernel intervals
(device trace)."""


def read(r):
    t = r.trace
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])

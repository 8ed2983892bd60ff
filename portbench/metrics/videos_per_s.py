"""Videos scored a second: every video the window completed over the
window's whole time, the drain of the last in-flight batches included
(host clock)."""


def read(r):
    return r.window["done"] / r.window["elapsed"]

"""The card's peak allocated memory over the training window, in GiB
(``torch.cuda.max_memory_allocated`` after a reset at the window's
start)."""


def read(r):
    return r.peak_bytes / 2 ** 30 if r.peak_bytes else None

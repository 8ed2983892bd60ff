"""ms a scored video that the dispatch thread spent reading the scores of the
batch one behind back to the host (``Evaluator._collect``: the ``.cpu()``
that waits for the card), over the traced part of the window: the total of
the ``kvq.eval.readback`` spans (``kvq_tpu_torch.core.tracing``, recorded
while the profiler runs) over the ``kvq.eval.forward`` spans the recorder
saw times the mix's batch size.  Nothing where the program
records no spans, or no ``kvq.eval.forward`` span."""

SPANS = ('kvq.eval.readback',)


def read(r):
    try:
        from kvq_tpu_torch.core import tracing
    except ImportError:  # a program without the span recorder
        return None
    summ = tracing.summary()
    units = summ.get("kvq.eval.forward", {}).get("dispatch", {}).get(
        "count", 0)
    if not units:
        return None
    ms = sum(summ.get(n, {}).get("dispatch", {}).get("total_ms", 0.0)
             for n in SPANS)
    return ms / (units * r.ctx.mix["batch_size"])

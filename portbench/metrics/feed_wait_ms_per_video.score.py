"""ms a scored video that the dispatch thread spent getting the next batch (the
wait for the worker thread's pre-cast, the side-stream copies' enqueueing
and the closed-loop client's hand-off), over the traced part of the window:
the total of the ``kvq.eval.feed`` spans (``kvq_tpu_torch.core.tracing``,
recorded while the profiler runs) over the ``kvq.eval.forward`` spans the
recorder saw times the mix's batch size.  Nothing where the program
records no spans, or no ``kvq.eval.forward`` span."""

SPANS = ('kvq.eval.feed',)


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

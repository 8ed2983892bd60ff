"""ms a train step that the dispatch thread spent getting the next batch (the
wait for the worker thread's pre-cast, the side-stream copies' enqueueing
and the closed-loop client's hand-off), over the traced part of the window:
the total of the ``kvq.train.feed`` spans (``kvq_tpu_torch.core.tracing``,
recorded while the profiler runs) over the ``kvq.train.forward`` spans the
recorder saw.  Nothing where the program
records no spans, or no ``kvq.train.forward`` span."""

SPANS = ('kvq.train.feed',)


def read(r):
    try:
        from kvq_tpu_torch.core import tracing
    except ImportError:  # a program without the span recorder
        return None
    summ = tracing.summary()
    units = summ.get("kvq.train.forward", {}).get("dispatch", {}).get(
        "count", 0)
    if not units:
        return None
    ms = sum(summ.get(n, {}).get("dispatch", {}).get("total_ms", 0.0)
             for n in SPANS)
    return ms / units

"""ms a train step that the dispatch thread spent in ``zero_grad`` and
``loss.backward()`` (the autograd engine's work on its own thread included:
the dispatch thread waits for it), over the traced part of the window: the
total of the ``kvq.train.backward`` spans (``kvq_tpu_torch.core.tracing``,
recorded while the profiler runs) over the ``kvq.train.forward`` spans the
recorder saw.  Nothing where the program
records no spans, or no ``kvq.train.forward`` span."""

SPANS = ('kvq.train.backward',)


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

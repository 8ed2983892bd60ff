"""ms a train step that the dispatch thread spent in the loss (``total_loss``:
the PLCC loss and, where the schedule weighs them, the rank and contrastive
terms), over the traced part of the window: the total of the
``kvq.train.loss`` spans (``kvq_tpu_torch.core.tracing``, recorded while
the profiler runs, inside ``kvq.train.forward``) over the
``kvq.train.forward`` spans the recorder saw.  Nothing where the program
records no ``kvq.train.loss`` span, or no ``kvq.train.forward`` span."""


def read(r):
    try:
        from kvq_tpu_torch.core import tracing
    except ImportError:  # a program without the span recorder
        return None
    summ = tracing.summary()
    units = summ.get("kvq.train.forward", {}).get("dispatch", {}).get(
        "count", 0)
    loss = summ.get("kvq.train.loss", {}).get("dispatch")
    if not units or not loss:
        return None
    return loss["total_ms"] / units

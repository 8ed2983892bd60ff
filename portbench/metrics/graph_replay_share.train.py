"""Share of the train steps, in %, whose KSVQE backbone replayed its CUDA
graphs (``kvq_tpu_torch/nn/train_graphs.py``) over the traced part of the
window: the ``kvq.train.replay`` spans on the dispatch thread
(``kvq_tpu_torch.core.tracing``, recorded while the profiler runs) over its
``kvq.train.forward`` spans.  Nothing where the program records no
``kvq.train.forward`` span, or has no graphed train step."""

from importlib import import_module


def read(r):
    try:
        tracing = import_module("kvq_tpu_torch.core.tracing")
        import_module("kvq_tpu_torch.nn.train_graphs")
    except ImportError:  # a program without the recorder or the graphs
        return None
    summ = tracing.summary()

    def count(name):
        return summ.get(name, {}).get("dispatch", {}).get("count", 0)
    units = count("kvq.train.forward")
    if not units:
        return None
    return 100.0 * count("kvq.train.replay") / units

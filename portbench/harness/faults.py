"""Faults planted in the program, to show that the check of a cell comes
out not correct: ``calibrate.py --fault <name>`` reads them on the card at
the cell's own size, the tests on the CPU at a tiny one.

- ``state_unchanged``: the optimizer's step changes nothing;
- ``half_batch``: a train step sees the first half of its batch's rows
  only (the loss's means over the rest);
- ``answer_altered``: the first row's features, where the backbone
  produces them, scaled by 1.5 (the answer the head then scores);
- ``score_altered``: the head's scores, where it produces them, scaled by
  1.5;
- ``scores_shifted``: the Evaluator's read-back hands each batch the
  scores of the batch before it;
- ``one_learning_rate``: the Trainer's optimizer built with
  ``backbone_lr_mult`` 1, whatever the configuration states;
- ``rank_dropped``: the Trainer's rank loss weight set to 0.

Each is a context manager that patches the program's modules and undoes
it on exit.  One card: no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def state_unchanged():
    from kvq_tpu_torch.train import trainer

    orig = trainer.optimizer_from_config

    def frozen(*a, **k):
        opt, sched = orig(*a, **k)
        opt.step = lambda closure=None: None
        return opt, sched
    with _patched(trainer, "optimizer_from_config", frozen):
        yield


@contextlib.contextmanager
def half_batch():
    from kvq_tpu_torch.train.trainer import Trainer

    orig = Trainer._step

    def half(self, dev):
        n = dev["label"].shape[0] // 2
        return orig(self, {k: v[:n] for k, v in dev.items()})
    with _patched(Trainer, "_step", half):
        yield


@contextlib.contextmanager
def answer_altered():
    from kvq_tpu_torch.nn import ksvqe, swin

    def scaled(cls):
        orig = cls.forward

        def forward(self, *a, **k):
            out = orig(self, *a, **k)
            feat, rest = (out[0], out[1:]) if isinstance(out, tuple) else (
                out, None)
            feat = feat.clone()
            feat[0] = feat[0] * 1.5
            return (feat, *rest) if rest is not None else feat
        return forward
    with _patched(ksvqe.KSVQE, "forward", scaled(ksvqe.KSVQE)), \
            _patched(swin.SwinTransformer3D, "forward",
                     scaled(swin.SwinTransformer3D)):
        yield


@contextlib.contextmanager
def score_altered():
    from kvq_tpu_torch.nn import heads

    orig = heads.VQAHead.forward

    def forward(self, x, gen=None):
        return orig(self, x, gen) * 1.5
    with _patched(heads.VQAHead, "forward", forward):
        yield


@contextlib.contextmanager
def scores_shifted():
    from kvq_tpu_torch.train.evaluator import Evaluator

    orig = Evaluator._collect
    seen = []

    def collect(self, n, out):
        seen.append(orig(self, n, out))
        return seen[-2] if len(seen) > 1 else seen[-1]
    with _patched(Evaluator, "_collect", collect):
        yield


@contextlib.contextmanager
def one_learning_rate():
    from kvq_tpu_torch.train import trainer

    orig = trainer.optimizer_from_config

    def single(named_params, config, steps_per_epoch):
        opt = {**(config.get("optimizer") or {}), "backbone_lr_mult": 1.0}
        return orig(named_params, {**config, "optimizer": opt},
                    steps_per_epoch)
    with _patched(trainer, "optimizer_from_config", single):
        yield


@contextlib.contextmanager
def rank_dropped():
    from kvq_tpu_torch.train import trainer

    orig = trainer.step_settings

    def settings(config):
        return orig(config)._replace(rank_w=0.0)
    with _patched(trainer, "step_settings", settings):
        yield


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "answer_altered": answer_altered, "score_altered": score_altered,
          "scores_shifted": scores_shifted,
          "one_learning_rate": one_learning_rate,
          "rank_dropped": rank_dropped}

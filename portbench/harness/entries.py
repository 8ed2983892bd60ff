"""The entries a window drives, by the name a mix gives under ``entry``.

``score``: one client in a closed loop hands the pool's batches, in turn,
to ``kvq_tpu_torch.train.evaluator.Evaluator.scored_batches`` (what
``cli.test`` runs); a video's latency runs from the hand-off of its batch
to its score on the host.

``train``: the same closed loop into one ``Trainer.train_epoch`` call;
its first three steps are set-up (the warm-up, and what the reference
follows), and the window opens once they have run.

Each entry has ``setup(ctx)``, ``window(ctx, state, seconds, tracer,
begin)`` (``begin()`` drains the card, opens the window and returns its
start on the host clock), ``release(state)`` (drops the program) and
``judge(ctx, state, control=None)``, which builds the reference once the
program is freed and returns its readings and the count of answers that
were no number.  Where the model has QRS (the reference's backbone has a
``selector``), the program's picks are recorded and the reference follows
them.
"""

from __future__ import annotations

import collections
import gc
import sys
import time

import torch

from . import inputs
from .qrs import QRSRecorder

TRACE_SECONDS = 4.0  # length of the traced part of a --trace 1 window


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def _reference(ctx):
    from ..reference.network import Network
    from ..reference.precision import exact_float32

    exact_float32()
    with torch.device(ctx.device):
        net = Network(ctx.config["model"])
    sd = inputs.make_state_dict(inputs.state_shapes(net),
                                ctx.config["model"], ctx.seed, ctx.device)
    net.load_state_dict(sd)
    del sd
    return net


def state_dict_for_program(ctx) -> dict:
    from ..reference.network import Network

    with torch.device("meta"):
        net = Network(ctx.config["model"])
    return inputs.make_state_dict(inputs.state_shapes(net),
                                  ctx.config["model"], ctx.seed, ctx.device)


def _device_batch(batch: dict, fields, device) -> dict:
    return {k: torch.as_tensor(batch[k]).to(device) for k in fields}


class _Feed:
    """The closed loop's hand-offs, ``pool[k % len(pool)]`` for k = 0, 1,
    ...  Those before ``begin(t0)`` belong to set-up; from ``t0`` the
    window runs ``seconds`` and the feed starts and stops the tracer on
    the way."""

    def __init__(self, pool, seconds, tracer, counters):
        self.pool, self.seconds = pool, seconds
        self.tracer, self.counters = tracer, counters
        self.handed: list[float] = []
        self.t0 = None

    def begin(self, t0: float) -> None:
        self.t0 = t0

    def pace(self, chunk: float = 5.0) -> list[int]:
        """Hand-offs in each ``chunk`` seconds of the window."""
        out: list[int] = []
        for t in self.handed:
            if t >= self.t0:
                i = int((t - self.t0) // chunk)
                out.extend([0] * (i + 1 - len(out)))
                out[i] += 1
        return out

    def __iter__(self):
        k, stop, tr = 0, None, self.tracer
        while True:
            now = time.perf_counter()
            if self.t0 is not None:
                if stop is None:
                    stop = self.t0 + self.seconds
                    t_on = self.t0 + max(0.0,
                                         (self.seconds - TRACE_SECONDS) / 2)
                    span = min(TRACE_SECONDS, self.seconds / 2)
                if tr is not None:
                    if tr.prof is None and now >= t_on:
                        tr.start(self.counters)  # can take seconds
                        stop = max(stop, tr.t0 + span + 0.5)
                    elif tr.running and now >= tr.t0 + span:
                        tr.stop(self.counters)
                if now >= stop:
                    if tr is not None and tr.running:
                        tr.stop(self.counters)
                    return
                if tr is not None and tr.running:
                    tr.units += 1
            batch = dict(self.pool[k % len(self.pool)])
            batch["_seq"] = k
            self.handed.append(time.perf_counter())
            yield batch
            k += 1


def _kernel_counters():
    from kvq_tpu_torch.ops import train_attention as ta
    from kvq_tpu_torch.ops import window_attention as wa

    return {"k1": wa.fused_swin_block.launches,
            "k2": wa.flash_attention_nobias_cl.launches,
            "k3": wa.flash_window_attention_packed.launches,
            "k4": ta.train_swin_block.launches,
            "k4_bwd": ta.train_swin_block_bwd.launches,
            "k5": ta.window_attention_train.launches,
            "k5_bwd": ta.window_attention_train_bwd.launches}


# ------------------------------------------------------------------ score


class Score:
    @staticmethod
    def setup(ctx):
        from kvq_tpu_torch.models.vqa_network import build_model
        from kvq_tpu_torch.train.evaluator import Evaluator

        cfg = {"name": ctx.config["name"], "model": ctx.config["model"]}
        model = build_model(cfg, ctx.device,
                            state_dict=state_dict_for_program(ctx))
        ev = Evaluator(cfg, model=model, device=ctx.device)
        pool = inputs.make_pool(ctx.mix, ctx.seed, ctx.device)
        forwards, feats = [0], {}
        model.register_forward_pre_hook(
            lambda *_: forwards.__setitem__(0, forwards[0] + 1))
        # the features the head scores, kept for the latest forward of each
        # pool slot (forward k scores slot k % pool): no copy, no sync
        key = ctx.config["model"]["type"]
        getattr(model, f"{key}_head").register_forward_pre_hook(
            lambda m, args: feats.__setitem__(
                (forwards[0] - 1) % len(pool), args[0].detach()))
        rec = QRSRecorder()
        for _ in ev.scored_batches(pool[:ev.depth + 1]):
            pass
        forwards[0] = 0
        rec.records.clear()
        return {"ev": ev, "pool": pool, "rec": rec, "forwards": forwards,
                "feats": feats}

    @staticmethod
    def counters(state):
        return lambda: {"units": state["forwards"][0], **_kernel_counters()}

    @staticmethod
    def window(ctx, state, seconds, tracer, begin):
        feed = _Feed(state["pool"], seconds, tracer, Score.counters(state))
        feed.begin(begin())
        scores, latency = {}, []
        for batch, n, got in state["ev"].scored_batches(feed):
            k = batch["_seq"]
            latency.append(time.perf_counter() - feed.handed[k])
            scores[k] = got[:n]
        elapsed = time.perf_counter() - feed.t0
        state["scores"] = scores
        state["rec_records"] = state["rec"].records
        # what the latest score of each slot has to be, bit for bit: the
        # program's own head on that forward's features, through the
        # Evaluator's read-back arithmetic (``Evaluator._collect``, copied)
        ev, P = state["ev"], len(state["pool"])
        head = getattr(ev.model, f"{ctx.config['model']['type']}_head")
        latest = {k % P: k for k in sorted(scores)}
        own = {}
        with torch.no_grad():
            for p, k in latest.items():  # forward(): the pre-hook stays out
                out = head.forward(state["feats"][p]).float().cpu().numpy()
                own[p] = (out.reshape(ev.eval_batch_size, -1).mean(axis=1)
                          [:len(scores[k])].tolist())
        state["own"] = own
        return {"attempted": len(feed.handed) * ctx.mix["batch_size"],
                "done": sum(len(v) for v in scores.values()),
                "elapsed": elapsed, "latency_s": latency,
                "pace": feed.pace()}

    @staticmethod
    def release(state):
        rec = state.get("rec")
        if rec is not None:
            rec.remove()
        state.pop("ev", None)

    @staticmethod
    def judge(ctx, state, control=None):
        """The program's outputs of the window against the reference's, by
        stage, the reference following QRS's picks of the latest forward
        of each pool slot (the program's, or the control's when
        ``control``):

        - ``feature_gap``: the backbone's features that the head scores
          (CLIP, QRS, CONTRIQUE, the Swin trunk with K1, CDM with K2), the
          relative L2 error of the latest forward of each slot, the worst
          slot;
        - ``head_gap``: every score that the window delivered against the
          reference's head on the features of its slot's latest forward,
          over the larger of that score's magnitude and the spread
          (standard deviation) of the per-token scores the head averages;
        - ``readback_errors``: the latest scores of the slots that differ
          from the program's own head on that forward's features, through
          the read-back's arithmetic (bit for bit: the read-back's order);
        - ``repeat_gap`` (read, not compared): every score against its
          slot's latest, over the same;
        - ``cls_attn_gap``, ``pick_errors``: QRS's input and picks (the
          reference's selector), where the model has QRS.
        ``score_gap`` (every score against the reference's whole forward,
        over the same spread) is read but not compared: a mean of
        thousands of token scores of either sign, it swings from seed to
        seed as much in the program as in the control (PERF.md)."""
        from ..reference.precision import Float8Products

        _free(ctx.device)
        ref = _reference(ctx).eval()
        P = len(state["pool"])
        fields = ctx.mix["fields"]
        sel = getattr(ref.backbone, "selector", None)
        if control is not None:  # the control in the program's place
            state["scores"], state["feats"], recs = {}, {}, []
            with torch.no_grad():
                for p in range(P):
                    dev = _device_batch(state["pool"][p], fields, ctx.device)
                    if sel is not None:
                        sel.record = []
                    with Float8Products():
                        feat, _ = ref.features(dev)
                        s = ref.head(feat)
                    state["feats"][p] = feat
                    state["scores"][p] = s.float().reshape(-1).tolist()
                    if sel is not None:
                        recs.extend(sel.record)
                        sel.record = None
            state["rec_records"] = recs
        latest = {}
        for k in sorted(state["scores"]):
            latest[k % P] = k
        want, spread, head, fgap = {}, {}, {}, 0.0
        with torch.no_grad():
            for p, k in latest.items():
                dev = _device_batch(state["pool"][p], fields, ctx.device)
                if sel is not None:
                    sel.follow = collections.deque(
                        [state["rec_records"][k]])
                feat, _ = ref.features(dev)
                theirs = state["feats"][p].float()
                fgap = max(fgap, float((theirs - feat).norm() / feat.norm()))
                tok = ref.head.tokens(feat).flatten(1)
                want[p] = tok.mean(1).tolist()
                spread[p] = tok.std(1).tolist()
                head[p] = ref.head.tokens(theirs).flatten(1).mean(1).tolist()
        bad = 0
        for got in state["scores"].values():
            bad += sum(1 for a in got if not abs(a) < float("inf"))

        def gap(a, b, sd):
            return abs(a - b) / max(abs(b), sd) if abs(a) < float(
                "inf") else float("inf")
        sgap, hgap, rgap = [], [], []
        for k, got in state["scores"].items():
            p = k % P
            mine = state["scores"][latest[p]]
            for i, a in enumerate(got):
                sgap.append(gap(a, want[p][i], spread[p][i]))
                rgap.append(gap(a, mine[i], spread[p][i]))
                hgap.append(gap(a, head[p][i], spread[p][i]))
        own = state.get("own")  # none for the control: its own scores
        readback = 0 if own is None else sum(
            a != b for p, k in latest.items()
            for a, b in zip(state["scores"][k], own[p]))
        out = {"feature_gap": fgap, "head_gap": max(hgap),
               "readback_errors": readback, "repeat_gap": max(rgap),
               "score_gap": max(sgap)}
        if sel is not None:
            out["cls_attn_gap"] = sel.cls_attn_gap
            out["pick_errors"] = sel.pick_errors
        return out, bad


# ------------------------------------------------------------------ train


class Train:
    COMPARED = 3  # steps the reference follows

    @staticmethod
    def program_config(ctx) -> dict:
        c = ctx.config
        return {"name": c["name"], "model": c["model"], **c["schedule"]}

    @staticmethod
    def setup(ctx):
        from kvq_tpu_torch.train.trainer import Trainer

        cfg = Train.program_config(ctx)
        spe = int(ctx.config["steps_per_epoch"])
        tr = Trainer(cfg, device=ctx.device, seed=ctx.seed,
                     steps_per_epoch=spe)
        tr.model.load_state_dict(state_dict_for_program(ctx))
        with torch.no_grad():
            for e, p in zip(tr.ema, tr.params):
                e.copy_(p)
        pool = inputs.make_pool(ctx.mix, ctx.seed, ctx.device)
        names = [n for n, p in tr.model.named_parameters() if p.requires_grad]
        return {"tr": tr, "pool": pool, "names": names}

    @staticmethod
    def counters(state):
        tr = state["tr"]
        return lambda: {"units": tr.step, **_kernel_counters()}

    @staticmethod
    def window(ctx, state, seconds, tracer, begin):
        """One ``train_epoch`` over the closed loop's feed, as the window
        runs it: its first three steps are set-up (they warm every shape
        up) and what the reference follows, with the next batches' host
        preparation and copies in flight as in every later step; the
        window opens once the third has run.  A wrapper on the Trainer's
        ``_step`` keeps each step's loss (no sync), AdamW's first moment
        after the first step and, after the third, the change of the
        trained parameters; a pre-hook on the head keeps the first step's
        features."""
        tr, n_cmp = state["tr"], Train.COMPARED
        feed = _Feed(state["pool"], seconds, tracer, Train.counters(state))
        live = [p for p in tr.model.parameters() if p.requires_grad]
        p0 = [p.detach().clone() for p in live]
        rec = QRSRecorder()
        feats, losses, grads = [], [], []
        key = ctx.config["model"]["type"]
        hook = getattr(tr.model, f"{key}_head").register_forward_pre_hook(
            lambda m, args: feats.append(args[0].detach()))
        orig = tr._step

        def step(dev):
            out = orig(dev)
            losses.append(out["total_loss"])
            if len(losses) == 1:  # AdamW's first moment after one step: 0.1 g
                hook.remove()
                grads.extend(tr.optimizer.state.get(p, {}).get(
                    "exp_avg", torch.zeros_like(p)) / 0.1 for p in live)
            if len(losses) == n_cmp:  # on the host: out of the window's peak
                rec.remove()
                state["grads"] = [g.cpu() for g in grads]
                state["change"] = [(p.detach() - q).cpu()
                                   for p, q in zip(live, p0)]
                grads.clear()
                p0.clear()
                feed.begin(begin())
            return out
        tr._step = step
        try:
            tr.train_epoch(feed)
        finally:
            del tr._step
            hook.remove()
            rec.remove()
        elapsed = time.perf_counter() - feed.t0
        state["losses"] = [float(v) for v in losses[:n_cmp]]
        state["feats"] = feats[0]
        state["rec_records"] = list(rec.records)
        timed = losses[n_cmp:]
        done = int(torch.isfinite(torch.stack(timed)).sum()) if timed else 0
        return {"attempted": len(timed), "done": done, "elapsed": elapsed,
                "pace": feed.pace()}

    @staticmethod
    def release(state):
        state.pop("tr", None)

    @staticmethod
    def judge(ctx, state, control=None):
        """The first three steps against the reference's from the same
        weights, batches and draws: the first step's backbone features
        (relative L2: ``feature_gap``), each step's loss (``loss1_gap``,
        ``loss_gap``), the first gradient (from AdamW's first moment after
        one step) and the parameters' change after three, leaf by leaf by
        norm (the worst leaf and the median leaf: ``grad_gap``,
        ``grad_gap_median``, ``change_gap``, ``change_gap_median``), and,
        where the model has QRS, its input and picks.  The reference
        follows the schedule's optimizer and loss; with the
        configuration's ``reference_rows`` it computes each step (and the
        control each of its own) in blocks of that many rows.  The
        configuration's ``limits`` say which of them are compared (PERF.md
        gives why)."""
        from ..reference.network import TrainStep, is_frozen
        from ..reference.precision import Float8Products

        _free(ctx.device)
        fields = ctx.mix["fields"]
        batches = [_device_batch(state["pool"][i], fields, ctx.device)
                   for i in range(Train.COMPARED)]
        sched = {**ctx.config["schedule"],
                 "steps_per_epoch": ctx.config["steps_per_epoch"]}
        rows = ctx.config.get("reference_rows")
        if control is not None:  # the control in the program's place
            net = _reference(ctx)
            sel = getattr(net.backbone, "selector", None)
            if sel is not None:
                sel.record = []
            step = TrainStep(net, sched, ctx.seed, ctx.device, rows)
            p0 = [p.detach().clone() for p in step.params]
            losses, grads = [], None
            for i, b in enumerate(batches):
                with Float8Products():
                    loss, g = step.step(b)
                losses.append(loss)
                if i == 0:
                    grads = [x.cpu() for x in g]
                    state["feats"] = step.features
            state["losses"], state["grads"] = losses, grads
            state["change"] = [(p.detach() - q).cpu()
                               for p, q in zip(step.params, p0)]
            state["names"] = [n for n, _ in net.named_parameters()
                              if not is_frozen(net.key, n)]
            state["rec_records"] = sel.record if sel is not None else []
            del net, step, p0
            _free(ctx.device)
        net = _reference(ctx)
        sel = getattr(net.backbone, "selector", None)
        if sel is not None:
            sel.follow = collections.deque(state["rec_records"])
        step = TrainStep(net, sched, ctx.seed, ctx.device, rows)
        names = [n for n, _ in net.named_parameters()
                 if not is_frozen(net.key, n)]
        if names != state["names"]:
            raise RuntimeError("the program trains other parameters than "
                               "the reference")
        p0 = [p.detach().clone() for p in step.params]
        losses, grads = [], None
        for i, b in enumerate(batches):
            loss, g = step.step(b)
            losses.append(loss)
            if i == 0:
                grads = g
                feat, theirs = step.features, state["feats"].float()
                fgap = (float((theirs - feat).norm() / feat.norm())
                        if theirs.shape == feat.shape else float("inf"))
        change = [p.detach() - q for p, q in zip(step.params, p0)]
        lg = [abs(a - b) / abs(b) for a, b in zip(state["losses"], losses)]
        out = {"feature_gap": fgap, "loss1_gap": lg[0], "loss_gap": max(lg)}
        # entries whose reference gradient is nought to rounding (a key's
        # bias under softmax, the head's last bias under the PLCC loss)
        # move under AdamW by round-off alone: left out by a rule on the
        # reference's gradient, under a thousandth of the median leaf's
        # (its root mean square entry), not by name
        rms = [float(g.norm()) / g.numel() ** 0.5 for g in grads]
        floor = 1e-3 * sorted(rms)[len(rms) // 2]
        masks = [(g.abs() >= floor).cpu() for g in grads]
        keep = [i for i, m in enumerate(masks) if bool(m.any())]
        kept = [names[i] for i in keep]

        def norm(t, i):
            return float(t.cpu()[masks[i]].norm())
        out["grad_gap"], out["grad_gap_median"] = leaf_gap(
            [norm(state["grads"][i], i) for i in keep],
            [norm(grads[i], i) for i in keep], kept, "grad_gap")
        out["change_gap"], out["change_gap_median"] = leaf_gap(
            [norm(state["change"][i], i) for i in keep],
            [norm(change[i], i) for i in keep], kept, "change_gap")
        if sel is not None:
            out["cls_attn_gap"] = sel.cls_attn_gap
            out["pick_errors"] = sel.pick_errors
        bad = sum(1 for v in state["losses"] if not v == v)
        return out, bad


def leaf_gap(got: list[float], want: list[float], names=None,
             what: str = "") -> tuple[float, float]:
    """(the worst leaf's, the median leaf's) |norm - reference norm| over
    the larger of its reference norm and the median leaf's; names the
    worst on stderr."""
    med = sorted(want)[len(want) // 2]
    gaps = [abs(a - b) / max(b, med) for a, b in zip(got, want)]
    i = max(range(len(gaps)), key=gaps.__getitem__)
    if names is not None:
        print(f"{what}: worst leaf {names[i]} norm {got[i]!r} against "
              f"{want[i]!r} (median leaf {med!r})", file=sys.stderr)
    return gaps[i], sorted(gaps)[len(gaps) // 2]


ENTRIES = {"score": Score, "train": Train}

"""KSVQE's train step replayed as CUDA graphs (nn/train_graphs.py, the train
capture of nn/eval_graphs.py's mechanism) on the Trainer's persistent
compute copies (train/trainer.py).

On the CPU: the persistent copies against the casts the Trainer made anew
every step (bit for bit, a tiny KSVQE and a tiny ``swin_tiny_grpb`` in
bf16), the rule that decides where the graphs engage and capture, and the
draws the graphed step makes eagerly.  On the card (marker ``cuda``; this
file imports no JAX), at ``portbench/configs/ksvqe.json``'s shapes and B=4,
a graphed Trainer against eager ones over three steps from one seed:

    python -m pytest --noconftest -m cuda tests/test_torch_train_graphs.py

On the card the backward is not deterministic run to run: the K4/K5
backward's weight and bias-table gradients and the bias gather's backward
sum with atomics, so two eager runs differ in the last bits of those
gradients, and from there in the parameters, moments and EMA.  Those are
held to agree as two eager runs agree; everything else is held bit for bit.
"""

import dataclasses
import json
import os
import types

import numpy as np
import pytest
import torch

from kvq_tpu_torch.models import vqa_network as VN
from kvq_tpu_torch.models.vqa_network import (build_train_model,
                                              tensor_compute_dtype)
from kvq_tpu_torch.nn import eval_graphs as EG
from kvq_tpu_torch.nn import train_graphs as TG
from kvq_tpu_torch.nn.regionnet import RegionSelector
from kvq_tpu_torch.ops import launches
from kvq_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY_BACKBONE = {
    "num_samples": 1, "sample_type": "topkpertubation", "tuning_stage": 1,
    "a1": 1.0, "a2": 2.0, "anchor_size": 8, "region_k": 9, "embed_dim": 16,
    "depths": [1, 1], "num_heads": [2, 2], "CLIP_location": 1,
    "window_size": [2, 7, 7], "checkpoint": False,
    "contrique_layers": [1, 1, 1, 1], "clip_layers": 2, "clip_width": 64,
    "clip_heads": 4, "use_pallas": True, "s2d_input": True,
    "drop_path_rate": 0.5,
}
# swin_tiny_grpb's preset cut for the CPU (as tests/test_torch_train_keys.py
# cuts it)
TINY_SWIN = dict(embed_dim=16, depths=(2, 2, 1, 1), num_heads=(2, 2, 4, 8),
                 window_size=(2, 7, 7), drop_path_rate=0.3)


def _tiny_ksvqe_config(dtype="bfloat16"):
    return {"name": "tiny", "warmup_epochs": 1, "num_epochs": 4,
            "model": {"type": "KSVQE", "compute_dtype": dtype, "args": {
                "KSVQE": {"backbone": dict(TINY_BACKBONE),
                          "head": {"hidden_channels": 16}}}}}


def _ksvqe_batches(n=3, B=4, frames=8):
    r = np.random.default_rng(5)
    return [{"fragment": r.standard_normal((B, frames // 2, 10, 10, 96),
                                           dtype=np.float32),
             "resize_video": r.standard_normal((B, frames, 32, 32, 3),
                                               dtype=np.float32),
             "label": r.standard_normal((B,), dtype=np.float32),
             "dis_label": (np.arange(B) % 2).astype(np.int32)}
            for _ in range(n)]


def _swin_batches(n=3, B=3):
    r = np.random.default_rng(6)
    return [{"technical": r.standard_normal((B, 8, 40, 40, 3),
                                            dtype=np.float32),
             "label": r.standard_normal((B,), dtype=np.float32)}
            for _ in range(n)]


class _PerStepCasts(Trainer):
    """The step as the Trainer cast before its copies persisted: fresh
    differentiable casts of the trainable masters every step, whose
    backward (``ToCopyBackward``) carries the gradients to the masters."""

    def _compute_tensors(self):
        return {**super()._compute_tensors(), **{
            n: p.to(tensor_compute_dtype(n, p, self.dtype, self._keep))
            for n, p in self.model.named_parameters() if p.requires_grad}}


def _trained(tr):
    return [p for p in tr.model.parameters() if p.requires_grad]


def _state(tr):
    live = _trained(tr)
    return {"masters": [p.detach().clone() for p in live],
            "grads": [p.grad.clone() for p in live],
            "exp_avg": [tr.optimizer.state[p]["exp_avg"].clone()
                        for p in live],
            "exp_avg_sq": [tr.optimizer.state[p]["exp_avg_sq"].clone()
                           for p in live],
            "ema": [e.clone() for e in tr.ema],
            "buffers": [b.clone() for b in tr.model.buffers()],
            "generator": [tr.gen.get_state()]}


def _same(a, b):
    return (a is None and b is None) or (
        a is not None and b is not None and a.dtype == b.dtype
        and a.shape == b.shape and torch.equal(a, b))


# ---------------------------------------------------------------- the CPU


@pytest.mark.parametrize("key", ["KSVQE", "swin_tiny_grpb"])
def test_persistent_copies_match_per_step_casts(key, monkeypatch):
    """Three steps on the persistent copies give the losses, the masters'
    gradients after each step, and the masters, AdamW's moments, the EMA,
    the buffers and the generator after three, of the per-step casts, bit
    for bit."""
    if key == "KSVQE":
        cfg, batches = _tiny_ksvqe_config(), _ksvqe_batches()
    else:
        real = VN.swin_config
        monkeypatch.setattr(VN, "swin_config", lambda k, bb: dataclasses.
                            replace(real(k, bb), **TINY_SWIN))
        cfg = {"name": "tiny_swin", "warmup_epochs": 1, "num_epochs": 4,
               "model": {"type": key, "compute_dtype": "bfloat16", "args": {
                   key: {"backbone": {"use_pallas": True},
                         "head": {"hidden_channels": 16}}}}}
        batches = _swin_batches()
    new = Trainer(cfg, device="cpu", seed=0, steps_per_epoch=2)
    old = _PerStepCasts(cfg, device="cpu", seed=0, steps_per_epoch=2)
    for b in batches:
        assert new.train_step(b) == old.train_step(b)
        for p, q in zip(_trained(new), _trained(old)):
            assert _same(p.grad, q.grad)
    assert new._cast and all(c.dtype == torch.bfloat16 and c.is_leaf
                             and c.requires_grad for _, c in new._cast)
    got, want = _state(new), _state(old)
    for k in want:
        assert all(_same(a, b) for a, b in zip(got[k], want[k])), k
    assert new.step == old.step == 3


def _tiny_backbone():
    return build_train_model(_tiny_ksvqe_config("float32"), "cpu",
                             seed=0).KSVQE_backbone


def _tiny_input(B=2):
    g = torch.Generator().manual_seed(0)
    return {"fragment": torch.randn((B, 4, 10, 10, 96), generator=g),
            "resize_video": torch.randn((B, 8, 32, 32, 3), generator=g),
            "dis_label": torch.arange(B, dtype=torch.int32) % 2}


@pytest.mark.parametrize("case,engages,captures", [
    ("eligible", True, [False, True, True]),
    ("eval", False, None), ("no_autograd", False, None), ("cpu", False, None),
    ("contrastive_group", False, None), ("synced_batchnorm", False, None),
    ("new_tensors_every_step", True, [False, False, False])])
def test_train_graphs_engage_and_capture_where_the_rule_says(
        case, engages, captures, monkeypatch):
    """A training module under autograd, on CUDA input, whose forward runs
    no collective, engages; eval, no autograd, the CPU, a gathered
    contrastive loss and a BatchNorm with a ``process_group`` decline.  It
    captures the second time a forward sees the same tensors, and holds the
    capture from then on; tensors new every step (as the (data, fsdp)
    step's) never capture."""
    made = []
    monkeypatch.setattr(TG.TrainCapture, "_capture",
                        lambda self, net, pool: made.append(self))
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", object)
    net = _tiny_backbone()
    if case == "eval":
        net.eval()
    elif case == "contrastive_group":
        monkeypatch.setattr(net, "contrastive_group", object(),
                            raising=False)
    elif case == "synced_batchnorm":
        bn = next(m for m in net.modules()
                  if isinstance(m, torch.nn.modules.batchnorm._BatchNorm))
        monkeypatch.setattr(bn, "process_group", object(), raising=False)
    batch = _tiny_input()
    seen = batch if case == "cpu" else {
        **batch, "fragment": types.SimpleNamespace(is_cuda=True)}
    with torch.set_grad_enabled(case != "no_autograd"):
        assert (EG.engages(net, seen) == "train") is engages
    if not engages:
        return
    graphs, got = EG.Graphs(TG.TrainCapture), []
    for _ in range(3):
        if case == "new_tensors_every_step":
            net.load_state_dict({k: v.clone() for k, v in
                                 net.state_dict().items()}, assign=True)
        got.append(graphs.capture_for(net, batch))
    assert [c is not None for c in got] == captures
    assert len(made) == int(any(captures))
    if any(captures):
        assert got[1] is got[2] is made[0] and got[1].holds()


def test_graphed_draws_follow_the_eager_order():
    """The draws a graphed step makes eagerly (QRS's, then every block's
    DropPath multipliers in block order, ``drop_path_draws``) are those the
    eager trunk draws block by block: the same features and loss, and the
    generator left in the same state.  ``pick_stand_in`` has the shape and
    dtype of a training pick."""
    net = _tiny_backbone()
    x = _tiny_input()
    out, states = [], []
    for eager in (True, False):
        gen = torch.Generator().manual_seed(3)
        frag, cls_attn, pat = net.semantic_segment(x["fragment"],
                                                   x["resize_video"])
        sel = net.pick(cls_attn, frag, gen)
        stand_in = net.pick_stand_in(cls_attn, frag)
        assert (stand_in.shape, stand_in.dtype) == (sel.shape, sel.dtype)
        assert stand_in.requires_grad and stand_in.is_leaf
        if eager:
            out.append(net.trunk_segment(frag, sel, pat, x["dis_label"],
                                         gen))
        else:
            dps = net.drop_path_draws(frag.shape[0], gen, frag.device)
            assert any(d is not None for s in dps for p in s for d in p)
            out.append(net.trunk_segment(frag, sel, pat, x["dis_label"],
                                         dps=dps))
        states.append(gen.get_state())
    assert all(torch.equal(a, b) for a, b in zip(*out))
    assert torch.equal(*states)


# --------------------------------------------------------------- the card

def _shipped_config(use_pallas=True) -> dict:
    with open(os.path.join(REPO, "portbench", "configs", "ksvqe.json")) as f:
        c = json.load(f)
    c["model"]["args"]["KSVQE"]["backbone"]["use_pallas"] = use_pallas
    return {"name": "ksvqe", "model": c["model"], **c["schedule"]}


def _shipped_batches():
    """Three distinct host batches of ``ksvqe-train-b4-pool4``'s shapes."""
    r = np.random.default_rng(7)
    return [{"fragment": r.standard_normal((4, 16, 72, 72, 96),
                                           dtype=np.float32),
             "resize_video": r.standard_normal((4, 32, 112, 112, 3),
                                               dtype=np.float32),
             "label": r.standard_normal((4,), dtype=np.float32),
             "dis_label": r.integers(0, 4, (4,)).astype(np.int32)}
            for _ in range(3)]


def _observe(cfg, batches, graphs):
    """Three steps of a Trainer from seed 0: each step's loss terms, kernel
    calls and generator state, the head's input of step 1 (a pre-hook, no
    copy), QRS's (cls_attn, pick) of each step (``select`` patched, no
    copy), then the state after three."""
    EG._ENABLED = graphs
    feats, picks, losses, calls, gens = [], [], [], [], []
    orig = RegionSelector.select

    def select(sel, cls_attn, *args, **kwargs):
        out = orig(sel, cls_attn, *args, **kwargs)
        picks.append((cls_attn, out))
        return out
    RegionSelector.select = select
    try:
        tr = Trainer(cfg, device="cuda", seed=0, steps_per_epoch=500)
        hook = tr.model.KSVQE_head.register_forward_pre_hook(
            lambda m, args: feats.append(args[0]))
        for b in batches:
            before = launches.snapshot()
            losses.append(tr.train_step(b))
            calls.append(dict(zip(launches.NAMES, launches.diff(
                before, launches.snapshot()))))
            gens.append(tr.gen.get_state())
            if len(gens) == 1:
                grads1 = [p.grad.clone() for p in _trained(tr)]
        hook.remove()
    finally:
        RegionSelector.select = orig
        EG._ENABLED = True
    torch.cuda.synchronize()
    caps = tr.model.KSVQE_backbone._graphs["train"]._captures
    return {"losses": losses, "feats": feats, "picks": picks,
            "calls": calls, "gens": gens, "state": _state(tr),
            "grads1": grads1, "names": [n for n, p in tr.model.named_parameters()
                                        if p.requires_grad],
            "captures": list(caps.values()),
            "reserved": torch.cuda.memory_reserved()}


@pytest.fixture(scope="module")
def runs():
    """Two eager Trainers and a graphed one, three steps each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    cfg, batches = _shipped_config(), _shipped_batches()
    return [_observe(cfg, batches, g) for g in (False, False, True)]


def _gap(a, b) -> float:
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _agree(graphed, eager1, eager2, what):
    """Bit for bit where the two eager runs are; elsewhere the graphed
    run's worst relative gap to the first eager run is within 10x the eager
    runs' own worst gap (the worst of three runs' pairwise gaps lies within
    a few times another's; a wrong draw or a stale gradient moves a
    parameter by a thousandth or more, ten times the widest eager gap).
    Prints each category's gaps."""
    for k in eager1:
        pairs = list(zip(graphed[k], eager1[k], eager2[k]))
        ee = max(_gap(b, c) for _, b, c in pairs)
        ge = max(_gap(a, b) for a, b, _ in pairs)
        odd = sum(not torch.equal(b, c) for _, b, c in pairs)
        print(f"{what} {k}: {len(pairs)} tensors, {odd} unequal eager to "
              f"eager, worst gap eager {ee:.3g}, graphed {ge:.3g}")
        if ee == 0.0:
            assert all(torch.equal(a, b) for a, b, _ in pairs), (what, k)
        else:
            assert ge <= 10 * ee, (what, k, ge, ee)


@pytest.mark.cuda
def test_graphed_steps_agree_with_eager(runs):
    """Step 1's loss terms, head input and QRS records, every step's
    generator state (the capture, in step 2, draws nothing from it) and
    the buffers: bit for bit.  The later losses and picks, the masters and
    their gradients, ``exp_avg``, ``exp_avg_sq`` and the EMA: as two eager
    runs agree (the module docstring says why)."""
    e1, e2, g = runs
    assert len(g["captures"]) == 1 and not e1["captures"]
    assert g["losses"][0] == e1["losses"][0] == e2["losses"][0]
    assert _same(g["feats"][0], e1["feats"][0])
    for i in range(3):
        (gc, gp), (ec, ep) = g["picks"][i], e1["picks"][i]
        if i == 0:
            assert _same(gc, ec) and _same(gp, ep)
        assert torch.equal(g["gens"][i], e1["gens"][i]), i
    _agree({"losses": [torch.tensor(list(s.values())) for s in g["losses"]],
            "picks": [p for c in g["picks"] for p in c]},
           {"losses": [torch.tensor(list(s.values())) for s in e1["losses"]],
            "picks": [p for c in e1["picks"] for p in c]},
           {"losses": [torch.tensor(list(s.values())) for s in e2["losses"]],
            "picks": [p for c in e2["picks"] for p in c]}, "steps")
    _agree(g["state"], e1["state"], e2["state"], "after three steps")
    odd = [n for n, a, b in zip(e1["names"], e1["grads1"], e2["grads1"])
           if not torch.equal(a, b)]
    print(f"step 1's gradients unequal eager to eager: {len(odd)} of "
          f"{len(e1['names'])}: {odd}")
    _agree({"grads1": g["grads1"]}, {"grads1": e1["grads1"]},
           {"grads1": e2["grads1"]}, "step 1")
    print("memory reserved: eager", e1["reserved"], "graphed", g["reserved"])


@pytest.mark.cuda
def test_observers_get_fresh_tensors(runs):
    """The head's input, QRS's cls-attention and pick: distinct tensors of
    each step, none of them on a capture's static storage."""
    g = runs[2]
    cap = g["captures"][0]
    static = {t.untyped_storage().data_ptr() for t in (
        cap.features, cap.loss, cap.cls_attn, cap.sel, cap.fragment, cap.pat,
        *cap.inputs.values(), *cap.grad_out_a, *cap.grad_out_b)}
    kept = [t.untyped_storage().data_ptr() for t in (
        *g["feats"], *(c for c, _ in g["picks"]), *(p for _, p in g["picks"]))]
    assert len(set(kept)) == len(kept) == 9
    assert not set(kept) & static


@pytest.mark.cuda
def test_replayed_steps_count_the_kernel_calls(runs):
    """K4 10 forward and 10 backward calls a step, K5 2 and 2, graphed or
    eager, and no other kernel: the capture's own calls are not counted."""
    want = dict.fromkeys(launches.NAMES, 0)
    want.update(train_swin_block=10, train_swin_block_bwd=10,
                window_attention_train=2, window_attention_train_bwd=2)
    for r in runs:
        assert r["calls"] == [want] * 3


@pytest.mark.cuda
def test_plain_path_captures_too(runs):
    """``use_pallas: false`` (no kernel of the port's) captures and agrees
    with its eager steps as two eager runs agree."""
    cfg, batches = _shipped_config(use_pallas=False), _shipped_batches()
    e1, e2, g = (_observe(cfg, batches, graphs)
                 for graphs in (False, False, True))
    assert len(g["captures"]) == 1
    assert g["losses"][0] == e1["losses"][0]
    assert all(torch.equal(a, b) for a, b in zip(g["gens"], e1["gens"]))
    _agree(g["state"], e1["state"], e2["state"], "plain, after three steps")

"""KSVQE's eval forward replayed as two CUDA graphs (nn/eval_graphs.py, the
eval capture of the graph mechanism).

On the CPU: the rule that decides where the graphs engage, the captures'
bookkeeping (one per input signature, dropped when the module's tensors
move) and the eager forward's one QRS pick per forward.  On the card
(marker ``cuda``; this file imports no JAX), at the shipped score shapes on
seeded weights, the graphed forward against the eager one:

    python -m pytest --noconftest -m cuda tests/test_torch_graphs.py
"""

import json
import os
import types

import pytest
import torch

from kvq_tpu_torch.core import tracing
from kvq_tpu_torch.models.vqa_network import build_model
from kvq_tpu_torch.nn import eval_graphs as EG
from kvq_tpu_torch.nn.regionnet import RegionSelector
from kvq_tpu_torch.ops import launches
from kvq_tpu_torch.ops import window_attention as WA

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY_BACKBONE = {
    "num_samples": 1, "sample_type": "topkpertubation", "tuning_stage": 1,
    "a1": 1.0, "a2": 2.0, "anchor_size": 8, "region_k": 9, "embed_dim": 16,
    "depths": [1, 1], "num_heads": [2, 2], "CLIP_location": 1,
    "window_size": [2, 7, 7], "checkpoint": False,
    "contrique_layers": [1, 1, 1, 1], "clip_layers": 2, "clip_width": 64,
    "clip_heads": 4, "use_pallas": True, "s2d_input": True,
}


def _tiny_model():
    cfg = {"name": "tiny", "model": {
        "type": "KSVQE", "compute_dtype": "float32",
        "args": {"KSVQE": {"backbone": dict(TINY_BACKBONE),
                           "head": {"hidden_channels": 16}}}}}
    return build_model(cfg, device="cpu", seed=0).eval()


def _tiny_batch(seed=0, frames=8):
    g = torch.Generator().manual_seed(seed)
    return {"fragment": torch.randn((1, frames // 2, 10, 10, 96),
                                    generator=g),
            "resize_video": torch.randn((1, frames, 32, 32, 3), generator=g),
            "dis_label": torch.zeros((1,), dtype=torch.int32)}


# ---------------------------------------------------------------- the CPU


def _on_card(batch):
    """``batch`` with a fragment that says it lies on the card."""
    return {**batch, "fragment": types.SimpleNamespace(is_cuda=True)}


@pytest.mark.parametrize("case,engages", [
    ("eligible", True), ("cpu", False), ("training", False),
    ("grad", False), ("contrastive_group", False), ("disabled", False)])
def test_graphs_engage_only_where_the_rule_says(case, engages, monkeypatch):
    """An eval module under no autograd, on CUDA input, with no contrastive
    group; the CPU, training, autograd, a gathered loss and the private
    switch decline."""
    net = _tiny_model().KSVQE_backbone
    batch = _tiny_batch() if case == "cpu" else _on_card(_tiny_batch())
    if case == "training":
        net.train()
    if case == "contrastive_group":
        monkeypatch.setattr(net, "contrastive_group", object(),
                            raising=False)
    if case == "disabled":
        monkeypatch.setattr(EG, "_ENABLED", False)
    with torch.set_grad_enabled(case == "grad"):
        assert (EG.engages(net, batch) == "eval") is engages


@pytest.mark.parametrize("change,recaptured,kept", [
    ("none", False, 1), ("signature", True, 2), ("load_in_place", False, 1),
    ("assign", True, 1), ("to_dtype", True, 1)])
def test_captures_follow_signature_and_tensors(change, recaptured, kept,
                                               monkeypatch):
    """One capture per input signature; weights loaded in place keep it; a
    parameter replaced (``assign=True``) or moved (``.to()``) drops every
    capture and the next forward captures anew.  A module's captures share
    one memory pool, opened anew once every capture was dropped."""
    made = []
    monkeypatch.setattr(EG.EvalCapture, "_capture",
                        lambda self, net, pool: made.append((self, pool)))
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", object)
    net = _tiny_model().KSVQE_backbone
    graphs, batch = EG.Graphs(EG.EvalCapture), _tiny_batch()
    first = graphs.capture_for(net, batch)
    assert first.holds() and [c for c, _ in made] == [first]
    if change == "signature":
        batch = _tiny_batch(frames=16)
    elif change == "load_in_place":
        sd = {k: v + 1 for k, v in net.state_dict().items()
              if v.is_floating_point()}
        net.load_state_dict(sd, strict=False)
    elif change == "assign":
        net.load_state_dict({k: v.clone() for k, v in
                             net.state_dict().items()}, assign=True)
    elif change == "to_dtype":
        net.to(torch.float64)
    again = graphs.capture_for(net, batch)
    assert (again is not first) is recaptured
    assert len(made) == 1 + recaptured
    assert len(graphs._captures) == kept
    assert graphs.capture_for(net, batch) is again  # held from now on
    if recaptured:  # a second signature shares the pool; a new start not
        assert (made[1][1] is made[0][1]) is (change == "signature")


@pytest.mark.parametrize("train", [False, True])
def test_eager_forward_picks_once_per_forward(train, monkeypatch):
    """The split forward calls ``RegionSelector.select`` once a forward,
    on the cls-attention of that forward's keyframes."""
    calls = []
    orig = RegionSelector.select

    def select(sel, cls_attn, *args, **kwargs):
        calls.append(cls_attn.shape)
        return orig(sel, cls_attn, *args, **kwargs)
    monkeypatch.setattr(RegionSelector, "select", select)
    model = _tiny_model().train(train)
    gen = torch.Generator().manual_seed(0)
    with torch.set_grad_enabled(train):
        for seed in range(2):
            model(_tiny_batch(seed), reduce_scores=True, gen=gen)
    assert calls == [torch.Size([1, 4, 4])] * 2


# --------------------------------------------------------------- the card


def _shipped_model_config() -> dict:
    with open(os.path.join(REPO, "portbench", "configs", "ksvqe.json")) as f:
        return {"name": "ksvqe", "model": json.load(f)["model"]}


@pytest.fixture(scope="module")
def shipped():
    """The shipped KSVQE (portbench/configs/ksvqe.json) on seeded weights
    in eval mode, and three distinct score batches of its val view."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    dev = torch.device("cuda")
    model = build_model(_shipped_model_config(), dev, seed=0).eval()
    g = torch.Generator(device=dev).manual_seed(1)
    batches = [{
        "fragment": torch.randn((1, 48, 72, 72, 96), generator=g,
                                device=dev).to(torch.bfloat16),
        "resize_video": torch.randn((1, 96, 112, 112, 3), generator=g,
                                    device=dev).to(torch.bfloat16),
        "dis_label": torch.randint(0, 4, (1,), generator=g, device=dev,
                                   dtype=torch.int32)} for _ in range(3)]
    return model, batches


def _observe(model, batches, graphs, monkeypatch):
    """Each forward's scores, the head's input (a pre-hook keeping
    ``args[0]``, no copy) and QRS's (cls_attn, pick) (``select`` patched on
    the class, no copy), all read after the last forward."""
    feats, picks = [], []
    orig = RegionSelector.select

    def select(sel, cls_attn, *args, **kwargs):
        out = orig(sel, cls_attn, *args, **kwargs)
        picks.append((cls_attn, out))
        return out
    monkeypatch.setattr(RegionSelector, "select", select)
    monkeypatch.setattr(EG, "_ENABLED", graphs)
    hook = model.KSVQE_head.register_forward_pre_hook(
        lambda m, args: feats.append(args[0]))
    try:
        with torch.no_grad():
            scores = [model(b, reduce_scores=True)[0] for b in batches]
    finally:
        hook.remove()
        monkeypatch.undo()
    torch.cuda.synchronize()
    return scores, feats, picks


def _capture(model, batch):
    return model.KSVQE_backbone._graphs["eval"]._captures[
        EG.signature(batch)]


@pytest.fixture(scope="module")
def observed(shipped):
    model, batches = shipped
    mp = pytest.MonkeyPatch()
    eager = _observe(model, batches, False, mp)
    graphed = _observe(model, batches, True, mp)
    return eager, graphed, _capture(model, batches[0])


def _equal(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
def test_graphed_forward_is_bit_equal_to_eager(observed):
    """Scores, features and QRS's inputs and picks over three batches."""
    (es, ef, ep), (gs, gf, gp), _ = observed
    assert len(ep) == len(gp) == len(gf) == len(ef) == 3
    for i in range(3):
        assert _equal(gs[i], es[i]), i
        assert _equal(gf[i], ef[i]), i
        assert _equal(gp[i][0], ep[i][0]) and _equal(gp[i][1], ep[i][1]), i
    assert not _equal(gs[0], gs[1])  # three distinct batches


@pytest.mark.cuda
def test_plain_path_graphed_forward_is_bit_equal_to_eager(shipped):
    """The same weights with ``use_pallas`` off (the plain path, no kernel
    of the port's: what chip_smoke and ``cli.test`` hold the kernels
    against) capture too: its device constants are cached, none uploaded
    while capturing, and its scores, features and picks over three batches
    equal the eager ones."""
    model, batches = shipped
    cfg = _shipped_model_config()
    cfg["model"]["args"]["KSVQE"]["backbone"]["use_pallas"] = False
    plain = build_model(cfg, torch.device("cuda"),
                        state_dict=model.state_dict()).eval()
    mp = pytest.MonkeyPatch()
    (es, ef, ep) = _observe(plain, batches, False, mp)
    (gs, gf, gp) = _observe(plain, batches, True, mp)
    assert list(plain.KSVQE_backbone._graphs["eval"]._captures) == [
        EG.signature(batches[0])]
    for i in range(3):
        assert _equal(gs[i], es[i]), i
        assert _equal(gf[i], ef[i]), i
        assert _equal(gp[i][0], ep[i][0]) and _equal(gp[i][1], ep[i][1]), i
    assert not _equal(gs[0], gs[1])


@pytest.mark.cuda
def test_hooks_see_fresh_tensors_of_each_forward(observed):
    """What the head's pre-hook and the patched ``select`` keep are
    distinct tensors a forward, none of them a capture's static buffer."""
    _, (_, feats, picks), cap = observed
    static = {t.untyped_storage().data_ptr() for t in (
        cap.features, cap.loss, cap.cls_attn, cap.pick, cap.fragment,
        cap.pat, *cap.inputs.values())}
    kept = [t.untyped_storage().data_ptr()
            for t in (*feats, *(c for c, _ in picks), *(p for _, p in picks))]
    assert len(set(kept)) == len(kept) == 9
    assert not set(kept) & static


@pytest.mark.cuda
def test_replays_count_the_captured_kernel_calls(shipped, observed):
    """K1 12 and K2 9 a replay, as an eager forward counts them."""
    model, batches = shipped
    counts = []
    with torch.no_grad():
        for graphs in (False, True, True):
            EG._ENABLED = graphs
            try:
                before = launches.snapshot()
                model(batches[0], reduce_scores=True)
            finally:
                EG._ENABLED = True
            counts.append(launches.diff(before, launches.snapshot()))
    assert counts == [_calls(12, 9)] * 3


def _calls(k1, k2) -> list:
    """The ledger's counts with ``k1`` K1 and ``k2`` K2 calls, no other."""
    want = [0] * len(launches.NAMES)
    want[launches.wrappers().index(WA.fused_swin_block)] = k1
    want[launches.wrappers().index(WA.flash_attention_nobias_cl)] = k2
    return want


def _scores(model, batches, graphs):
    EG._ENABLED = graphs
    try:
        with torch.no_grad():
            return [model(b, reduce_scores=True)[0].float() for b in batches]
    finally:
        EG._ENABLED = True


@pytest.mark.cuda
def test_weights_loaded_in_place_reach_the_replay(shipped, observed):
    """``load_state_dict`` copies into the captured parameters: the graphed
    scores move exactly as the eager ones, with no new capture."""
    model, batches = shipped
    cap = _capture(model, batches[0])
    old = {k: v.clone() for k, v in model.state_dict().items()}
    before = _scores(model, batches, True)
    try:
        model.load_state_dict({  # every norm of CLIP, the Swin stages...
            k: v + 0.5 if ".norm" in k or ".ln" in k else v
            for k, v in old.items()})
        graphed = _scores(model, batches, True)
        eager = _scores(model, batches, False)
        assert _capture(model, batches[0]) is cap
    finally:
        model.load_state_dict(old)
    assert all(_equal(g, e) for g, e in zip(graphed, eager)), (graphed,
                                                                eager)
    assert not any(_equal(g, b) for g, b in zip(graphed, before)), (
        graphed, before)
    assert all(_equal(g, b) for g, b in
               zip(_scores(model, batches, True), before))


@pytest.mark.cuda
def test_replaced_tensors_cause_a_new_capture(shipped, observed):
    """``load_state_dict(assign=True)`` puts new tensors in the module: the
    next forward captures anew and still equals the eager forward.  The
    capture's own calls (its eager warm-up and the capture) are not counted
    as launches: three forwards count 3 x (12 K1 + 9 K2)."""
    model, batches = shipped
    cap = _capture(model, batches[0])
    model.load_state_dict({k: v.clone() for k, v in
                           model.state_dict().items()}, assign=True)
    before = launches.snapshot()
    graphed = _scores(model, batches, True)
    counted = launches.diff(before, launches.snapshot())
    assert _capture(model, batches[0]) is not cap
    assert counted == _calls(12 * 3, 9 * 3)
    assert len(model.KSVQE_backbone._graphs["eval"]._captures) == 1
    eager = _scores(model, batches, False)
    assert all(_equal(g, e) for g, e in zip(graphed, eager))


@pytest.mark.cuda
def test_training_or_autograd_forwards_replay_nothing(shipped, observed):
    """A train-mode forward and a grad-enabled eval forward run eagerly:
    no ``kvq.graph.replay``; an eval forward without autograd records
    one, with ``segments=2``."""
    model, batches = shipped
    grads = [p.requires_grad for p in model.parameters()]
    since = tracing.mark()
    try:
        with tracing.recording():
            with torch.no_grad():
                model.train()
                model(batches[0], reduce_scores=True,
                      gen=torch.Generator(device="cuda").manual_seed(0))
                model.eval()
            for p in model.parameters():  # the eval kernels refuse autograd
                p.requires_grad_(False)
            with torch.enable_grad():
                model(batches[0], reduce_scores=True)
            assert "kvq.graph.replay" not in tracing.summary(since)
            with torch.no_grad():
                model(batches[0], reduce_scores=True)
    finally:
        model.eval()
        for p, g in zip(model.parameters(), grads):
            p.requires_grad_(g)
    replays = [s for s in tracing.spans(since)
               if s["name"] == "kvq.graph.replay"]
    assert [s["attrs"] for s in replays] == [{"segments": 2}]

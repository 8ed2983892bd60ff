"""The port's train surface beyond KSVQE, against the JAX package: the
Swin-T-3D keys through ``Trainer``, remat, the QRS sample types, reference
checkpoint loading and the best-weights bookkeeping.

Inputs are seeded numpy; JAX runs on the CPU, its train kernels in Pallas
interpret mode when ``use_pallas`` is set; the port's wrappers run their
plain versions on CPU tensors.  Everything is float32.  The Swin keys are
built at tiny widths by cutting the port's presets (``tiny_swin``) exactly
as the JAX side cuts its own.  Tolerances:

  - a Swin-key train step: loss rtol 1e-5, every gradient within 2e-4 of
    its scale (``_grad_close``: f32 roundoff through ~20 layers and their
    backward, summed in another order);
  - remat on against off: bit-equal (the same operations on the same
    inputs, recomputed);
  - the QRS indicators: equal; the Gumbel straight-through gradient rtol
    1e-5 (one softmax);
  - scores after a checkpoint load: atol 1e-5, as the eval parity tests.
"""

import dataclasses
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import kvq_tpu.ops.window_attention as WA
from kvq_tpu.core import checkpoint as JC
from kvq_tpu.core.torch_import import (
    convert_swin3d,
    convert_vqa_head,
    strip_module_prefix,
)
from kvq_tpu.nn import regionnet as JR
from kvq_tpu.nn import swin as JS
from kvq_tpu.nn.heads import VQAHead as JVQAHead
from kvq_tpu.ops import topk as JT
from kvq_tpu.train import losses as JL
from kvq_tpu.train.trainer import Trainer as JTrainer
from kvq_tpu_torch.core.checkpoint import load_checkpoint, merge_state_dict
from kvq_tpu_torch.core.from_jax import state_dict_from_jax
from kvq_tpu_torch.models import vqa_network as VN
from kvq_tpu_torch.nn import regionnet as R
from kvq_tpu_torch.nn import swin as S
from kvq_tpu_torch.ops import topk as T
from kvq_tpu_torch.train import losses as L
from kvq_tpu_torch.train.evaluator import Evaluator
from kvq_tpu_torch.train.trainer import Trainer

from test_torch_modules import _batch, tiny_config
from test_torch_swin_keys import _jax_model
from test_torch_train import _grad_close, _packed_batch

# the presets' widths cut for the CPU, on both sides
TINY = dict(embed_dim=16, depths=(2, 2, 1, 1), num_heads=(2, 2, 4, 8),
            window_size=(2, 7, 7))
# (B, T, H, W, 3) technical views: stage 0 at 4x10x10 tokens pads to
# 4x14x14 (the K5 route); at 4x14x14 every stage is pad-free (K4)
PADDED, PAD_FREE = (3, 8, 40, 40, 3), (3, 8, 56, 56, 3)


@pytest.fixture
def tiny_swin(monkeypatch):
    """Call with a DropPath rate: the port's networks are then built with
    every Swin preset cut to TINY at that rate."""
    real = S.swin_config

    def cut(rate=0.0):
        monkeypatch.setattr(VN, "swin_config", lambda key, bb: dataclasses.
                            replace(real(key, bb), drop_path_rate=rate,
                                    **TINY))
    return cut


def swin_cfg(key, use_pallas, checkpoint=None, **top):
    bb = {"use_pallas": use_pallas}
    if checkpoint is not None:
        bb["checkpoint"] = checkpoint
    return {"name": f"tiny_{key}", **top, "model": {
        "type": key, "compute_dtype": "float32",
        "args": {key: {"backbone": bb, "head": {"hidden_channels": 16}}}}}


def jax_cfg(key, use_pallas, rate=0.0):
    return dataclasses.replace(
        JS.swin_config(key, {"use_pallas": use_pallas, "checkpoint": False}),
        drop_path_rate=rate, **TINY)


def technical_batch(shape=PADDED, seed=0):
    r = np.random.default_rng(seed)
    return {"technical": r.normal(size=shape).astype(np.float32),
            "label": r.normal(size=shape[:1]).astype(np.float32)}


def _write(path, sd):
    torch.save({"state_dict": sd}, path)
    return str(path)


# ---------------------------------------------------------------------------
# Swin-key training against the JAX package


@pytest.mark.parametrize("shape", [PADDED, PAD_FREE],
                         ids=["padded", "pad_free"])
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("key", ["swin_tiny_grpb", "swin_tiny"])
def test_swin_key_train_step_matches_jax(key, use_pallas, shape, tiny_swin,
                                         tmp_path):
    """One Trainer step of a tiny Swin key (DropPath 0, the head without
    dropout, as the JAX head in eval) from weights given by ``load_path``:
    the loss and every gradient against jax.grad of the JAX trunk + head.
    The port trains with remat (its default, as JAX's); with use_pallas the
    JAX side runs its train kernels in interpret mode."""
    tiny_swin()
    batch = technical_batch(shape)
    jcfg = jax_cfg(key, use_pallas)
    params, hp, _ = _jax_model(jcfg, batch["technical"])

    model = JS.SwinTransformer3D(config=jcfg, dtype=jnp.float32)
    head = JVQAHead(hidden_channels=16)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        feat = model.apply({"params": p["b"]}, jb, train=True,
                           rngs={"dropout": jax.random.key(0)})
        s = head.apply({"params": p["h"]}, feat, train=False)
        return JL.total_loss([s], jb["label"], None, 0.3, 0.0)[0]

    flags = (WA.ALLOW_CPU_PALLAS, WA.TRAIN_INTERPRET)
    WA.ALLOW_CPU_PALLAS = WA.TRAIN_INTERPRET = use_pallas
    try:
        ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(
            {"b": params, "h": hp})
    finally:
        WA.ALLOW_CPU_PALLAS, WA.TRAIN_INTERPRET = flags

    path = _write(tmp_path / "w.pth", state_dict_from_jax(
        {f"{key}_backbone": params, f"{key}_head": hp}))
    tr = Trainer(swin_cfg(key, use_pallas, load_path=path), device="cpu")
    getattr(tr.model, f"{key}_head").dropout_ratio = 0.0
    assert all(p.requires_grad for p in tr.params)  # nothing is frozen
    aux = tr.train_step(batch)
    assert set(aux) == {"plcc_loss_0", "total_loss"}  # no contrastive term
    np.testing.assert_allclose(aux["total_loss"], float(ref_loss), rtol=1e-5)

    grads = {n: p.grad.numpy() for n, p in tr.model.named_parameters()}
    got = convert_swin3d(grads, depths=jcfg.depths,
                         frag_biases=jcfg.frag_biases,
                         prefix=f"{key}_backbone.", trunk_key="trunk")
    got_h = convert_vqa_head(grads, prefix=f"{key}_head.")
    for want, have in ((ref_grads["b"], got), (ref_grads["h"], got_h)):
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        flat_g = dict(jax.tree_util.tree_flatten_with_path(have)[0])
        assert len(flat_w) == len(flat_g)
        for p, w in flat_w:
            _grad_close(flat_g[p], w, jax.tree_util.keystr(p))


# ---------------------------------------------------------------------------
# remat


@pytest.mark.parametrize("key", ["swin_tiny_grpb", "KSVQE"])
def test_remat_on_and_off_agree(key, tiny_swin, monkeypatch):
    """A kernel-route train step with remat on and off, DropPath 0.1: the
    same loss, gradients and generator state after the step; with remat on
    every block runs under the checkpoint.  The Swin key computes in bf16,
    so the recompute must run on the trainer's bf16 copies, not on the f32
    masters."""
    tiny_swin(0.1)
    calls = []

    def counted(*a, **k):
        calls.append(1)
        return torch.utils.checkpoint.checkpoint(*a, **k)

    monkeypatch.setattr(S, "checkpoint", counted)
    runs = []
    for remat in (True, False):
        if key == "KSVQE":
            cfg = tiny_config(use_pallas=True, s2d_input=True,
                              checkpoint=remat)
            batch = _packed_batch(B=4, T=8, seed=1)
        else:
            cfg = swin_cfg(key, True, checkpoint=remat)
            cfg["model"]["compute_dtype"] = "bfloat16"
            batch = technical_batch((4, 8, 40, 40, 3), seed=1)
        tr = Trainer(cfg, device="cpu", seed=0)
        backbone = getattr(tr.model, f"{key}_backbone")
        n_blocks = sum(len(st.blocks) for st in backbone.layers)
        del calls[:]
        aux = tr.train_step(batch)
        assert len(calls) == (n_blocks if remat else 0)
        runs.append((aux, [p.grad.clone() for p in tr.params
                           if p.requires_grad], tr.gen.get_state()))
    (aux_on, g_on, s_on), (aux_off, g_off, s_off) = runs
    assert aux_on == aux_off
    for a, b in zip(g_on, g_off):
        assert torch.equal(a, b)
    assert torch.equal(s_on, s_off)


def test_remat_follows_the_backbone_config():
    """``checkpoint`` in the backbone config turns remat off; without it
    remat is on, as JAX's SwinConfig and KSVQEConfig default."""
    from kvq_tpu.nn.ksvqe import ksvqe_config as jksvqe_config
    from kvq_tpu_torch.nn.ksvqe import ksvqe_config

    for bb in ({}, {"checkpoint": False}, {"checkpoint": True}):
        assert S.swin_config("swin_tiny_grpb", bb).use_checkpoint == \
            JS.swin_config("swin_tiny_grpb", dict(bb)).use_checkpoint
        assert ksvqe_config(bb).use_checkpoint == \
            jksvqe_config(bb).use_checkpoint
    net = VN.VQANetwork(tiny_config(checkpoint=True))
    assert all(st.use_checkpoint for st in net.KSVQE_backbone.layers)


# ---------------------------------------------------------------------------
# QRS sample types


def _jax_draw(sample_type, key, b, d):
    """The random numbers JAX's select draws from ``key``
    (kvq_tpu/nn/regionnet.py:185-206, ops/topk.py:64-72)."""
    if sample_type == "gumbel":
        return np.asarray(jax.random.uniform(key, (b, d)))
    if sample_type == "multinomial":
        return np.asarray(jax.random.gumbel(key, (b, d), jnp.float32))
    return np.asarray(jax.random.randint(key, (b,), 0, d))


@pytest.mark.parametrize("sample_type", ["gumbel", "multinomial", "random"])
def test_qrs_sample_types_match_jax(sample_type):
    """With JAX's draws handed in, the port's training selection (B, T, nR)
    equals JAX's; the Gumbel straight-through gradient equals JAX's; and a
    tiny KSVQE of the sample type trains a step on its own draws."""
    B, n_key, t = 3, 4, 8
    rng = np.random.default_rng(0)
    cls = rng.random((B, n_key, 49)).astype(np.float32)
    _, group_id = R.keyframe_schedule(t)
    grid = (5, 5)  # 3x3 regions of a 5x5 anchor grid: nR = 9
    key = jax.random.key(7)
    jsel = JR.RegionSelector(k=9, anchor_size=8, num_samples=1,
                             sample_type=sample_type)
    want = np.asarray(jsel.select(jnp.asarray(cls), group_id, grid,
                                  train=True, key=key))
    draw = _jax_draw(sample_type, key, B * n_key, 9)
    sel = R.RegionSelector(k=9, anchor_size=8, sample_type=sample_type)
    sel.draw = lambda scores, gen: torch.from_numpy(draw.copy())
    got = sel.select(torch.from_numpy(cls), group_id, grid, train=True)
    assert got.shape == want.shape == (B, t, 9)
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(np.unique(want)) <= {0.0, 1.0}

    if sample_type == "gumbel":
        x = rng.random((5, 9)).astype(np.float32)
        g = rng.normal(size=(5, 1, 9)).astype(np.float32)
        u = np.array(jax.random.uniform(key, x.shape))
        ref_g = jax.grad(lambda a: jnp.vdot(
            JT.gumbel_topk_indicator(a, key), g))(jnp.asarray(x))
        xt = torch.from_numpy(x).requires_grad_()
        ind = T.gumbel_topk_indicator(xt, torch.from_numpy(u))
        np.testing.assert_array_equal(
            ind.detach().numpy(),
            np.asarray(JT.gumbel_topk_indicator(jnp.asarray(x), key)))
        (ind * torch.from_numpy(g)).sum().backward()
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_g),
                                   rtol=1e-5, atol=1e-7)

    net = VN.VQANetwork(tiny_config(sample_type=sample_type)).train()
    b = _batch(B=2, T=8, seed=2)
    scores, dis = net({k: torch.from_numpy(v) for k, v in b.items()},
                      gen=torch.Generator().manual_seed(0))
    loss, _ = L.total_loss(scores, torch.from_numpy(b["label"]), dis)
    loss.backward()
    assert np.isfinite(loss.item())
    with pytest.raises(ValueError, match="sample type"):
        R.RegionSelector(sample_type="topk")


# ---------------------------------------------------------------------------
# reference checkpoints


def test_merge_state_dict_report_matches_jax(tiny_swin):
    """On one synthesized state_dict under DDP's ``module.`` prefix (one
    entry dropped, one of another shape, one the model lacks), the port's
    report equals kvq_tpu's merge_params on the stripped dict, entry for
    entry, and so do the merged values."""
    tiny_swin()
    net = VN.VQANetwork(swin_cfg("swin_tiny_grpb", False))
    own = {k: v.numpy().copy() for k, v in net.state_dict().items()}
    rng = np.random.default_rng(4)
    sd = {k: rng.normal(size=v.shape).astype(np.float32)
          for k, v in own.items()}
    pre = "swin_tiny_grpb_backbone.layers.0.blocks.1."
    del sd[pre + "norm1.weight"]
    sd[pre + "mlp.fc1.weight"] = np.zeros((3, 5), np.float32)
    sd["swin_tiny_grpb_backbone.head.weight"] = np.zeros(4, np.float32)
    sd = {f"module.{k}": v for k, v in sd.items()}

    merged, want = JC.merge_params(own, strip_module_prefix(sd))
    report = merge_state_dict(net, {k: torch.from_numpy(v)
                                    for k, v in sd.items()})
    assert report == want
    assert [len(v) for v in report.values()] == [1, 1, 1]
    for k, v in net.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), merged[k], err_msg=k)
    with pytest.raises(ValueError, match="strict"):
        merge_state_dict(net, sd, strict=True)
    with pytest.raises(ValueError, match="strict"):
        JC.merge_params(own, strip_module_prefix(sd), strict=True)


def test_lsvq_fork_through_test_load_path(tiny_swin, tmp_path):
    """A Video-Swin state_dict without fragment tables (reference ``.pth``
    layout, ``module.`` prefix) loads through the evaluator's
    ``test_load_path``, which wins over ``load_path``: each fragment table
    is its block's relative table, and the score equals JAX's after
    convert_swin3d of the same dict."""
    tiny_swin()
    key = "swin_tiny_grpb"
    x = technical_batch(seed=5)["technical"]
    jcfg = jax_cfg(key, False)
    params, hp, _ = _jax_model(jcfg, x, seed=3)
    sd = {f"module.{k}": v.numpy() for k, v in state_dict_from_jax(
        {f"{key}_backbone": params, f"{key}_head": hp}).items()
        if not k.endswith("fragment_position_bias_table")}
    other = {k: np.zeros_like(v) for k, v in sd.items()}
    cfg = swin_cfg(key, True,
                   test_load_path=_write(tmp_path / "lsvq.pth", {
                       k: torch.from_numpy(v) for k, v in sd.items()}),
                   load_path=_write(tmp_path / "other.pth", {
                       k: torch.from_numpy(v) for k, v in other.items()}))
    net = Evaluator(cfg, device="cpu").model
    tables = dict(net.named_parameters())
    forked = [k for k in tables if k.endswith("fragment_position_bias_table")]
    assert len(forked) == 5  # stages 0-2 of depths (2, 2, 1, 1)
    for k in forked:
        rel = k.replace("fragment_position", "relative_position")
        assert torch.equal(tables[k], tables[rel]) and tables[k].abs().sum()

    flat = strip_module_prefix(sd)
    jp = convert_swin3d(flat, depths=jcfg.depths, frag_biases=jcfg.frag_biases,
                        prefix=f"{key}_backbone.", trunk_key="trunk")
    jh = convert_vqa_head(flat, prefix=f"{key}_head.")
    ref = jax.jit(lambda b: JVQAHead(hidden_channels=16).apply(
        {"params": jh}, JS.SwinTransformer3D(config=jcfg).apply(
            {"params": jp}, b)))({"technical": jnp.asarray(x)})
    with torch.no_grad():
        out = net({"technical": torch.from_numpy(x)})[0]
    np.testing.assert_allclose(out.numpy().reshape(-1),
                               np.asarray(ref).reshape(-1), atol=1e-5)


# ---------------------------------------------------------------------------
# the rest of the train surface


def _val_batches(n=4, seed=9):
    r = np.random.default_rng(seed)
    return [{"technical": r.normal(size=(1, 8, 40, 40, 3)).astype(
                np.float32),
             "label": np.asarray([r.normal()], np.float32),
             "video_name": [f"v{i}"]} for i in range(n)]


def _jax_rule(tr, workdir, metrics):
    """kvq_tpu's Trainer._eval_and_maybe_save on ``metrics`` (by use_ema)
    and a stand-in state: its best tuple and the file it writes."""
    state = types.SimpleNamespace(params={"w": np.zeros(1, np.float32)},
                                  ema_params={"w": np.ones(1, np.float32)},
                                  batch_stats={})
    jt = types.SimpleNamespace(config=tr.config, workdir=str(workdir),
                               test_set=tr.test_set, state=state,
                               evaluate=lambda use_ema: metrics[use_ema])

    def rule(use_ema, best, suffix):
        return JTrainer._eval_and_maybe_save(jt, use_ema, best, suffix)
    return rule


def test_train_eval_keeps_best_as_jax(tiny_swin, tmp_path):
    """train_eval updates best / best_ema and writes the best weights as
    kvq_tpu's rule does on the same metrics (max SRCC/PLCC/KRCC, min RMSE;
    a file when SRCC + PLCC improves), under the reference's
    ``{name}_head_{test_set}_{n|s}_finetuned`` stem; the ``s`` file holds
    the EMA weights and the best before the update."""
    tiny_swin()
    tr = Trainer(swin_cfg("swin_tiny_grpb", True), device="cpu", seed=0,
                 workdir=str(tmp_path / "port"), test_set="val")
    train = [technical_batch(seed=i) for i in range(2)]
    val = _val_batches()
    stem = "tiny_swin_tiny_grpb_head_val"
    for round_ in range(2):
        before = (tr.best, tr.best_ema)
        best, best_ema = tr.train_eval(train, val)
        metrics = {False: tr.evaluate(val), True: tr.evaluate(val, True)}
        assert metrics[False] != metrics[True]
        jdir = tmp_path / f"jax{round_}"
        rule = _jax_rule(tr, jdir, metrics)
        assert best == rule(False, before[0], "n")
        assert best_ema == rule(True, before[1], "s")
        for suffix in "ns":
            port = tmp_path / "port" / f"{stem}_{suffix}_finetuned.pth"
            jax_file = jdir / f"{stem}_{suffix}_finetuned.msgpack"
            assert port.exists() == jax_file.exists(), (round_, suffix)
        if round_ == 0:
            assert all(np.isfinite(best)) and best != before[0]
            saved = load_checkpoint(str(tmp_path / "port" /
                                        f"{stem}_s_finetuned.pth"))
            assert saved["validation_results"] == list(before[1])
            names = [n for n, _ in tr.model.named_parameters()]
            for n, e in zip(names, tr.ema):
                assert torch.equal(saved["params"][n], e), n
            # a best that the next round cannot beat: no new raw file
            tr.best = (0.999, 0.999, 0.999, 0.0)
            for f in (tmp_path / "port").iterdir():
                os.remove(f)
    assert not (tmp_path / "port" / f"{stem}_n_finetuned.pth").exists()


def test_swin_key_train_epoch_save_load_resume(tiny_swin, tmp_path):
    """A Swin key trains through train_epoch (DropPath 0.1, head dropout,
    remat on), and a resume from ``save`` is bit-equal; without
    device='cpu' and without a card the Trainer raises."""
    tiny_swin(0.1)
    cfg = dict(swin_cfg("swin_tiny_grpb", True), warmup_epochs=1,
               num_epochs=4)
    batches = [technical_batch(seed=i) for i in range(3)]
    tr = Trainer(cfg, device="cpu", seed=0, steps_per_epoch=2)
    init = [p.detach().clone() for p in tr.params]
    first = tr.train_epoch(batches[:2])
    assert tr.step == 2 and np.isfinite(first["total_loss"])
    assert any(not torch.equal(p, q) for p, q in zip(tr.params, init))
    path = str(tmp_path / "state.pt")
    tr.save(path)
    last = tr.train_epoch(batches[2:])

    resumed = Trainer(cfg, device="cpu", seed=1, steps_per_epoch=2)
    resumed.load(path)
    assert resumed.step == 2
    assert resumed.train_epoch(batches[2:]) == last
    for p, q in zip(tr.params, resumed.params):
        assert torch.equal(p, q)
    for e, f in zip(tr.ema, resumed.ema):
        assert torch.equal(e, f)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Trainer(cfg)
    with pytest.raises(KeyError, match="technical"):
        tr.train_step({"fragment": batches[0]["technical"],
                       "label": batches[0]["label"]})

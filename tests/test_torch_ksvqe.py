"""The whole tiny KSVQE + VQAHead of the port against the JAX package, with
the JAX weights carried across by ``kvq_tpu_torch.core.from_jax``, plus the
weight round trip and the evaluator.

Tolerances in float32 on the CPU: score atol 1e-5 and dis_loss rtol 1e-5
(f32 roundoff through ~40 layers; the reference-parity record is 7.0e-6,
docs/PARITY.md).  With ``use_pallas`` the JAX side runs its Pallas kernels
in interpret mode and the port's wrappers run their plain versions.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import kvq_tpu.ops.window_attention as WA
from __graft_entry__ import _tiny_ksvqe_config
from kvq_tpu.core.torch_import import convert_ksvqe_full
from kvq_tpu.nn.heads import VQAHead as JVQAHead
from kvq_tpu.nn.ksvqe import KSVQE as JKSVQE
from kvq_tpu_torch.core.from_jax import state_dict_from_jax
from kvq_tpu_torch.core.metrics import vqa_metrics
from kvq_tpu_torch.data.fragments import s2d_pack
from kvq_tpu_torch.models.vqa_network import VQANetwork, build_model
from kvq_tpu_torch.train.evaluator import Evaluator

from test_torch_modules import _batch, tiny_config


def _packed(batch):
    return dict(batch, fragment=np.stack([s2d_pack(f)
                                          for f in batch["fragment"]]))


# tuning_stage 2, as config/Kwai_KSVQE_test.yml ships it (a2 2) and as
# config/Kwai_KSVQE_nopretrain.yml (a2 0): the CDM modulates stages 2-3 of
# four, the last at the clamped channel rule (KSVQE_model.py:1160-1163)
TS2 = dict(tuning_stage=2, depths=(1, 1, 1, 1), num_heads=(2, 2, 2, 2))


def jax_weights_at(**changes):
    """Seeded JAX weights of the tiny KSVQE with ``changes`` to its config:
    (config, backbone variables, head variables, params, batch_stats)."""
    cfg = dataclasses.replace(_tiny_ksvqe_config(), **changes)
    model = JKSVQE(config=cfg, dtype=jnp.float32)
    jb = {k: jnp.asarray(v) for k, v in _batch().items()}
    v = jax.jit(lambda b: model.init(
        {"params": jax.random.key(0), "qrs": jax.random.key(1)}, b,
        train=False))(jb)
    width = cfg.embed_dim * 2 ** (len(cfg.depths) - 1)
    hv = JVQAHead(hidden_channels=16).init(jax.random.key(2),
                                           jnp.zeros((1, 4, 3, 3, width)))
    params = {"KSVQE_backbone": jax.tree.map(np.asarray, v["params"]),
              "KSVQE_head": jax.tree.map(np.asarray, hv["params"])}
    stats = {"KSVQE_backbone": jax.tree.map(np.asarray, v["batch_stats"])}
    return cfg, v, hv, params, stats


@pytest.fixture(scope="module")
def jax_weights():
    return jax_weights_at()


def _jax_scores(cfg, v, hv, batch):
    model = JKSVQE(config=cfg, dtype=jnp.float32)
    head = JVQAHead(hidden_channels=16)

    @jax.jit
    def fwd(b):
        feat, loss = model.apply(v, b, train=False)
        return head.apply(hv, feat), loss

    s, l = fwd({k: jnp.asarray(x) for k, x in batch.items()})
    return np.asarray(s).ravel(), float(l)


def _port(params, stats, **backbone):
    net = VQANetwork(tiny_config(**backbone))
    net.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    return net.eval()


@pytest.mark.parametrize("use_pallas,s2d", [(False, False), (False, True),
                                            (True, True)])
def test_tiny_ksvqe_score_and_loss_match_jax(jax_weights, use_pallas, s2d):
    cfg, v, hv, params, stats = jax_weights
    batch = _batch(B=2, T=8, seed=3)
    if s2d:
        batch = _packed(batch)
    jcfg = dataclasses.replace(cfg, use_pallas=use_pallas, s2d_input=s2d)
    flags = (WA.ALLOW_CPU_PALLAS, WA.EVAL_INTERPRET)
    WA.ALLOW_CPU_PALLAS = WA.EVAL_INTERPRET = use_pallas
    try:
        ref_s, ref_l = _jax_scores(jcfg, v, hv, batch)
    finally:
        WA.ALLOW_CPU_PALLAS, WA.EVAL_INTERPRET = flags
    net = _port(params, stats, use_pallas=use_pallas, s2d_input=s2d)
    with torch.no_grad():
        scores, loss = net({k: torch.from_numpy(x) for k, x in batch.items()})
    np.testing.assert_allclose(scores[0].numpy().ravel(), ref_s, atol=1e-5)
    np.testing.assert_allclose(float(loss), ref_l, rtol=1e-5)


@pytest.mark.parametrize("a2", [2.0, 0.0])
def test_tiny_ksvqe_tuning_stage_2_score_matches_jax(a2):
    """Eval at tuning_stage 2 on the shipped route (s2d input, kernels; the
    JAX side's in interpret mode): the CDM modules carried across by their
    index m = stage - tuning_stage, the score within atol 1e-5."""
    cfg, v, hv, params, stats = jax_weights_at(a2=a2, **TS2)
    assert "semantic_adapter_1" in params["KSVQE_backbone"]
    assert "semantic_adapter_2" not in params["KSVQE_backbone"]
    batch = _packed(_batch(B=2, T=8, seed=3))
    flags = (WA.ALLOW_CPU_PALLAS, WA.EVAL_INTERPRET)
    WA.ALLOW_CPU_PALLAS = WA.EVAL_INTERPRET = True
    try:
        ref_s, ref_l = _jax_scores(
            dataclasses.replace(cfg, use_pallas=True, s2d_input=True), v, hv,
            batch)
    finally:
        WA.ALLOW_CPU_PALLAS, WA.EVAL_INTERPRET = flags
    net = _port(params, stats, use_pallas=True, s2d_input=True, a2=a2, **TS2)
    assert len(net.KSVQE_backbone.semantic_adapter) == 2
    with torch.no_grad():
        scores, loss = net({k: torch.from_numpy(x) for k, x in batch.items()})
    np.testing.assert_allclose(scores[0].numpy().ravel(), ref_s, atol=1e-5)
    np.testing.assert_allclose(float(loss), ref_l, rtol=1e-5)


def test_state_dict_round_trips_through_reference_converter(jax_weights):
    """The port's state_dict carries the reference checkpoint names:
    kvq_tpu's torch importer maps it back onto the JAX trees exactly."""
    cfg, _, _, params, stats = jax_weights
    net = _port(params, stats)
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    p2, s2 = convert_ksvqe_full(
        sd, depths=cfg.depths, clip_layers=cfg.clip_layers,
        contrique_layers=cfg.contrique_layers)
    for want, got in ((params, p2), (stats, s2)):
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
        assert len(flat_w) == len(flat_g)
        for path, leaf in flat_w:
            np.testing.assert_array_equal(flat_g[path], leaf, err_msg=str(path))


def test_evaluator_scores_and_writes_output(jax_weights, tmp_path):
    _, _, _, params, stats = jax_weights
    config = dict(tiny_config(s2d_input=True, use_pallas=True),
                  eval_batch_size=2)
    net = _port(params, stats, s2d_input=True, use_pallas=True)
    ev = Evaluator(config, model=net, device="cpu")
    batches = []
    for i in range(3):  # the last batch is partial: padded to 2 rows
        b = _packed(_batch(B=2 if i < 2 else 1, T=8, seed=10 + i))
        b["video_name"] = [f"v{i}_{j}" for j in range(len(b["label"]))]
        batches.append(b)
    out = tmp_path / "output.txt"
    results = ev.inference_test(batches, str(out))
    assert [r[0] for r in results] == ["v0_0", "v0_1", "v1_0", "v1_1", "v2_0"]
    lines = out.read_text().splitlines()
    assert lines == [f"{n},{s}" for n, s in results]
    with torch.no_grad():
        direct = [float(s) for b in batches
                  for s in net({k: torch.from_numpy(b[k]) for k in
                                ("fragment", "resize_video", "dis_label")})[0][0]]
    np.testing.assert_allclose([r[1] for r in results], direct, atol=1e-6)
    labels = [float(x) for b in batches for x in b["label"]]
    assert ev.evaluate(batches) == vqa_metrics(labels, [r[1] for r in results])


def test_build_model_is_seeded():
    a = build_model(tiny_config(), device="cpu", seed=3).state_dict()
    b = build_model(tiny_config(), device="cpu", seed=3).state_dict()
    c = build_model(tiny_config(), device="cpu", seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)


def test_grouped_semantic_path_equals_per_frame_gather(jax_weights):
    """The grouped semantic cross-attention (queries batched per keyframe
    group) computes the per-frame gather path's result."""
    _, _, _, params, stats = jax_weights
    net = _port(params, stats)
    batch = {k: torch.from_numpy(x) for k, x in _batch(seed=5).items()}
    with torch.no_grad():
        grouped, _ = net(batch)
        ks = net.KSVQE_backbone
        ks.config = dataclasses.replace(ks.config, force_sem_gather=True)
        gathered, _ = net(batch)
    np.testing.assert_allclose(grouped[0].numpy(), gathered[0].numpy(),
                               atol=1e-6)

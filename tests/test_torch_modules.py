"""Each module of the port against its JAX counterpart, same weights.

The weights are one tiny JAX KSVQE + VQAHead (__graft_entry__'s tiny
config), carried into the port by ``kvq_tpu_torch.core.from_jax``; inputs
come from seeded numpy.  Everything runs in float32 on the CPU; tolerances
are stated per check (f32 roundoff scaled by depth).  QRS must pick exactly
the same regions.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _tiny_ksvqe_config
from kvq_tpu.nn.heads import VQAHead as JVQAHead
from kvq_tpu.nn.ksvqe import KSVQE as JKSVQE
from kvq_tpu_torch.core.from_jax import state_dict_from_jax
from kvq_tpu_torch.models.vqa_network import VQANetwork

TINY_BACKBONE = dict(
    num_samples=2, tuning_stage=1, a1=1.0, a2=2.0, anchor_size=8,
    region_k=9, embed_dim=16, depths=[1, 1], num_heads=[2, 2],
    window_size=[2, 7, 7], checkpoint=False, contrique_layers=[1, 1, 1, 1],
    clip_layers=2, clip_width=64, clip_heads=4,
)


def tiny_config(**backbone):
    return {"name": "tiny", "model": {
        "type": "KSVQE", "compute_dtype": "float32",
        "args": {"KSVQE": {"backbone": {**TINY_BACKBONE, **backbone},
                           "head": {"hidden_channels": 16}}},
    }}


def _rng(seed=0):
    return np.random.default_rng(seed)


def _batch(B=2, T=8, seed=0):
    r = _rng(seed)
    return {
        "fragment": r.normal(size=(B, T, 40, 40, 3)).astype(np.float32),
        "resize_video": r.normal(size=(B, T, 32, 32, 3)).astype(np.float32),
        "dis_label": np.asarray([i % 2 for i in range(B)], np.int32),
        "label": r.normal(size=(B,)).astype(np.float32),
    }


@pytest.fixture(scope="module")
def pair():
    """(bound JAX KSVQE, bound JAX head, port backbone, port head)."""
    cfg = _tiny_ksvqe_config()
    model = JKSVQE(config=cfg, dtype=jnp.float32)
    jb = {k: jnp.asarray(v) for k, v in _batch().items()}
    v = jax.jit(lambda b: model.init(
        {"params": jax.random.key(0), "qrs": jax.random.key(1)}, b,
        train=False))(jb)
    head = JVQAHead(hidden_channels=16)
    hv = head.init(jax.random.key(2), jnp.zeros((1, 4, 3, 3, 32)))
    params = {"KSVQE_backbone": jax.tree.map(np.asarray, v["params"]),
              "KSVQE_head": jax.tree.map(np.asarray, hv["params"])}
    stats = {"KSVQE_backbone": jax.tree.map(np.asarray, v["batch_stats"])}
    net = VQANetwork(tiny_config())
    net.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    net.eval()
    return model.bind(v), head.bind(hv), net.KSVQE_backbone, net.KSVQE_head


def _close(a, b, atol, rtol=1e-4):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=rtol)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# host-side copies


def test_s2d_and_config_and_metrics_match_jax():
    from kvq_tpu.core import config as JC
    from kvq_tpu.core.metrics import vqa_metrics as jmetrics
    from kvq_tpu.data.fragments import s2d_pack as jpack
    from kvq_tpu_torch.core import config as C
    from kvq_tpu_torch.core.metrics import vqa_metrics
    from kvq_tpu_torch.data.fragments import s2d_pack, s2d_unpack

    v = _rng().normal(size=(8, 40, 40, 3)).astype(np.float32)
    assert np.array_equal(s2d_pack(v), jpack(v))
    assert np.array_equal(s2d_unpack(s2d_pack(v)), v)
    cfg = tiny_config()
    assert C.normalize_config(cfg) == JC.normalize_config(cfg)
    assert C.key_list(cfg) == JC.key_list(cfg) == ["KSVQE"]
    assert C.model_keys(cfg) == JC.model_keys(cfg)
    lab, pred = _rng(1).normal(size=20), _rng(2).normal(size=20)
    assert tuple(vqa_metrics(lab, pred)) == tuple(jmetrics(lab, pred))


def test_batch_helpers_match_trainer():
    from kvq_tpu.train.trainer import pad_batch_rows as jpad
    from kvq_tpu_torch.data.pipeline import (
        host_tensors, pad_batch_rows, reshape_for_clips, view_dtype)

    b = dict(_batch(B=2), video_name=["a", "b"], num_clips=[{"t": 1}] * 2)
    out, ref = pad_batch_rows(b, 4), jpad(b, 4)
    assert out.keys() == ref.keys()
    for k in out:
        assert np.array_equal(np.asarray(out[k]), np.asarray(ref[k])), k
    # the clip reshape folds num_clips into the batch for listed keys only
    clip = {"technical": np.zeros((2, 12, 4)), "num_clips": [{"t": 3}]}
    assert reshape_for_clips(clip, ["technical"])["technical"].shape == (6, 4, 4)
    assert reshape_for_clips(clip, ["KSVQE"])["technical"].shape == (2, 12, 4)
    host = host_tensors(b, torch.bfloat16, pin=False)
    assert host["fragment"].dtype == torch.bfloat16
    assert host["label"].dtype == torch.float32
    cfg = tiny_config()
    assert view_dtype(cfg) is None  # float32 compute: no pre-cast
    assert view_dtype({**cfg, "h2d_dtype": "bfloat16"}) == torch.bfloat16
    with pytest.raises(ValueError):
        view_dtype({**cfg, "h2d_dtype": "float16"})


# ---------------------------------------------------------------------------
# layers, swin


def test_layer_norm_uses_flax_eps_and_variance():
    import flax.linen as fnn

    from kvq_tpu_torch.nn.layers import LayerNorm

    # variance ~1e-5: eps 1e-6 (flax) and 1e-5 (torch) give distinct outputs
    x = (_rng(3).normal(size=(4, 7, 32)) * 3e-3 + 0.01).astype(np.float32)
    ln = fnn.LayerNorm()
    v = ln.init(jax.random.key(0), jnp.asarray(x))
    ref = ln.apply(v, jnp.asarray(x))
    out = LayerNorm(32)(_t(x))
    _close(out, ref, atol=2e-5)
    torch_default = torch.nn.functional.layer_norm(_t(x), (32,))
    assert not np.allclose(torch_default.numpy(), np.asarray(ref), atol=1e-2)


def test_avg_std_pool_matches_jax():
    from kvq_tpu.nn.layers import avg_std_pool as javg
    from kvq_tpu_torch.nn.layers import avg_std_pool

    x = _rng(4).normal(size=(2, 5, 6, 8)).astype(np.float32)
    for a, b in zip(avg_std_pool(_t(x), (1, 2)), javg(jnp.asarray(x), (1, 2))):
        _close(a, b, atol=1e-6)


def test_patch_embed_both_forms(pair):
    from kvq_tpu_torch.data.fragments import s2d_pack

    jm, _, tm, _ = pair
    x = _rng(5).normal(size=(2, 8, 24, 24, 3)).astype(np.float32)
    with torch.no_grad():
        _close(tm.patch_embed(_t(x)), jm.patch_embed(jnp.asarray(x)),
               atol=2e-5)
        packed = np.stack([s2d_pack(f) for f in x])
        _close(tm.patch_embed(_t(packed), packed=True),
               jm.patch_embed(jnp.asarray(packed), packed=True), atol=2e-5)


@pytest.mark.parametrize("stage,shape", [(0, (2, 4, 6, 6, 16)),
                                         (1, (2, 4, 3, 3, 32))])
def test_swin_stages_match_jax(pair, stage, shape):
    jm, _, tm, _ = pair
    x = _rng(6 + stage).normal(size=shape).astype(np.float32)
    with torch.no_grad():
        out = tm.layers[stage](_t(x))
    _close(out, jax.jit(lambda a: jm.layers[stage](a))(jnp.asarray(x)),
           atol=5e-5)


def _block_pair(dims, shift, use_frag, use_pallas):
    """A standalone JAX SwinBlock3D and the port's, same weights."""
    from kvq_tpu.nn.swin import SwinBlock3D as JBlock
    from kvq_tpu_torch.nn.swin import SwinBlock3D

    C, h = 16, 2
    jb = JBlock(num_heads=h, window_size=(2, 7, 7), shift=shift,
                frag_bias=use_frag)
    x = _rng(8).normal(size=(1, *dims, C)).astype(np.float32)
    v = jb.init(jax.random.key(3), jnp.asarray(x))
    p = jax.tree.map(np.asarray, v["params"])
    # carry tables with some scale so the bias path matters
    r = _rng(9)
    for k in list(p["attn"]):
        if k.endswith("table"):
            p["attn"][k] = r.normal(size=p["attn"][k].shape).astype(np.float32)
    tb = SwinBlock3D(C, h, (2, 7, 7), shift, frag_bias=use_frag,
                     use_pallas=use_pallas)
    sd = {"norm1.weight": p["norm1"]["scale"], "norm1.bias": p["norm1"]["bias"],
          "norm2.weight": p["norm2"]["scale"], "norm2.bias": p["norm2"]["bias"]}
    for a, b in (("attn.qkv", p["attn"]["qkv"]), ("attn.proj", p["attn"]["proj"]),
                 ("mlp.fc1", p["mlp"]["fc1"]), ("mlp.fc2", p["mlp"]["fc2"])):
        sd[f"{a}.weight"] = b["kernel"].T
        sd[f"{a}.bias"] = b["bias"]
    for k, a in p["attn"].items():
        if k.endswith("table"):
            sd[f"attn.{k}"] = a
    tb.load_state_dict({k: _t(np.ascontiguousarray(a)) for k, a in sd.items()})
    return jb, {"params": p}, tb, x


@pytest.mark.parametrize(
    "dims,shift,use_frag,use_pallas",
    [
        ((4, 14, 14), True, True, False),   # plain path, shifted, frag
        ((4, 14, 14), True, True, True),    # K1 route (plain version on CPU)
        ((4, 14, 14), False, False, True),
        ((3, 10, 10), True, True, False),   # padded dims
        ((3, 10, 10), True, True, True),    # padded: plain path on the CPU
    ],
)
def test_swin_block_matches_jax(dims, shift, use_frag, use_pallas):
    jb, jv, tb, x = _block_pair(dims, shift, use_frag, use_pallas)
    ref = jax.jit(lambda a: jb.apply(jv, a))(jnp.asarray(x))
    with torch.no_grad():
        out = tb(_t(x))
    _close(out, ref, atol=5e-5)


def test_swin_geometry_helpers_match_jax():
    from kvq_tpu.nn import swin as JS
    from kvq_tpu_torch.nn import swin as S

    for size, win, sh in [((4, 14, 14), (2, 7, 7), (1, 3, 3)),
                          ((4, 6, 6), (2, 7, 7), (1, 3, 3)),
                          ((48, 7, 7), (8, 7, 7), (4, 3, 3))]:
        assert S.get_window_size(size, win, sh) == JS.get_window_size(
            size, win, sh)
    for w in [(2, 7, 7), (8, 7, 7)]:
        assert np.array_equal(S.relative_position_index(w),
                              JS.relative_position_index(w))
    table = _rng(10).normal(size=(3 * 13 * 13, 2)).astype(np.float32)
    for n in (98, 72):  # 72: the [:N, :N] clamp-slice quirk
        _close(S.expand_bias_planes(_t(table), (2, 7, 7), n),
               JS.expand_bias_planes(jnp.asarray(table), (2, 7, 7), n), 0)
    x = _rng(11).normal(size=(2, 4, 14, 14, 3)).astype(np.float32)
    part = S.window_partition(_t(x), (2, 7, 7))
    _close(part, JS.window_partition(jnp.asarray(x), (2, 7, 7)), 0)
    _close(S.window_reverse(part, (2, 7, 7), 2, 4, 14, 14), x, 0)


def test_patch_merging_odd_dims():
    from kvq_tpu.nn.layers import PatchMerging as JPM
    from kvq_tpu_torch.nn.layers import PatchMerging

    x = _rng(12).normal(size=(1, 2, 5, 7, 8)).astype(np.float32)
    jm = JPM()
    v = jm.init(jax.random.key(0), jnp.asarray(x))
    p = jax.tree.map(np.asarray, v["params"])
    tm = PatchMerging(8)
    tm.load_state_dict({
        "norm.weight": _t(p["norm"]["scale"]), "norm.bias": _t(p["norm"]["bias"]),
        "reduction.weight": _t(p["reduction"]["kernel"].T.copy())})
    with torch.no_grad():
        _close(tm(_t(x)), jm.apply(v, jnp.asarray(x)), atol=2e-5)


# ---------------------------------------------------------------------------
# CLIP, QRS, CONTRIQUE


@pytest.mark.parametrize("side", [32, 48])
def test_clip_tower_matches_jax(pair, side):
    jm, _, tm, _ = pair
    x = _rng(13).normal(size=(3, side, side, 3)).astype(np.float32)
    ref = jax.jit(lambda a: jm.CLIP_tool(a))(jnp.asarray(x))
    with torch.no_grad():
        out = tm.CLIP_tool(_t(x))
    for a, b in zip(out, ref):
        _close(a, b, atol=5e-5)


def test_clip_adapters_match_jax():
    """CLIP_location below the depth adds residual cls adapters (the tiny
    config has none): tower with clip_location=1 against JAX."""
    from kvq_tpu.nn.clip_vit import CLIPVisionTower as JTower
    from kvq_tpu_torch.core.from_jax import _clip, _Out
    from kvq_tpu_torch.nn.clip_vit import CLIPVisionTower

    x = _rng(19).normal(size=(2, 32, 32, 3)).astype(np.float32)
    jt = JTower(width=32, layers=3, heads=2, clip_location=1)
    v = jax.jit(lambda a: jt.init(jax.random.key(0), a))(jnp.asarray(x))
    ref = jax.jit(lambda a: jt.apply(v, a))(jnp.asarray(x))
    o = _Out()
    _clip(o, "", jax.tree.map(np.asarray, v["params"]))
    tower = CLIPVisionTower(width=32, layers=3, heads=2, clip_location=1)
    assert len(tower.adapter_layer) == 2
    tower.load_state_dict(o.sd, strict=True)
    with torch.no_grad():
        out = tower(_t(x))
    for a, b in zip(out, ref):
        _close(a, b, atol=5e-5)


@pytest.mark.parametrize("dst", [(2, 2), (3, 3), (20, 20), (14, 14)])
def test_resize_pos_embed_matches_jax(dst):
    from kvq_tpu.nn.clip_vit import resize_pos_embed_2d as jresize
    from kvq_tpu_torch.nn.clip_vit import resize_pos_embed_2d

    pe = _rng(14).normal(size=(1 + 14 * 14, 8)).astype(np.float32)
    _close(resize_pos_embed_2d(_t(pe), 14, dst),
           jresize(jnp.asarray(pe), 14, dst), atol=2e-5)


def test_qrs_selects_exactly_the_same_regions():
    from kvq_tpu.nn import regionnet as JR
    from kvq_tpu.ops import topk as JT
    from kvq_tpu_torch.nn import regionnet as R
    from kvq_tpu_torch.ops import topk as T

    r = _rng(15)
    for B, L, grid, k in [(2, 4, (5, 5), 9), (3, 196, (9, 9), 49)]:
        ca = r.normal(size=(B, 4, L)).astype(np.float32)
        _, gid = R.keyframe_schedule(16)
        sel = R.RegionSelector(k=k, anchor_size=8).select(_t(ca), gid, grid)
        jsel = JR.RegionSelector(k=k, anchor_size=8).select(
            jnp.asarray(ca), gid, grid, train=False)
        assert np.array_equal(sel.numpy(), np.asarray(jsel))
        _close(R.region_scores(_t(ca[:, 0]), grid, int(k ** 0.5)),
               JR.region_scores(jnp.asarray(ca[:, 0]), grid, int(k ** 0.5)),
               atol=1e-6)
    # ties go to the lowest index, as jnp.argmax breaks them
    flat = np.zeros((1, 4, 4), np.float32)
    assert R.RegionSelector(k=9, anchor_size=8).select(
        _t(flat), (0, 1, 2, 3), (5, 5)).tolist() == [[0, 0, 0, 0]]
    frag = r.normal(size=(2, 4, 40, 40, 3)).astype(np.float32)
    idx = r.integers(0, 9, size=(2, 4))
    _close(R.extract_region_hard(_t(frag), _t(idx), 8, 3),
           JR.extract_region_hard(jnp.asarray(frag), jnp.asarray(idx), 8, 3), 0)
    for t in (8, 32, 96):
        assert R.keyframe_schedule(t) == JR.keyframe_schedule(t)
    x = r.normal(size=(3, 9)).astype(np.float32)
    _close(T.hard_topk_indicator(_t(x), 2), JT.hard_topk_indicator(jnp.asarray(x), 2), 0)
    _close(T.min_max_norm(_t(x)), JT.min_max_norm(jnp.asarray(x)), atol=1e-7)


def test_contrique_matches_jax(pair):
    jm, _, tm, _ = pair
    x = _rng(16).normal(size=(2, 3, 24, 24, 3)).astype(np.float32)
    with torch.no_grad():
        out = tm.distortion_tool(_t(x))
    _close(out, jax.jit(lambda a: jm.distortion_tool(a))(jnp.asarray(x)),
           atol=5e-5)


# ---------------------------------------------------------------------------
# CDM, loss, head


@pytest.mark.parametrize("use_pallas", [False, True])
def test_cdm_attentions_match_jax(pair, use_pallas):
    jm, _, tm, _ = pair
    r = _rng(17)
    q = r.normal(size=(3, 18, 32)).astype(np.float32)
    kv = r.normal(size=(3, 9, 32)).astype(np.float32)
    for name in ("semantic_cross", "distortion_cross"):
        mod = getattr(tm, name)[0]
        mod.use_pallas = use_pallas
        jref, _ = getattr(jm, name)[0](jnp.asarray(q), jnp.asarray(kv))
        with torch.no_grad():
            _close(mod(_t(q), _t(kv)), jref, atol=2e-5)
    mod = tm.distortion_self[0]
    mod.use_pallas = use_pallas
    with torch.no_grad():
        _close(mod(_t(q)), jm.distortion_self[0](jnp.asarray(q)), atol=2e-5)


def test_cdm_film_adapters_loss_head_match_jax(pair):
    from kvq_tpu.train.losses import distortion_contrastive_supervised as jloss
    from kvq_tpu_torch.train.losses import distortion_contrastive_supervised

    jm, jh, tm, th = pair
    r = _rng(18)
    x = r.normal(size=(2, 4, 3, 3, 32)).astype(np.float32)
    inp = r.normal(size=(2, 4, 3, 3, 32)).astype(np.float32)
    tok = r.normal(size=(2, 4, 9, 128)).astype(np.float32)
    pat = r.normal(size=(2, 4, 4, 64)).astype(np.float32)
    with torch.no_grad():
        _close(tm.semantic_mod[0](_t(x[0]), _t(inp[0])),
               jm.semantic_mod[0](jnp.asarray(x[0]), jnp.asarray(inp[0])), 1e-5)
        _close(tm.distortion_mod[0](_t(x), _t(inp.reshape(2, -1, 32))),
               jm.distortion_mod[0](jnp.asarray(x),
                                    jnp.asarray(inp.reshape(2, -1, 32))), 1e-5)
        _close(tm.dist_adapter(_t(tok)), jm.dist_adapter(jnp.asarray(tok)), 1e-5)
        _close(tm.distortion_adapter[0](_t(tok)),
               jm.distortion_adapter[0](jnp.asarray(tok)), 1e-5)
        _close(tm.semantic_adapter[0](_t(pat)),
               jm.semantic_adapter[0](jnp.asarray(pat)), 1e-5)
        _close(tm.norm(_t(x)), jm.final_norm(jnp.asarray(x)), 2e-5)
        _close(th(_t(x)), jh(jnp.asarray(x)), 1e-5)
        lab = np.asarray([0, 1], np.int32)
        _close(distortion_contrastive_supervised(_t(tok), _t(lab)),
               jloss(jnp.asarray(tok), jnp.asarray(lab)), 1e-5)

"""The Swin-T-3D model keys of the port (swin_tiny, swin_tiny_grpb,
swin_tiny_grpb_m, swin_small) and their eval kernels K3, K6 and K7, against
the JAX package.

On the CPU the port's wrappers run their plain versions; the JAX kernels run
in Pallas interpret mode (``EVAL_INTERPRET``, ``ALLOW_CPU_PALLAS``).
Tolerances in float32: the kernels' plain versions atol 2e-4, rtol 1e-3, the
JAX suite's own kernel-vs-XLA bound (the TPU kernels fold the softmax; the
port computes the XLA composition); model scores atol 1e-5 (f32 roundoff
through a dozen layers).  The CUDA kernels are held against the plain
versions on the card by tests/test_torch_cuda.py.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import kvq_tpu.ops.window_attention as WA
from kvq_tpu.core.torch_import import convert_swin3d, convert_vqa_head
from kvq_tpu.nn import swin as JS
from kvq_tpu.nn.heads import VQAHead as JVQAHead
from kvq_tpu.train.trainer import Trainer as JTrainer
from kvq_tpu_torch.core.from_jax import state_dict_from_jax
from kvq_tpu_torch.data.pipeline import reshape_for_clips
from kvq_tpu_torch.models.vqa_network import build_model
from kvq_tpu_torch.nn import swin as S
from kvq_tpu_torch.nn.heads import VQAHead
from kvq_tpu_torch.ops import window_attention as TWA
from kvq_tpu_torch.train.evaluator import Evaluator

ATOL, RTOL = 2e-4, 1e-3


@pytest.fixture
def interpret():
    """The JAX package's eval kernels in Pallas interpret mode on the
    CPU."""
    flags = (WA.ALLOW_CPU_PALLAS, WA.EVAL_INTERPRET)
    WA.ALLOW_CPU_PALLAS = WA.EVAL_INTERPRET = True
    yield
    WA.ALLOW_CPU_PALLAS, WA.EVAL_INTERPRET = flags


def _geo_kw(B, dims, window, shift, use_frag, h, hd):
    return dict(batch=B, dims=dims, window=window, shift=shift,
                fragments=(1, 7, 7), num_heads=h, head_dim=hd,
                use_frag=use_frag)


def _planes(rng, geo_kw):
    h, N = geo_kw["num_heads"], int(np.prod(geo_kw["window"]))
    rel = rng.normal(size=(h, N, N), scale=0.5).astype(np.float32)
    frag = (rng.normal(size=(h, N, N), scale=0.5).astype(np.float32)
            if geo_kw["use_frag"] else None)
    return rel, frag


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


# (batch, padded dims, window, shift, frag bias, heads, head dim)
K3_GEOMETRIES = [
    (1, (4, 21, 21), (2, 7, 7), (0, 0, 0), True, 2, 8),   # 18 padded to 21
    (2, (4, 21, 21), (2, 7, 7), (1, 3, 3), True, 2, 8),   # shifted, B=2
    (1, (4, 14, 14), (2, 7, 7), (1, 3, 3), False, 3, 8),  # shifted, no frag
    (1, (4, 5, 5), (2, 5, 5), (1, 0, 0), True, 2, 8),     # clamped window
    (1, (8, 8, 8), (4, 4, 4), (2, 2, 2), False, 2, 16),   # (4, 4, 4) window
]


@pytest.mark.parametrize("B,dims,window,shift,use_frag,h,hd", K3_GEOMETRIES)
def test_k3_plain_matches_jax_kernel(B, dims, window, shift, use_frag, h,
                                     hd):
    kw = _geo_kw(B, dims, window, shift, use_frag, h, hd)
    rng = np.random.default_rng(0)
    geo = TWA.WindowGeometry(**kw)
    BW, N = B * geo.n_windows, geo.n_tokens
    qkv = rng.normal(size=(BW, N, 3 * h * hd)).astype(np.float32)
    rel, frag = _planes(rng, kw)
    packed = qkv.reshape(BW, N, 3 * h, hd).transpose(0, 2, 1, 3)
    ref = np.asarray(WA.flash_window_attention_packed(
        jnp.asarray(packed), h, jnp.asarray(rel), _j(frag),
        WA.WindowGeometry(**kw), interpret=True))
    before = TWA.flash_window_attention_packed.launches
    out = TWA.flash_window_attention_packed(_t(qkv), _t(rel), _t(frag), geo)
    assert TWA.flash_window_attention_packed.launches == before  # CPU: plain
    out = out.numpy().reshape(BW, N, h, hd).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("B,dims,window,shift,use_frag,h,hd",
                         K3_GEOMETRIES[1:4])
def test_k6_plain_matches_jax_kernel(B, dims, window, shift, use_frag, h,
                                     hd):
    kw = _geo_kw(B, dims, window, shift, use_frag, h, hd)
    rng = np.random.default_rng(1)
    geo = TWA.WindowGeometry(**kw)
    BW, N = B * geo.n_windows, geo.n_tokens
    qkv = rng.normal(size=(3, BW, h, N, hd)).astype(np.float32)
    rel, frag = _planes(rng, kw)
    ref = np.asarray(WA.flash_window_attention(
        *(jnp.asarray(t) for t in qkv), jnp.asarray(rel), _j(frag),
        WA.WindowGeometry(**kw), interpret=True))
    tq = _t(qkv)  # q, k and v as views of one tensor
    out = TWA.flash_window_attention(tq[0], tq[1], tq[2], _t(rel), _t(frag),
                                     geo)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("X,h,N,M,hd,scale", [
    (4, 2, 24, 10, 16, None),          # cross attention shape
    (3, 4, 16, 16, 16, 0.3),           # temporal: N = M, explicit scale
    (2, 3, 40, 49, 16, None),          # M not a multiple of 8
])
def test_k7_plain_matches_jax_kernel(X, h, N, M, hd, scale):
    rng = np.random.default_rng(2)
    q = rng.normal(size=(X, h, N, hd)).astype(np.float32)
    kv = rng.normal(size=(2, X, h, M, hd)).astype(np.float32)
    ref = np.asarray(WA.flash_attention_nobias(
        jnp.asarray(q), jnp.asarray(kv[0]), jnp.asarray(kv[1]), scale=scale,
        interpret=True))
    out = TWA.flash_attention_nobias(_t(q), _t(kv[0]), _t(kv[1]), scale)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_new_wrappers_reject_what_the_kernels_do_not_take():
    kw = _geo_kw(1, (4, 14, 14), (2, 7, 7), (1, 3, 3), True, 2, 8)
    geo = TWA.WindowGeometry(**kw)
    BW, N = geo.n_windows, geo.n_tokens
    rel, frag = (torch.zeros(2, N, N) for _ in range(2))
    qkv = torch.zeros(BW, N, 48)
    K3 = TWA.flash_window_attention_packed
    with pytest.raises(ValueError):  # one window short
        K3(qkv[:-1], rel, frag, geo)
    with pytest.raises(ValueError):  # q, k, v not packed along C
        K3(torch.zeros(BW, N, 3, 16), rel, frag, geo)
    with pytest.raises(ValueError):  # frag planes without use_frag
        K3(qkv, rel, frag, dataclasses.replace(geo, use_frag=False))
    with pytest.raises(ValueError):  # planes of the wrong window
        K3(qkv, rel[:, :-1, :-1], frag, geo)
    with pytest.raises(ValueError):  # unpadded dims: 12 is no multiple of 7
        K3(torch.zeros(4, 98, 48), rel, frag,
           dataclasses.replace(geo, dims=(4, 12, 14)))
    with pytest.raises(RuntimeError, match="no backward"):
        K3(qkv.clone().requires_grad_(), rel, frag, geo)
    q = torch.zeros(BW, 2, N, 8)
    with pytest.raises(ValueError):
        TWA.flash_window_attention(q, q, q[:, :1], rel, frag, geo)
    with pytest.raises(ValueError):
        TWA.flash_attention_nobias(q, q[:, :1], q[:, :1])
    with pytest.raises(ValueError):
        TWA.flash_attention_nobias(q[0], q[0], q[0])
    # what only the card checks: type, head dim, batch, layout
    with pytest.raises(TypeError):
        TWA._check_eval_attention("k", q, {"q": q}, 32, 1)
    with pytest.raises(ValueError):
        TWA._check_eval_attention("k", q, {"q": q.bfloat16()}, 16, 1)
    with pytest.raises(ValueError):
        TWA._check_eval_attention("k", q, {"q": q.bfloat16()}, 32, 70000)
    with pytest.raises(ValueError):  # rows not of unit stride
        TWA._head_major_strides("k", q=q.transpose(2, 3))
    with pytest.raises(ValueError):  # a row stride that is not 8-aligned
        TWA._head_major_strides("k", q=torch.zeros(2, 2, 4, 36)[..., :32])
    s = TWA._head_major_strides("k", q=q, k=torch.zeros(3, 1, 40, 8))
    assert list(s) == [2 * N * 8, N * 8, 8, 40 * 8, 0, 8]


# ---------------------------------------------------------------------------
# the whole model


def _jax_model(cfg, x, seed=0, hidden=16):
    """JAX SwinTransformer3D + VQAHead: params with position tables of some
    scale (so that the bias path matters), and the bound forward."""
    model = JS.SwinTransformer3D(config=cfg, dtype=jnp.float32)
    v = jax.jit(lambda b: model.init(jax.random.key(seed), b))(
        {"technical": jnp.asarray(x)})
    rng = np.random.default_rng(seed + 7)
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.normal(size=a.shape, scale=0.3).astype(np.float32)
                      if "table" in str(p[-1]) else np.asarray(a)),
        v["params"])
    head = JVQAHead(hidden_channels=hidden)
    hv = head.init(jax.random.key(seed + 1),
                   jnp.zeros((1, 2, 2, 2, cfg.embed_dim * 8)))
    hp = jax.tree.map(np.asarray, hv["params"])

    @jax.jit
    def score(b):
        return head.apply({"params": hp}, model.apply({"params": params}, b))

    return params, hp, score


def _port_model(key, cfg, params, head_params, hidden=16):
    net = torch.nn.ModuleDict({
        f"{key}_backbone": S.SwinTransformer3D(cfg),
        f"{key}_head": VQAHead(cfg.embed_dim * 8, hidden),
    })
    sd = state_dict_from_jax({f"{key}_backbone": params,
                              f"{key}_head": head_params})
    net.load_state_dict(sd, strict=True)
    return net.eval()


def _port_score(net, key, x):
    with torch.no_grad():
        feat = net[f"{key}_backbone"]({"technical": torch.from_numpy(x)})
        return net[f"{key}_head"](feat).numpy()


def _tiny_cfg(jcfg_cls, use_pallas, **kw):
    return jcfg_cls(embed_dim=16, depths=(2, 2, 1, 1), num_heads=(2, 2, 4, 8),
                    window_size=(2, 7, 7), use_pallas=use_pallas, **kw)


# (2, 8, 40, 40) -> stage 0 at 4x10x10 tokens pads to 4x14x14; stage 1 at
# 4x5x5 clamps the window to (2, 5, 5) (the [:N, :N] slice at N=50)
TINY_INPUT = (2, 8, 40, 40, 3)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_tiny_swin_tiny_grpb_score_matches_jax(use_pallas, monkeypatch):
    x = np.random.default_rng(3).normal(size=TINY_INPUT).astype(np.float32)
    jcfg = _tiny_cfg(JS.SwinConfig, use_pallas, use_checkpoint=False)
    flags = (WA.ALLOW_CPU_PALLAS, WA.EVAL_INTERPRET)
    WA.ALLOW_CPU_PALLAS = WA.EVAL_INTERPRET = use_pallas
    try:
        params, hp, score = _jax_model(jcfg, x)
        ref = np.asarray(score({"technical": jnp.asarray(x)}))
    finally:
        WA.ALLOW_CPU_PALLAS, WA.EVAL_INTERPRET = flags
    calls = {"K1": 0, "K3": 0}

    def counted(name, fn):
        def call(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return call

    monkeypatch.setattr(S, "fused_swin_block",
                        counted("K1", S.fused_swin_block))
    monkeypatch.setattr(S, "flash_window_attention_packed",
                        counted("K3", S.flash_window_attention_packed))
    net = _port_model("swin_tiny_grpb", _tiny_cfg(S.SwinConfig, use_pallas),
                      params, hp)
    out = _port_score(net, "swin_tiny_grpb", x)
    np.testing.assert_allclose(out, ref, atol=1e-5)
    # with use_pallas the padded stage takes K3, the pad-free stages K1
    assert calls == ({"K1": 4, "K3": 2} if use_pallas
                     else {"K1": 0, "K3": 0})


def test_state_dict_from_jax_dispatches_on_the_trunk_level():
    """A backbone tree with a ``trunk`` level is a Swin-T-3D key's, under
    whatever key name; a backbone of another kind is refused."""
    x = np.zeros(TINY_INPUT, np.float32)
    params, hp, _ = _jax_model(_tiny_cfg(JS.SwinConfig, False,
                                         use_checkpoint=False), x)
    sd = state_dict_from_jax({"swin_small_backbone": params,
                              "swin_small_head": hp})
    net = torch.nn.ModuleDict({
        "swin_small_backbone": S.SwinTransformer3D(
            _tiny_cfg(S.SwinConfig, False)),
        "swin_small_head": VQAHead(128, 16),
    })
    net.load_state_dict(sd, strict=True)
    with pytest.raises(NotImplementedError, match="conv_tiny"):
        state_dict_from_jax({"conv_tiny_backbone": {
            k: v for k, v in params.items() if k != "trunk"}})


@pytest.mark.parametrize("key", S.SWIN_KEYS)
def test_presets_match_jax_at_reduced_depth(key, interpret):
    """Each preset at its published widths and windows, cut to depths
    (2, 1, 1, 1), on a (1, 8, 72, 72) clip: the (8, 7, 7) presets pad
    stages 0-1 to 21 and 14 tokens; swin_tiny_grpb_m's (4, 4, 4) windows
    pad stages 0-2 (18, 9 and 5 tokens to 20, 12 and 8)."""
    bb = {"use_pallas": True, "checkpoint": False}
    jfull, tfull = JS.swin_config(key, dict(bb)), S.swin_config(key, bb)
    for f in dataclasses.fields(tfull):
        assert getattr(tfull, f.name) == getattr(jfull, f.name), f.name
    depths = (2, 1, 1, 1)
    jcfg = dataclasses.replace(jfull, depths=depths)
    x = np.random.default_rng(5).normal(size=(1, 8, 72, 72, 3)).astype(
        np.float32)
    params, hp, score = _jax_model(jcfg, x, seed=1, hidden=64)
    ref = np.asarray(score({"technical": jnp.asarray(x)}))
    net = _port_model(key, dataclasses.replace(tfull, depths=depths), params,
                      hp, hidden=64)
    np.testing.assert_allclose(_port_score(net, key, x), ref, atol=1e-5)


@pytest.mark.parametrize("key", S.SWIN_KEYS)
def test_full_presets_have_the_jax_parameters(key):
    """build_model of each key at full depth holds as many parameters as
    the JAX VQANetwork's tree (shapes only: nothing is initialised in
    JAX)."""
    from kvq_tpu.models.vqa_network import VQANetwork as JNet

    config = {"name": key, "model": {"type": key, "compute_dtype": "bfloat16",
                                     "args": {key: {"backbone": {},
                                                    "head": {}}}}}
    shapes = jax.eval_shape(
        lambda b: JNet(config=config).init(jax.random.key(0), b),
        {"technical": jax.ShapeDtypeStruct((1, 4, 64, 64, 3), jnp.float32)})
    leaves = jax.tree.leaves(shapes["params"])
    net = build_model(config, device="cpu")
    tables = [k for k in net.state_dict() if k.endswith("bias_table")]
    assert sum(int(np.prod(a.shape)) for a in leaves) == sum(
        p.numel() for p in net.parameters())
    assert len(leaves) == len(net.state_dict())
    # the position tables stay float32 under the bf16 compute dtype
    assert tables and all(net.state_dict()[k].dtype == torch.float32
                          for k in tables)
    assert net.state_dict()[f"{key}_head.fc_hid.weight"].dtype == \
        torch.bfloat16


def test_state_dict_round_trips_through_reference_converter():
    """The port's state_dict carries the reference checkpoint names:
    kvq_tpu's Video-Swin importer maps it back onto the JAX tree exactly."""
    x = np.zeros(TINY_INPUT, np.float32)
    jcfg = _tiny_cfg(JS.SwinConfig, False, use_checkpoint=False)
    params, hp, _ = _jax_model(jcfg, x)
    net = _port_model("swin_tiny_grpb", _tiny_cfg(S.SwinConfig, False),
                      params, hp)
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    got = convert_swin3d(sd, depths=jcfg.depths, frag_biases=jcfg.frag_biases,
                         prefix="swin_tiny_grpb_backbone.", trunk_key="trunk")
    got_head = convert_vqa_head(sd, prefix="swin_tiny_grpb_head.")
    for want, have in ((params, got), (hp, got_head)):
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        flat_g = dict(jax.tree_util.tree_flatten_with_path(have)[0])
        assert len(flat_w) == len(flat_g)
        for path, leaf in flat_w:
            np.testing.assert_array_equal(flat_g[path], leaf,
                                          err_msg=str(path))


def test_evaluator_scores_a_three_clip_technical_batch_as_one_clip(tmp_path):
    """The eval reshape splits only batch fields named by a model key, and
    "swin_tiny_grpb" is none: a technical view of num_clips 3 is scored as
    one clip of all its frames, as the JAX trainer's _reshape_for_clips
    leaves it."""
    key = "swin_tiny_grpb"
    config = {"name": key, "eval_batch_size": 2, "model": {
        "type": key, "compute_dtype": "float32",
        "args": {key: {"backbone": {"use_pallas": True},
                       "head": {"in_channels": 768, "hidden_channels": 64}}}}}
    rng = np.random.default_rng(6)
    batches = []
    for i, B in enumerate((2, 1)):  # the last batch is padded to 2 rows
        batches.append({
            "technical": rng.normal(size=(B, 12, 64, 64, 3)).astype(
                np.float32),
            "label": rng.normal(size=(B,)).astype(np.float32),
            "video_name": [f"v{i}_{j}" for j in range(B)],
            "num_clips": [{"technical": 3}] * B,
        })
    jax_side = types.SimpleNamespace(key_list=[key])
    for b in batches:
        want = JTrainer._reshape_for_clips(jax_side, b)
        got = reshape_for_clips(b, [key])
        assert got["technical"].shape == b["technical"].shape
        np.testing.assert_array_equal(got["technical"], want["technical"])
    ev = Evaluator(config, device="cpu", seed=2)
    results = ev.inference_test(batches, str(tmp_path / "output.txt"))
    assert [r[0] for r in results] == ["v0_0", "v0_1", "v1_0"]
    with torch.no_grad():
        direct = [float(s) for b in batches for s in ev.model(
            {"technical": torch.from_numpy(b["technical"])})[0]]
    np.testing.assert_allclose([r[1] for r in results], direct, atol=1e-6)
    assert (tmp_path / "output.txt").read_text().splitlines() == [
        f"{n},{s}" for n, s in results]

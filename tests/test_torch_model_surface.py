"""The rest of kvq_tpu's model surface in the port, against kvq_tpu: the
IQA, VAR and MaxVQA heads, swin_2d_tiny (eval with and without kvq_tpu's
kernels, training through the fused train block), timm Swin-T state dicts,
the legacy PatchNet modules and the unused FiLM variants.

The same numpy-seeded weights and inputs go through both, in float32 on the
CPU; the JAX kernels run in Pallas interpret mode (``EVAL_INTERPRET``,
``TRAIN_INTERPRET``, ``ALLOW_CPU_PALLAS``), the port's wrappers their plain
versions.  Tolerances: outputs atol 1e-5; gradients within 2e-4 of each
gradient's largest magnitude (``_grad_close``); selections equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import kvq_tpu.ops.window_attention as WA
from kvq_tpu.core.torch_import import convert_swin2d
from kvq_tpu.nn import cdm as JCDM
from kvq_tpu.nn import heads as JH
from kvq_tpu.nn import regionnet as JR
from kvq_tpu.nn import swin as JS
from kvq_tpu_torch.core.checkpoint import load_weights
from kvq_tpu_torch.core.from_jax import map_head_tree, state_dict_from_jax
from kvq_tpu_torch.models import vqa_network as VN
from kvq_tpu_torch.nn import cdm as CDM
from kvq_tpu_torch.nn import heads as H
from kvq_tpu_torch.nn import regionnet as R
from kvq_tpu_torch.nn import swin as S
from kvq_tpu_torch.ops import train_attention as TA
from kvq_tpu_torch.ops import window_attention as TWA

from test_torch_convnext import _apply, _init, _x, random_tree
from test_torch_train import _grad_close

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def port_state(module, params):
    """A flax tree of Dense / Conv / LayerNorm leaves under the port
    module's names (``a.b.weight`` <- ``a/b/kernel`` or ``scale``), each in
    the layout of the port's tensor."""
    sd = {}
    for name, t in module.state_dict().items():
        *path, leaf = name.split(".")
        node = params
        for k in path:
            node = node[k]
        if leaf == "weight" and "kernel" not in node:
            sd[name] = _t(np.asarray(node["scale"]))
            continue
        a = np.asarray(node["kernel" if leaf == "weight" else leaf])
        if leaf == "weight" and a.ndim == 2:  # Dense -> Linear or 1x1 conv
            a = a.T.reshape(t.shape)
        elif leaf == "weight":  # HWIO / DHWIO -> OIHW / OIDHW
            a = a.transpose(a.ndim - 1, a.ndim - 2, *range(a.ndim - 2))
        sd[name] = _t(a)
    module.load_state_dict(sd, strict=True)
    return module.eval()


# ---------------------------------------------------------------------------
# heads

X_HEAD = (2, 2, 4, 4, 32)


@pytest.mark.parametrize("kind,jkw,kw", [
    ("IQAHead", dict(hidden_channels=8), dict(hidden_channels=8)),
    ("IQAHead", dict(hidden_channels=8, num_class=3),
     dict(hidden_channels=8, num_class=3)),
    ("VARHead", dict(out_channels=10), dict(out_channels=10)),
    ("MaxVQAHead", dict(hidden_channels_per_dim=8, out_dims=3),
     dict(hidden_channels_per_dim=8, out_dims=3)),
    ("VQAHead", dict(hidden_channels=8, num_class=3),
     dict(hidden_channels=8, num_class=3)),
])
def test_head_matches_jax(kind, jkw, kw):
    x = _x(X_HEAD, seed=1)
    jm = getattr(JH, kind)(dtype=jnp.float32, **jkw)
    p = _init(jm, jnp.asarray(x))
    want = _apply(jm, p, jnp.asarray(x))
    sd, unread = map_head_tree(kind, p)
    assert not unread
    m = getattr(H, kind)(X_HEAD[-1], **kw)
    m.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = m.eval()(_t(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_maxvqa_head_keeps_the_grouped_conv_layout():
    m = H.MaxVQAHead(32, hidden_channels_per_dim=8, out_dims=3)
    assert m.fc_last.weight.shape == (3, 8, 1, 1, 1)
    assert m.fc_last.groups == 3


@pytest.mark.parametrize("kind", ["IQAHead", "VARHead", "MaxVQAHead"])
def test_head_dropout_draws_from_the_generator(kind):
    """In training each dropout draws from the caller's generator: the
    same seed gives the same output, and no generator raises."""
    m = getattr(H, kind)(32).train()
    x = _t(_x(X_HEAD, seed=2))
    a = m(x, torch.Generator().manual_seed(3))
    b = m(x, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    with torch.no_grad():
        assert not torch.equal(a, m.eval()(x))
    with pytest.raises(ValueError):
        m.train()(x)


# ---------------------------------------------------------------------------
# swin_2d_tiny

TINY_2D = dict(embed_dim=16, depths=(2, 2, 1, 1), num_heads=(2, 2, 4, 8))


@pytest.fixture
def flags():
    """kvq_tpu's kernels in Pallas interpret mode (set inside a test)."""
    saved = (WA.ALLOW_CPU_PALLAS, WA.EVAL_INTERPRET, WA.TRAIN_INTERPRET)
    yield WA
    WA.ALLOW_CPU_PALLAS, WA.EVAL_INTERPRET, WA.TRAIN_INTERPRET = saved


def _swin2d_pair(use_pallas, x, **cut):
    """JAX swin_2d_tiny + VQAHead (its params redrawn) and the port's
    ``swin_2d_tiny`` model key loaded from them."""
    jm = JS.swin_2d_tiny(use_pallas=use_pallas, use_checkpoint=False, **cut)
    jh = JH.VQAHead(hidden_channels=16)
    p = _init(jm, {"technical": jnp.asarray(x)})
    hp = _init(jh, jnp.zeros((1, 1, 1, 1, jm.config.embed_dim * 8)))
    cfg = {"name": "s", "model": {
        "type": "swin_2d_tiny", "compute_dtype": "float32",
        "args": {"swin_2d_tiny": {"backbone": {"use_pallas": use_pallas},
                                  "head": {"hidden_channels": 16}}}}}
    net = VN.VQANetwork(cfg)
    net.load_state_dict(state_dict_from_jax(
        {"swin_2d_tiny_backbone": p, "swin_2d_tiny_head": hp}), strict=True)
    return jm, jh, p, hp, net.eval()


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["plain", "kernels"])
def test_swin_2d_tiny_eval_matches_jax(use_pallas, flags, monkeypatch):
    """swin_2d_tiny (TINY_2D's widths) on (1, 2, 56, 56, 3): stage 0 at
    14x14 tokens (4 windows of 49 a frame, shifted blocks with seams),
    stage 1 at 7x7 (one window, the shift zeroed); with use_pallas both
    sides take the fused block (K1) on every block."""
    flags.ALLOW_CPU_PALLAS = flags.EVAL_INTERPRET = use_pallas
    real = S.swin_config
    monkeypatch.setattr(VN, "swin_config", lambda k, bb: dataclasses.replace(
        real(k, bb), **TINY_2D))
    x = _x((1, 2, 56, 56, 3), seed=3)
    jm, jh, p, hp, net = _swin2d_pair(use_pallas, x, **TINY_2D)
    feat = jax.jit(lambda b: jm.apply({"params": p}, b))(
        {"technical": jnp.asarray(x)})
    want_s = np.asarray(jh.apply({"params": hp}, feat))
    before = TWA.fused_swin_block.launches
    with torch.no_grad():
        got_f = net.swin_2d_tiny_backbone({"technical": _t(x)})
        got_s = net.swin_2d_tiny_head(got_f)
    assert TWA.fused_swin_block.launches == before  # CPU: plain versions
    np.testing.assert_allclose(got_f.numpy(), np.asarray(feat), atol=ATOL)
    np.testing.assert_allclose(got_s.numpy(), want_s, atol=ATOL)


def test_swin_2d_tiny_config_matches_jax():
    """The full preset: kvq_tpu's SwinConfig of swin_2d_tiny, field by
    field, for the fields the port's SwinConfig has."""
    cfg = S.swin_2d_tiny().config
    jcfg = JS.swin_2d_tiny().config
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert S.swin_config("swin_2d_tiny", {"use_pallas": True}) == \
        dataclasses.replace(cfg, use_pallas=True)


def test_swin_2d_tiny_routes_every_block_to_the_fused_block(monkeypatch):
    """With use_pallas every block of swin_2d_tiny is pad-free at 224 px and
    fits the reference's gate: K1 at eval, K4 in training."""
    calls = []
    real_eval, real_train = S.fused_swin_block, S.train_swin_block
    monkeypatch.setattr(S, "fused_swin_block", lambda *a, **k: (
        calls.append(("K1", a[4].n_tokens)), real_eval(*a, **k))[1])
    monkeypatch.setattr(S, "train_swin_block", lambda *a, **k: (
        calls.append(("K4", a[4].n_tokens)), real_train(*a, **k))[1])
    m = S.swin_2d_tiny(use_pallas=True, **TINY_2D)
    x = _t(_x((1, 1, 224, 224, 3), seed=4))
    with torch.no_grad():
        m.eval()(x)
    assert calls == [("K1", 49)] * 6
    del calls[:]
    m.train()(x, torch.Generator().manual_seed(0))
    assert calls == [("K4", 49)] * 6


def test_swin_2d_tiny_train_gradients_match_jax(flags, monkeypatch):
    """One training forward and backward of swin_2d_tiny (tiny widths,
    DropPath 0, the head without dropout) against jax.grad with kvq_tpu's
    train kernels in interpret mode: the summed score and every gradient.
    The port trains with remat, its default."""
    flags.ALLOW_CPU_PALLAS = flags.TRAIN_INTERPRET = flags.EVAL_INTERPRET = True
    cut = dict(TINY_2D, drop_path_rate=0.0)
    real = S.swin_config
    monkeypatch.setattr(VN, "swin_config", lambda k, bb: dataclasses.replace(
        real(k, bb), **cut))
    x = _x((1, 1, 56, 56, 3), seed=5)
    jm, jh, p, hp, _ = _swin2d_pair(True, x, **cut)
    jx = {"technical": jnp.asarray(x)}

    def loss(params):
        feat = jm.apply({"params": params["b"]}, jx, train=True,
                        rngs={"dropout": jax.random.key(0)})
        return jh.apply({"params": params["h"]}, feat).sum()

    ref_loss, ref = jax.jit(jax.value_and_grad(loss))({"b": p, "h": hp})
    net = VN.build_train_model({"name": "s", "model": {
        "type": "swin_2d_tiny", "compute_dtype": "float32",
        "args": {"swin_2d_tiny": {"backbone": {"use_pallas": True},
                                  "head": {"hidden_channels": 16}}}}},
        device="cpu")
    assert all(st.use_checkpoint for st in net.swin_2d_tiny_backbone.layers)
    net.load_state_dict(state_dict_from_jax(
        {"swin_2d_tiny_backbone": p, "swin_2d_tiny_head": hp}), strict=True)
    net.swin_2d_tiny_head.dropout_ratio = 0.0
    before = TA.train_swin_block.launches
    score = net({"technical": _t(x)}, gen=torch.Generator().manual_seed(0))
    score[0].sum().backward()
    assert TA.train_swin_block.launches == before  # CPU: plain versions
    np.testing.assert_allclose(float(score[0].sum()), float(ref_loss),
                               rtol=1e-5)
    want = state_dict_from_jax({"swin_2d_tiny_backbone": ref["b"],
                                "swin_2d_tiny_head": ref["h"]})
    got = dict(net.named_parameters())
    assert got.keys() == want.keys()
    for name, w in want.items():
        _grad_close(got[name].grad, w.numpy(), name)


def _timm_state_dict(entry_style: bool, seed=6):
    """A timm Swin-T state dict at TINY_2D's widths: random weights under
    timm's names, the 2-D patch kernel, the index and mask buffers and the
    classifier; timm >= 0.9 (``entry_style``) keeps each downsample at the
    entry of the next stage."""
    rng = np.random.default_rng(seed)
    sd = {}
    for name, t in S.swin_2d_tiny(**TINY_2D).state_dict().items():
        a = rng.normal(size=t.shape).astype(np.float32)
        if t.dim() >= 2:
            a *= np.float32(t[0].numel() ** -0.5)
        if name.endswith("norm.weight") or ".norm1." in name or \
                ".norm2." in name:
            a = 1 + 0.1 * a
        if name == "patch_embed.proj.weight":
            a = a[:, :, 0]
        stage = name.split(".")[1] if name.startswith("layers.") else None
        if entry_style and ".downsample." in name:
            name = name.replace(f"layers.{stage}.",
                                f"layers.{int(stage) + 1}.")
        sd[name] = torch.from_numpy(a)
        if name.endswith("attn.relative_position_bias_table"):
            sd[name.replace("bias_table", "index")] = torch.zeros(
                49, 49, dtype=torch.long)
            sd[name.replace("attn.relative_position_bias_table",
                            "attn_mask")] = torch.zeros(4, 49, 49)
    head = "head.fc." if entry_style else "head."
    sd[head + "weight"] = torch.randn(1000, 128)
    sd[head + "bias"] = torch.zeros(1000)
    return sd


@pytest.mark.parametrize("entry_style", [False, True],
                         ids=["timm<0.9", "timm>=0.9"])
def test_timm_swin_t_loads_as_kvq_tpu_converts_it(entry_style, tmp_path):
    """A timm Swin-T file through ``load_weights`` into swin_2d_tiny, alone
    and as the backbone of the ``swin_2d_tiny`` key: nothing unread, and
    the features of kvq_tpu's ``convert_swin2d`` of the same state dict."""
    sd = _timm_state_dict(entry_style)
    path = str(tmp_path / "swin_t.pth")
    torch.save(sd, path)
    params = convert_swin2d({k: v.numpy() for k, v in sd.items()},
                            depths=TINY_2D["depths"])
    x = _x((1, 2, 56, 56, 3), seed=7)
    jm = JS.swin_2d_tiny(use_checkpoint=False, **TINY_2D)
    want = _apply(jm, params, jnp.asarray(x))

    m = S.swin_2d_tiny(**TINY_2D).eval()
    report = load_weights(m, path)
    assert report == {"missing": [], "unexpected": [], "mismatched": []}
    net = VN.VQANetwork({"name": "s", "model": {
        "type": "swin_2d_tiny", "args": {"swin_2d_tiny": {}}}}).eval()
    net.swin_2d_tiny_backbone = S.swin_2d_tiny(**TINY_2D)
    net.swin_2d_tiny_head = H.VQAHead(128)
    report = load_weights(net, path)
    assert not report["unexpected"] and not report["mismatched"]
    assert all(n.startswith("swin_2d_tiny_head.") for n in report["missing"])
    with torch.no_grad():
        for mod in (m, net.swin_2d_tiny_backbone.eval()):
            np.testing.assert_allclose(mod(_t(x)).numpy(), want, atol=ATOL)


# ---------------------------------------------------------------------------
# the legacy PatchNet modules


def test_predictor_lg_matches_jax():
    x = _x((2, 10, 16), seed=8)
    jm = JR.PredictorLG()
    p = _init(jm, jnp.asarray(x))
    m = port_state(R.PredictorLG(16), p)
    with torch.no_grad():
        got = m(_t(x)).numpy()
    np.testing.assert_allclose(got, _apply(jm, p, jnp.asarray(x)), atol=ATOL)


def test_predictor_lg_conv_matches_jax():
    x = _x((3, 8, 8, 12), seed=9)
    jm = JR.PredictorLGConv()
    p = _init(jm, jnp.asarray(x))
    m = port_state(R.PredictorLGConv(12), p)
    with torch.no_grad():
        got = m(_t(x)).numpy()
    np.testing.assert_allclose(got, _apply(jm, p, jnp.asarray(x)), atol=ATOL)


def test_patchnet_ms_conv_matches_jax():
    x = _x((2, 3, 8, 8, 12), seed=10)
    jm = JR.PatchNetMSConv()
    p = _init(jm, jnp.asarray(x))
    m = port_state(R.PatchNetMSConv(6), p)
    with torch.no_grad():
        got = m(_t(x)).numpy()
    np.testing.assert_allclose(got, _apply(jm, p, jnp.asarray(x)), atol=ATOL)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("mode,k", [("time", 3), ("spatial", 1)])
def test_patchnet_ms_matches_jax(mode, k, train):
    """Both modes, eval (hard top-k) and training (perturbed top-k on the
    normal draws JAX makes from its key, handed to the port)."""
    x = _x((2, 6, 12, 12, 8), seed=11)
    jm = JR.PatchNetMS(k=k, anchor_size=5, mode=mode, num_samples=16,
                       sigma=0.5)
    jx = jnp.asarray(x)
    key = jax.random.key(3)
    p = random_tree(jm.init(jax.random.key(0), jx, train=True,
                            key=key)["params"])
    want = np.asarray(jax.jit(lambda a: jm.apply(
        {"params": p}, a, train=train, key=key))(jx))
    m = port_state(R.PatchNetMS(8, k, anchor_size=5, mode=mode,
                                num_samples=16, sigma=0.5), p)
    drawn = []

    def draw(scores, gen):  # the noise JAX's perturbed_topk draws
        noise = jax.random.normal(key, (scores.shape[0], 16,
                                        scores.shape[1]))
        drawn.append(1)
        return _t(np.asarray(noise))

    m.draw = draw
    with torch.no_grad():
        got = m.train(train)(_t(x)).numpy()
    assert len(drawn) == int(train)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


# ---------------------------------------------------------------------------
# the unused FiLM variants


@pytest.mark.parametrize("kind,x_shape,inp_shape", [
    ("SemanticFiLM4", (2, 5, 5, 16), (2, 5, 5, 16)),
    ("SemanticFiLM6", (2, 5, 5, 16), (2, 5, 5, 16)),
    ("SemanticFiLM8", (2, 5, 5, 16), (2, 5, 5, 16)),
    ("DistFiLM5", (2, 3, 4, 4, 16), (2, 48, 16)),
    ("DistFiLM7", (2, 3, 4, 4, 16), (2, 48, 16)),
])
def test_film_variant_matches_jax(kind, x_shape, inp_shape):
    x, inp = _x(x_shape, seed=12), _x(inp_shape, seed=13)
    jm = getattr(JCDM, kind)()
    p = _init(jm, jnp.asarray(x), jnp.asarray(inp))
    want = _apply(jm, p, jnp.asarray(x), jnp.asarray(inp))
    m = port_state(getattr(CDM, kind)(16), p)
    with torch.no_grad():
        got = m(_t(x), _t(inp)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)

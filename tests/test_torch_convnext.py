"""The port's ConvNeXt (GRN, Block3D, ConvNeXt3D, ConvNeXt2D) and the
``conv_tiny`` model key, alone and beside ``swin_tiny`` under
``reduce_scores``, against kvq_tpu/nn/convnext.py and kvq_tpu's VQANetwork.

The same numpy-seeded weights (the JAX trees' leaves redrawn, carried into
the port by ``kvq_tpu_torch.core.from_jax``) and inputs go through both, in
float32 on the CPU.  Tolerances: features and scores atol 1e-5 (f32
roundoff through the depthwise convs and 4x MLPs); gradients within 2e-4 of
each gradient's largest magnitude (``_grad_close``).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kvq_tpu.models import vqa_network as JVN
from kvq_tpu.nn import convnext as JC
from kvq_tpu_torch.core.from_jax import map_convnext_tree, state_dict_from_jax
from kvq_tpu_torch.models import vqa_network as VN
from kvq_tpu_torch.nn import convnext as C

from test_torch_train import _grad_close

ATOL = 1e-5
DEPTHS, DIMS = (1, 1, 2, 1), (16, 32, 64, 128)


def random_tree(tree, seed=0):
    """Every leaf of a JAX params tree redrawn from seeded numpy: kernels
    normal at fan-in^-1/2, LayerNorm scales and ConvNeXt gains 1 + 0.1 n,
    everything else 0.1 n."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = str(path[-1].key)
        a = np.asarray(a)
        n = rng.normal(size=a.shape).astype(np.float32)
        if a.ndim >= 2:
            return n * np.float32(np.prod(a.shape[:-1]) ** -0.5)
        if name in ("scale", "gamma"):
            return 1 + 0.1 * n
        return 0.1 * n

    return jax.tree_util.tree_map_with_path(draw, tree)


def random_stats(stats, seed=1):
    """BatchNorm statistics: means 0.1 n, variances 1 + 0.5 |n|."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        n = rng.normal(size=np.shape(a)).astype(np.float32)
        return (1 + 0.5 * np.abs(n)) if path[-1].key == "var" else 0.1 * n

    return jax.tree_util.tree_map_with_path(draw, stats)


def _init(module, *args, **kw):
    v = jax.jit(lambda *a: module.init(jax.random.key(0), *a, **kw))(*args)
    return random_tree(v["params"])


def _apply(module, params, *args, **kw):
    return np.asarray(jax.jit(lambda *a: module.apply(
        {"params": params}, *a, **kw))(*args))


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _port(module, sd):
    module.load_state_dict(sd, strict=True)
    return module.eval()


def test_grn_matches_jax():
    x = _x((2, 3, 4, 4, 24))
    jm = JC.GRN()
    p = _init(jm, jnp.asarray(x))
    want = _apply(jm, p, jnp.asarray(x))
    m = _port(C.GRN(24), {k: torch.from_numpy(np.asarray(v))
                          for k, v in p.items()})
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("k", [1, 3])
def test_block3d_matches_jax(k, v2):
    x = _x((2, 4, 8, 8, 16), seed=k)
    jm = JC.Block3D(inflate_len=k, v2=v2)
    p = _init(jm, jnp.asarray(x))
    want = _apply(jm, p, jnp.asarray(x))
    sd, unread = map_convnext_tree({"stage0_block0": p})
    assert not unread
    m = _port(C.Block3D(16, k, v2=v2),
              {n[len("stages.0.0."):]: t for n, t in sd.items()})
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
def test_convnext3d_matches_jax(v2):
    x = _x((2, 4, 64, 64, 3), seed=2)
    jm = JC.ConvNeXt3D(depths=DEPTHS, dims=DIMS, v2=v2)
    p = _init(jm, {"asesthetic": jnp.asarray(x)})
    want = _apply(jm, p, {"asesthetic": jnp.asarray(x)})
    sd, unread = map_convnext_tree(p)
    assert not unread
    m = _port(C.ConvNeXt3D(DEPTHS, DIMS, v2=v2), sd)
    with torch.no_grad():
        got = m({"asesthetic": torch.from_numpy(x)}).numpy()
    assert got.shape == want.shape == (2, 2, 2, 2, 128)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("shape", [(2, 32, 32, 3), (1, 3, 32, 32, 3)],
                         ids=["images", "frames"])
def test_convnext2d_matches_jax(shape):
    x = _x(shape, seed=3)
    jm = JC.ConvNeXt2D(depths=DEPTHS, dims=DIMS)
    p = _init(jm, jnp.asarray(x))
    want = _apply(jm, p, jnp.asarray(x))
    sd, unread = map_convnext_tree(p)
    assert not unread and all(n.startswith("trunk.") for n in sd)
    m = _port(C.ConvNeXt2D(DEPTHS, DIMS), sd)
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_factories_match_jax():
    """Every factory of kvq_tpu/nn/convnext.py builds the same widths,
    depths and kind in the port."""
    names = [n for n in dir(JC) if n.startswith("convnext")]
    assert len(names) == 26
    for name in names:
        jm = getattr(JC, name)()
        with torch.device("meta"):  # shapes only: the largest is 0.7 G
            m = getattr(C, name)()
        trunk = m.trunk if isinstance(m, C.ConvNeXt2D) else m
        assert isinstance(m, C.ConvNeXt2D) == isinstance(jm, JC.ConvNeXt2D)
        assert tuple(len(s) for s in trunk.stages) == jm.depths, name
        assert tuple(s[0].pwconv2.out_features for s in trunk.stages) == \
            jm.dims, name
        assert (trunk.stages[0][0].grn is not None) == jm.v2, name


# ---------------------------------------------------------------------------
# the conv_tiny model key through VQANetwork


def _cfg(keys, hidden=16):
    return {"name": "k", "model": {
        "type": ",".join(keys), "compute_dtype": "float32",
        "args": {k: {"backbone": {"checkpoint": False},
                     "head": {"hidden_channels": hidden}} for k in keys}}}


@pytest.fixture
def cut_convnext(monkeypatch):
    """conv_tiny's ConvNeXt3D cut to DEPTHS and DIMS on both sides."""
    monkeypatch.setattr(JC, "ConvNeXt3D", functools.partial(
        JC.ConvNeXt3D, depths=DEPTHS, dims=DIMS))
    monkeypatch.setattr(VN, "ConvNeXt3D", functools.partial(
        C.ConvNeXt3D, DEPTHS, DIMS))


def _pair(keys, batch):
    jnet = JVN.VQANetwork(config=_cfg(keys))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = _init(jnet, jb, train=False)
    net = VN.VQANetwork(_cfg(keys))
    net.load_state_dict(state_dict_from_jax(params), strict=True)
    return jnet, params, jb, net.eval()


def test_conv_tiny_key_has_kvq_tpus_parameters():
    """conv_tiny at its full width (ConvNeXt3D's defaults: depths
    (3, 3, 9, 3), dims 96-768, patch_t 2, inflate "131"): every JAX
    parameter maps to a port parameter of the same shape, and no port
    parameter is left over (shapes from jax.eval_shape: nothing runs)."""
    jnet = JVN.VQANetwork(config=_cfg(["conv_tiny"]))
    shapes = jax.eval_shape(lambda b: jnet.init(jax.random.key(0), b),
                            {"asesthetic": jnp.zeros((1, 4, 32, 32, 3))})
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, np.float32),
                         shapes["params"])
    sd = state_dict_from_jax(zeros)
    with torch.device("meta"):
        net = VN.VQANetwork(_cfg(["conv_tiny"]))
    own = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    assert own == {k: tuple(v.shape) for k, v in sd.items()}
    assert net.conv_tiny_backbone.num_features == 768
    assert own["conv_tiny_backbone.stages.2.4.dwconv.weight"] == \
        (384, 1, 3, 7, 7)


def test_two_branch_sum_matches_jax(cut_convnext, monkeypatch):
    """"swin_tiny,conv_tiny": each branch's score and their sum under
    reduce_scores (the Swin branch at tiny widths on both sides)."""
    import dataclasses

    from kvq_tpu.nn import swin as JS
    from kvq_tpu_torch.nn import swin as S

    tiny = dict(embed_dim=16, depths=(1, 1, 1, 1), num_heads=(2, 2, 4, 8))
    real_j, real_p = JS.swin_config, S.swin_config
    monkeypatch.setattr(JS, "swin_config", lambda k, bb: dataclasses.replace(
        real_j(k, bb), **tiny))
    monkeypatch.setattr(VN, "swin_config", lambda k, bb: dataclasses.replace(
        real_p(k, bb), **tiny))
    batch = {"technical": _x((2, 4, 28, 28, 3), seed=5),
             "asesthetic": _x((2, 4, 32, 32, 3), seed=6)}
    jnet, params, jb, net = _pair(["swin_tiny", "conv_tiny"], batch)
    want = [np.asarray(s) for s in jax.jit(
        lambda b: jnet.apply({"params": params}, b))(jb)]
    want_sum = np.asarray(sum(want))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        got = [s.numpy() for s in net(tb)]
        got_sum = net(tb, reduce_scores=True).numpy()
    assert len(got) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL)
    np.testing.assert_allclose(got_sum, want_sum, atol=ATOL)
    np.testing.assert_allclose(got_sum, got[0] + got[1], rtol=1e-6)


def test_conv_tiny_gradients_match_jax(cut_convnext):
    """jax.grad of the summed scores (backbone in training, DropPath 0, the
    head without dropout) against the port's backward, every gradient."""
    batch = {"asesthetic": _x((2, 4, 32, 32, 3), seed=7)}
    jnet, params, jb, net = _pair(["conv_tiny"], batch)
    bb, head = JVN.build_backbone("conv_tiny", {}, jnp.float32), \
        JVN.build_head("conv_tiny", {"hidden_channels": 16}, jnp.float32)

    def loss(p):
        feat = bb.apply({"params": p["conv_tiny_backbone"]}, jb, train=True)
        return head.apply({"params": p["conv_tiny_head"]}, feat).sum()

    grads = state_dict_from_jax(jax.jit(jax.grad(loss))(params))
    net.train()
    net.conv_tiny_head.dropout_ratio = 0.0
    net({k: torch.from_numpy(v) for k, v in batch.items()},
        gen=torch.Generator().manual_seed(0))[0].sum().backward()
    got = dict(net.named_parameters())
    assert got.keys() == grads.keys()
    for name, want in grads.items():
        _grad_close(got[name].grad, want.numpy(), name)


def test_conv_tiny_builds_in_bf16_with_layer_scales_at_one():
    """build_model's seeded weights: the layer scales at 1 (every branch
    counts), the rest in the compute dtype."""
    net = VN.build_model({"name": "c", "model": {
        "type": "conv_tiny", "args": {"conv_tiny": {}}}}, device="cpu")
    blk = net.conv_tiny_backbone.stages[2][4]
    assert blk.gamma.dtype == torch.bfloat16
    assert torch.equal(blk.gamma, torch.ones_like(blk.gamma))
    assert blk.dwconv.weight.shape == (384, 1, 3, 7, 7)  # "131": k=3 at 4
    assert net.conv_tiny_backbone.stages[2][5].dwconv.weight.shape[2] == 1

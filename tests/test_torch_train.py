"""The port's train path against the JAX package, on the CPU in float32.

Same seeded inputs (numpy) and, through ``core.from_jax``, the same weights
on both sides.  Tolerances:

  - tiny KSVQE train route: loss rtol 1e-5; every parameter gradient, mapped
    back through the reference converter, atol 2e-4 x max(1, the
    gradient's largest magnitude), rtol 1e-3 (f32 roundoff through ~40
    layers and their backward, summed in another order);
  - the Swin block at padded dims (K5's module route): output atol 5e-5,
    gradients as above;
  - perturbed top-k, losses, optimizer and EMA: rtol 1e-5 / atol 1e-6
    (a few f32 operations each).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import kvq_tpu.ops.window_attention as WA
from kvq_tpu.core.torch_import import convert_ksvqe_full
from kvq_tpu.nn.heads import VQAHead as JVQAHead
from kvq_tpu.nn.ksvqe import KSVQE as JKSVQE
from kvq_tpu.train import losses as JL
from kvq_tpu_torch.core.from_jax import state_dict_from_jax
from kvq_tpu_torch.data.fragments import s2d_pack
from kvq_tpu_torch.models.vqa_network import VQANetwork
from kvq_tpu_torch.ops import train_attention as TTA
from kvq_tpu_torch.train import losses as L

from test_torch_ksvqe import TS2, jax_weights_at
from test_torch_modules import _batch, _block_pair, _t, tiny_config


def _grad_close(got, want, name=""):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=2e-4 * scale, rtol=1e-3,
                               err_msg=name)


def _packed_batch(B=4, T=8, seed=3):
    b = _batch(B=B, T=T, seed=seed)
    b["fragment"] = np.stack([s2d_pack(f) for f in b["fragment"]])
    return b


@pytest.fixture(scope="module")
def weights():
    cfg, _, _, params, stats = jax_weights_at()
    return cfg, params, stats


def _jax_loss_and_grads(cfg, params, stats, batch):
    model = JKSVQE(config=cfg, dtype=jnp.float32)
    head = JVQAHead(hidden_channels=16)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        feat, dis = model.apply(
            {"params": p["KSVQE_backbone"],
             "batch_stats": stats["KSVQE_backbone"]},
            jb, train=True,
            rngs={"qrs": jax.random.key(0), "dropout": jax.random.key(1)})
        s = head.apply({"params": p["KSVQE_head"]}, feat, train=False)
        return JL.total_loss([s], jb["label"], dis, 0.3, 0.0)[0]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), grads


def _check_train_route(cfg, params, stats, use_pallas, **backbone):
    """One train forward + backward of the tiny KSVQE (s2d input, DropPath
    0, QRS sigma 0 so both sides are deterministic, head in eval) on both
    sides: the loss and every parameter gradient, mapped back through the
    reference converter."""
    batch = _packed_batch()
    jcfg = dataclasses.replace(cfg, s2d_input=True, drop_path_rate=0.0,
                               sigma=0.0, use_pallas=use_pallas)
    flags = (WA.ALLOW_CPU_PALLAS, WA.TRAIN_INTERPRET)
    WA.ALLOW_CPU_PALLAS = WA.TRAIN_INTERPRET = use_pallas
    try:
        ref_loss, ref_grads = _jax_loss_and_grads(jcfg, params, stats, batch)
    finally:
        WA.ALLOW_CPU_PALLAS, WA.TRAIN_INTERPRET = flags

    net = VQANetwork(tiny_config(use_pallas=use_pallas, s2d_input=True,
                                 drop_path_rate=0.0, sigma=0.0, **backbone))
    net.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    net.train()
    net.KSVQE_head.eval()
    before = (TTA.train_swin_block.launches,
              TTA.window_attention_train.launches)
    scores, dis = net({k: torch.from_numpy(v) for k, v in batch.items()},
                      gen=torch.Generator().manual_seed(0))
    loss, _ = L.total_loss(scores, torch.from_numpy(batch["label"]), dis)
    loss.backward()
    # CPU tensors take the plain versions: no kernel launch is counted
    assert (TTA.train_swin_block.launches,
            TTA.window_attention_train.launches) == before
    np.testing.assert_allclose(loss.item(), ref_loss, rtol=1e-5)

    sd = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
          for n, p in net.named_parameters()}
    sd.update({n: b.numpy() for n, b in net.named_buffers()})
    got, _ = convert_ksvqe_full(sd, depths=cfg.depths,
                                clip_layers=cfg.clip_layers,
                                contrique_layers=cfg.contrique_layers)
    flat_ref = jax.tree_util.tree_flatten_with_path(ref_grads)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_ref) == len(flat_got)
    for path, want in flat_ref:
        _grad_close(flat_got[path], want, jax.tree_util.keystr(path))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_tiny_ksvqe_train_route_loss_and_grads_match_jax(weights,
                                                         use_pallas):
    """The tiny KSVQE at tuning_stage 1.  With use_pallas the JAX side runs
    its train kernels (K4, K5) in interpret mode and the port its kernel
    route (plain versions on the CPU)."""
    cfg, params, stats = weights
    _check_train_route(cfg, params, stats, use_pallas)


@pytest.mark.parametrize("a2", [2.0, 0.0])
def test_tiny_ksvqe_tuning_stage_2_train_loss_and_grads_match_jax(a2):
    """At tuning_stage 2 (config/Kwai_KSVQE_test.yml, a2 2;
    config/Kwai_KSVQE_nopretrain.yml, a2 0), on the kernel route: the CDM
    of stages 2-3 carried across by its index, its gradients held as
    above (at a2 0 the semantic branch's are zero on both sides)."""
    cfg, _, _, params, stats = jax_weights_at(a2=a2, **TS2)
    _check_train_route(cfg, params, stats, True, a2=a2, **TS2)


def _train_block_pair(dims, use_frag):
    jb, jv, tb, x = _block_pair(dims, True, use_frag, use_pallas=True)
    tb.train()
    dy = np.random.default_rng(11).normal(size=x.shape).astype(np.float32)

    def f(p, a):
        return jnp.vdot(jb.apply({"params": p}, a, train=True), dy)

    out = jax.jit(lambda p, a: jb.apply({"params": p}, a, train=True))(
        jv["params"], jnp.asarray(x))
    gp, gx = jax.grad(f, argnums=(0, 1))(jv["params"], jnp.asarray(x))
    xt = _t(x).requires_grad_()
    y = tb(xt)
    y.backward(_t(dy))
    return out, gp, gx, y, xt, tb


@pytest.mark.parametrize("dims,use_frag", [
    ((3, 10, 10), True),    # padded dims: the K5 route (plain on the CPU)
    ((4, 14, 14), True),    # pad-free: the K4 route
])
def test_swin_block_train_routes_match_jax(dims, use_frag):
    out, gp, gx, y, xt, tb = _train_block_pair(dims, use_frag)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(out),
                               atol=5e-5)
    _grad_close(xt.grad, gx, "x")
    a = tb.attn
    pairs = [(tb.norm1.weight, gp["norm1"]["scale"]),
             (tb.norm1.bias, gp["norm1"]["bias"]),
             (tb.norm2.weight, gp["norm2"]["scale"]),
             (a.relative_position_bias_table,
              gp["attn"]["relative_position_bias_table"]),
             (a.fragment_position_bias_table,
              gp["attn"]["fragment_position_bias_table"])]
    for mod, key in ((a.qkv, gp["attn"]["qkv"]), (a.proj, gp["attn"]["proj"]),
                     (tb.mlp.fc1, gp["mlp"]["fc1"]),
                     (tb.mlp.fc2, gp["mlp"]["fc2"])):
        pairs += [(mod.weight, np.asarray(key["kernel"]).T),
                  (mod.bias, key["bias"])]
    for i, (p, want) in enumerate(pairs):
        _grad_close(p.grad, want, f"param {i}")


def test_use_pallas_block_trains_every_parameter():
    """A training forward of a use_pallas block (K4 route) gives every
    block parameter a gradient; the eval kernel K1 refuses autograd."""
    _, _, tb, x = _block_pair((4, 14, 14), True, True, use_pallas=True)
    tb.train()
    tb(_t(x)).square().sum().backward()
    for name, p in tb.named_parameters():
        assert p.grad is not None and float(p.grad.abs().sum()) > 0, name
    from kvq_tpu_torch.ops import window_attention as TWA

    params = dict(tb.block_params())
    geo = tb._geometry(1, (4, 14, 14), (2, 7, 7), (0, 0, 0), 16)
    xw = torch.zeros(geo.n_windows, geo.n_tokens, 16)
    rel, frag = tb.attn.bias_planes(geo.n_tokens)
    with pytest.raises(RuntimeError, match="no backward"):
        TWA.fused_swin_block(xw, params, rel, frag, geo)
    with torch.no_grad():
        TWA.fused_swin_block(xw, params, rel, frag, geo)


def test_droppath_draws_agree_across_routes():
    """One generator seed gives the K4 route and the plain route the same
    DropPath draws (two per block, in a fixed order)."""
    from kvq_tpu_torch.nn.swin import SwinBlock3D

    _, _, tb, x = _block_pair((4, 14, 14), True, True, use_pallas=True)
    plain = SwinBlock3D(16, 2, (2, 7, 7), True, frag_bias=True,
                        use_pallas=False, drop_path=0.5)
    plain.load_state_dict(tb.state_dict())
    tb.drop_path.rate = 0.5
    outs = []
    for blk in (tb, plain):
        blk.train()
        xx = _t(np.concatenate([x] * 4))  # B = 4: masks differ by sample
        outs.append(blk(xx, torch.Generator().manual_seed(5)).detach())
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), atol=5e-5)
    with pytest.raises(ValueError, match="Generator"):
        plain(_t(x))


def test_perturbed_topk_matches_jax():
    from kvq_tpu.ops.topk import perturbed_topk as jtopk
    from kvq_tpu_torch.ops.topk import perturbed_topk

    b, d, nS, sigma = 3, 9, 4, 0.5
    x = np.random.default_rng(0).random((b, d)).astype(np.float32)
    g = np.random.default_rng(1).normal(size=(b, 2, d)).astype(np.float32)
    key = jax.random.key(3)
    noise = np.asarray(jax.random.normal(key, (b, nS, d)))  # JAX's own draw

    def f(a):
        return jnp.vdot(jtopk(a, key, 2, nS, sigma), g)

    ref = np.asarray(jtopk(jnp.asarray(x), key, 2, nS, sigma))
    ref_g = np.asarray(jax.grad(f)(jnp.asarray(x)))
    xt = _t(x).requires_grad_()
    ind = perturbed_topk(xt, _t(noise), 2, sigma)
    (ind * _t(g)).sum().backward()
    np.testing.assert_allclose(ind.detach().numpy(), ref, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), ref_g, rtol=1e-5, atol=1e-6)
    xt.grad = None
    (perturbed_topk(xt, _t(noise), 2, 1e-21) * _t(g)).sum().backward()
    assert not xt.grad.any()  # the sigma -> 0 guard


def test_losses_match_jax():
    rng = np.random.default_rng(2)
    pred = rng.normal(size=(6, 1)).astype(np.float32)
    lab = rng.normal(size=(6,)).astype(np.float32)
    np.testing.assert_allclose(
        float(L.plcc_loss(_t(pred), _t(lab))),
        float(JL.plcc_loss(jnp.asarray(pred), jnp.asarray(lab))), rtol=1e-5)
    np.testing.assert_allclose(
        float(L.rank_loss(_t(pred), _t(lab))),
        float(JL.rank_loss(jnp.asarray(pred), jnp.asarray(lab))), rtol=1e-5)
    loss, aux = L.total_loss([_t(pred)], _t(lab), torch.tensor(2.5), 0.3, 0.7)
    jloss, jaux = JL.total_loss([jnp.asarray(pred)], jnp.asarray(lab),
                                jnp.asarray(2.5), 0.3, 0.7)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    assert aux.keys() == jaux.keys()
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-6)


def test_optimizer_schedule_frozen_and_ema_match_jax():
    """Five AdamW steps (warmup 2, so the schedule crosses the warmup
    boundary) with backbone_lr_mult 0.5 and the KSVQE frozen patterns, and
    the EMA, against kvq_tpu.train.optim on the same gradients."""
    import optax

    from kvq_tpu.train import optim as JO
    from kvq_tpu_torch.train import optim as O

    rng = np.random.default_rng(0)
    shapes = {("KSVQE_backbone", "CLIP_tool", "blocks_0", "w"): (3, 2),
              ("KSVQE_backbone", "CLIP_tool", "adapter_layer_0", "w"): (4,),
              ("KSVQE_backbone", "distortion_tool", "conv", "w"): (2,),
              ("KSVQE_backbone", "stage0", "w"): (5,),
              ("KSVQE_head", "fc", "w"): (3,)}
    init = {k: rng.normal(size=s).astype(np.float32)
            for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(5)]

    def tree(flat):
        out = {}
        for path, a in flat.items():
            d = out
            for p in path[:-1]:
                d = d.setdefault(p, {})
            d[path[-1]] = jnp.asarray(a)
        return out

    jparams = tree(init)
    tx = JO.build_optimizer(jparams, lr=1e-2, weight_decay=0.05,
                            warmup_iters=2, max_iters=5,
                            backbone_lr_mult=0.5,
                            frozen_patterns=JO.KSVQE_FROZEN_PATTERNS)
    jstate = tx.init(jparams)
    jema = jparams

    root = torch.nn.Module()
    for path, a in init.items():
        mod = root
        for p in path[:-1]:
            if not hasattr(mod, p):
                mod.add_module(p, torch.nn.Module())
            mod = getattr(mod, p)
        mod.register_parameter(path[-1], torch.nn.Parameter(_t(a.copy())))
    O.freeze(root, O.KSVQE_FROZEN_PATTERNS)
    opt, sched = O.build_optimizer(root.named_parameters(), lr=1e-2,
                                   weight_decay=0.05,
                                   warmup_iters=2, max_iters=5,
                                   backbone_lr_mult=0.5)
    named = dict(root.named_parameters())
    ema = [p.detach().clone() for p in named.values()]
    for step, g in enumerate(grads):
        assert np.isclose(sched.get_last_lr()[0],
                          float(JO.warmup_cosine_schedule(1e-2, 2, 5)(step)))
        upd, jstate = tx.update(tree(g), jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        jema = JO.ema_update(jema, jparams, 0.999)
        for path in shapes:
            p = named[".".join(path)]
            if p.requires_grad:
                p.grad = _t(g[path])
        opt.step()
        sched.step()
        O.ema_update(ema, list(named.values()), 0.999)
        for (path, _), e in zip(shapes.items(), ema):
            want = jparams
            want_e = jema
            for p in path:
                want, want_e = want[p], want_e[p]
            np.testing.assert_allclose(named[".".join(path)].detach().numpy(),
                                       np.asarray(want), rtol=1e-5,
                                       atol=1e-6, err_msg=str(path))
            np.testing.assert_allclose(e.numpy(), np.asarray(want_e),
                                       rtol=1e-5, atol=1e-6)
    frozen = [n for n, p in named.items() if not p.requires_grad]
    assert frozen == ["KSVQE_backbone.CLIP_tool.blocks_0.w",
                      "KSVQE_backbone.distortion_tool.conv.w"]


def test_reference_routing_matches_jax_gates():
    """The port's copy of the reference's routing rule gives the JAX
    package's estimates at the shipped train shapes (B=4, T=32): stages
    0-2 take the fused train block, stage 3 the train attention."""
    from kvq_tpu.nn import swin as JS
    from kvq_tpu_torch.nn import reference_routing as R
    from kvq_tpu_torch.nn.swin import get_window_size
    from kvq_tpu_torch.ops.window_attention import WindowGeometry

    stages = [((16, 56, 56), 96, 3, True), ((16, 28, 28), 192, 6, True),
              ((16, 14, 14), 384, 12, True), ((16, 7, 7), 768, 24, False),
              ((4, 6, 6), 16, 2, True)]
    fused = []
    for dims, C, h, frag in stages:
        for cfg_shift in ((0, 0, 0), (4, 3, 3)):
            win, shift = get_window_size(dims, (8, 7, 7), cfg_shift)
            kw = dict(batch=4, dims=dims, window=win, shift=shift,
                      fragments=(1, 7, 7), num_heads=h, head_dim=C // h,
                      use_frag=frag)
            geo, jgeo = WindowGeometry(**kw), WA.WindowGeometry(**kw)
            assert R.fused_block_vmem_bytes(geo, C, 4 * C) == \
                JS.fused_block_vmem_bytes(jgeo, C, 4 * C)
            assert R.train_block_vmem_bytes(geo, C, 4 * C) == \
                WA.train_block_vmem_bytes(jgeo, C, 4 * C)
            fused.append(R.takes_fused_block(geo, C, 4 * C, train=True))
    assert fused == [True] * 6 + [False] * 2 + [True] * 2


def _trainer_batch(seed):
    return _packed_batch(B=4, T=8, seed=seed)


def test_trainer_steps_save_load_resume(tmp_path):
    from kvq_tpu_torch.train.trainer import Trainer

    cfg = dict(tiny_config(use_pallas=True, s2d_input=True),
               warmup_epochs=1, num_epochs=4)
    tr = Trainer(cfg, device="cpu", seed=0, steps_per_epoch=2)
    init = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    frozen = [n for n, p in tr.model.named_parameters()
              if not p.requires_grad]
    assert frozen and all("CLIP_tool" in n or "distortion_tool" in n
                          for n in frozen)
    for i in range(2):
        aux = tr.train_step(_trainer_batch(i))
        assert np.isfinite(aux["total_loss"])
    assert tr.step == 2
    path = str(tmp_path / "state.pt")
    tr.save(path)
    last = tr.train_epoch([_trainer_batch(2)])
    assert tr.step == 3 and np.isfinite(last["total_loss"])
    after = dict(tr.model.named_parameters())
    for n in frozen:
        assert torch.equal(after[n], init[n]), n
    moved = [n for n, p in after.items() if not torch.equal(p, init[n])]
    assert moved and set(moved).isdisjoint(frozen)
    ema_moved = [torch.equal(e, init[n]) for e, n in zip(tr.ema, init)]
    assert not all(ema_moved)

    resumed = Trainer(cfg, device="cpu", seed=1, steps_per_epoch=2)
    resumed.load(path)
    assert resumed.step == 2
    again = resumed.train_step(_trainer_batch(2))
    assert again == last
    for (n, p), q in zip(tr.model.named_parameters(),
                         resumed.model.parameters()):
        assert torch.equal(p, q), n
    for e, f in zip(tr.ema, resumed.ema):
        assert torch.equal(e, f)


def test_train_batch_prep():
    from kvq_tpu_torch.data.pipeline import train_fields, train_host_tensors

    fields = train_fields(["KSVQE"])
    b = dict(_trainer_batch(0), video_name=["a"] * 4)
    host = train_host_tensors(b, fields, torch.bfloat16, pin=False)
    assert set(host) == {"fragment", "resize_video", "label", "dis_label"}
    assert host["fragment"].dtype == torch.bfloat16
    assert host["fragment"].shape == b["fragment"].shape  # no clip reshape
    assert host["label"].dtype == torch.float32
    with pytest.raises(KeyError):
        train_host_tensors({"fragment": b["fragment"]}, fields, None,
                           pin=False)

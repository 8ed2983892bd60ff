"""SwinConfig's ``drop_rate``, ``attn_drop_rate``, ``jump_attention`` and
``input_key`` (kvq_tpu/nn/swin.py:765-781) in the port, against kvq_tpu.

swin_2d_tiny at tiny widths takes each field as an override on both sides;
JAX's weights (its ``init``, redrawn) are carried over by ``from_jax``; the
inputs are seeded numpy; float32 on the CPU, where the port's kernel
wrappers run their plain versions.  Tolerances: eval features and a
VQAHead's score atol 1e-5 (JAX on its XLA path).  In training the masks of
the two packages come from different generators, so nothing is compared
bit for bit: the route each block takes (counted at the port's kernel
wrappers, the table of kvq_tpu/nn/swin.py:611-660) and the kept share of
every dropout mask, within 5 binomial standard deviations of 1 - rate.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kvq_tpu.nn import heads as JH
from kvq_tpu.nn import swin as JS
from kvq_tpu_torch.core.from_jax import state_dict_from_jax
from kvq_tpu_torch.nn import heads as H
from kvq_tpu_torch.nn import layers as L
from kvq_tpu_torch.nn import swin as S

from test_torch_convnext import _init, _x

TINY = dict(embed_dim=16, depths=(2, 2, 1, 1), num_heads=(2, 2, 4, 8),
            drop_path_rate=0.0, use_checkpoint=False)
JUMP = (False, True, False, False)
FIELDS = {
    "jump_attention": dict(jump_attention=JUMP),
    "drop": dict(drop_rate=0.3),
    "attn_drop": dict(attn_drop_rate=0.3),
    "both": dict(drop_rate=0.2, attn_drop_rate=0.4, jump_attention=JUMP),
}


def _t(a):
    return torch.from_numpy(np.array(a))


def _pair(x, key="technical", **fields):
    """JAX swin_2d_tiny (tiny widths, ``fields``) + VQAHead, and the port's
    loaded from their weights."""
    jm = JS.swin_2d_tiny(**TINY, **fields)
    p = _init(jm, {key: jnp.asarray(x)})
    jh = JH.VQAHead(hidden_channels=16)
    hp = _init(jh, jnp.zeros((1, 1, 1, 1, 128)))
    m = S.swin_2d_tiny(use_pallas=True, **TINY, **fields)
    pre = "swin_2d_tiny_backbone."
    sd = state_dict_from_jax({"swin_2d_tiny_backbone": p})
    m.load_state_dict({k[len(pre):]: v for k, v in sd.items()}, strict=True)
    head = H.VQAHead(128, 16)
    head.load_state_dict({k.split(".", 1)[1]: v for k, v in
                          state_dict_from_jax({"h_head": hp}).items()},
                         strict=True)
    return jm, p, jh, hp, m.eval(), head.eval()


@pytest.mark.parametrize("fields", list(FIELDS), ids=list(FIELDS))
def test_eval_matches_jax(fields):
    """At eval every rate is inert and a jumped stage has no attention
    half (and no attention parameters: the strict load holds it)."""
    x = _x((1, 2, 56, 56, 3), seed=3)
    jm, p, jh, hp, m, head = _pair(x, **FIELDS[fields])
    feat = jax.jit(lambda b: jm.apply({"params": p}, b))(
        {"technical": jnp.asarray(x)})
    want = np.asarray(jh.apply({"params": hp}, feat))
    with torch.no_grad():
        got = m({"technical": _t(x)})
        score = head(got)
    np.testing.assert_allclose(got.numpy(), np.asarray(feat), atol=1e-5)
    np.testing.assert_allclose(score.numpy(), want, atol=1e-5)
    jumped = FIELDS[fields].get("jump_attention", (False,) * 4)
    for i, stage in enumerate(m.layers):
        for blk in stage.blocks:
            assert hasattr(blk, "attn") != jumped[i]


def test_input_key_matches_jax():
    x = _x((1, 2, 56, 56, 3), seed=4)
    jm, p, _, _, m, _ = _pair(x, key="aesthetic", input_key="aesthetic")
    feat = jax.jit(lambda b: jm.apply({"params": p}, b))(
        {"aesthetic": jnp.asarray(x)})
    with torch.no_grad():
        got = m({"aesthetic": _t(x), "technical": _t(x[:, :, :28])})
    np.testing.assert_allclose(got.numpy(), np.asarray(feat), atol=1e-5)
    with pytest.raises(KeyError):
        m({"technical": _t(x)})
    cfg = S.swin_2d_tiny(input_key="aesthetic").config
    jcfg = JS.swin_2d_tiny(input_key="aesthetic").config
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name


def _spied(monkeypatch):
    """Count the block routes (K1, K4, K5, K3) at the port's wrappers and
    record every dropout mask drawn: (rate, kept, total)."""
    calls, masks = [], []
    for name, tag in (("fused_swin_block", "K1"), ("train_swin_block", "K4"),
                      ("window_attention_train", "K5"),
                      ("flash_window_attention_packed", "K3")):
        real = getattr(S, name)
        monkeypatch.setattr(S, name, lambda *a, _r=real, _t=tag, **k: (
            calls.append(_t), _r(*a, **k))[1])
    real_keep = L.keep_multipliers

    def keep(shape, rate, gen, device):
        m = real_keep(shape, rate, gen, device)
        masks.append((rate, int((m > 0).sum()), m.numel()))
        return m

    monkeypatch.setattr(L, "keep_multipliers", keep)
    return calls, masks


# (fields, routes of a training forward, routes at eval): the four blocks of
# stages 0-1 and one of each of stages 2-3, stage 1 jumped where asked
ROUTES = [
    ({}, ["K4"] * 6, ["K1"] * 6),
    (dict(jump_attention=JUMP), ["K4"] * 4, ["K1"] * 4),
    (dict(drop_rate=0.3), ["K5"] * 6, ["K1"] * 6),
    (dict(attn_drop_rate=0.3), [], ["K1"] * 6),
    (dict(drop_rate=0.2, attn_drop_rate=0.4, jump_attention=JUMP), [],
     ["K1"] * 4),
]


@pytest.mark.parametrize("fields,train_routes,eval_routes", ROUTES,
                         ids=["none", "jump", "drop", "attn_drop", "all"])
def test_training_routes_and_kept_shares(fields, train_routes, eval_routes,
                                         monkeypatch):
    calls, masks = _spied(monkeypatch)
    m = S.swin_2d_tiny(use_pallas=True, **TINY, **fields)
    x = _t(_x((2, 2, 56, 56, 3), seed=5))
    with torch.no_grad():
        m.eval()(x)
    assert calls == eval_routes and masks == []
    del calls[:]
    m.train()(x, torch.Generator().manual_seed(0))
    assert calls == train_routes
    drop = fields.get("drop_rate", 0.0)
    attn = fields.get("attn_drop_rate", 0.0)
    jumped = sum(d for i, d in zip(range(4), fields.get("jump_attention",
                                                        (False,) * 4))
                 for _ in range(TINY["depths"][i]))
    blocks = sum(TINY["depths"])
    want = ((1 + 2 * blocks + (blocks - jumped)) * (drop > 0)
            + (blocks - jumped) * (attn > 0))
    assert len(masks) == want
    assert sorted({r for r, _, _ in masks}) == sorted(
        {r for r in (drop, attn) if r > 0})
    for rate, kept, n in masks:
        keep = 1.0 - rate
        assert abs(kept / n - keep) <= 5 * np.sqrt(keep * rate / n) + 1 / n


def test_remat_draws_the_same_dropout_masks():
    """With remat a block that drops draws its masks from a copy of the
    generator, the same in its forward and in its recompute: the loss and
    every gradient equal those without remat, and the generator ends where
    it would."""
    x = _t(_x((1, 2, 56, 56, 3), seed=6))
    out = []
    for remat in (False, True):
        cut = dict(TINY, use_checkpoint=remat)
        m = S.swin_2d_tiny(use_pallas=True, drop_rate=0.2,
                           attn_drop_rate=0.3, **cut)
        torch.manual_seed(0)
        for p in m.parameters():
            p.data.normal_(0, 0.1)
        g = torch.Generator().manual_seed(1)
        loss = m.train()(x, g).square().mean()
        loss.backward()
        out.append((float(loss.detach()),
                    [p.grad.clone() for p in m.parameters()],
                    torch.rand(1, generator=g)))
    (l0, g0, r0), (l1, g1, r1) = out
    assert l0 == l1 and torch.equal(r0, r1)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)

"""The port's full CLIP (both visual towers, the causal text encoder, the
joint logits), its tokenizer and its OpenAI-name loaders, against
kvq_tpu/nn/clip_model.py, kvq_tpu/data/tokenizer.py and kvq_tpu's
``convert_clip_full``.

Tiny widths, float32 on the CPU; the same numpy-seeded weights (the JAX
trees' leaves and ModifiedResNet's BatchNorm statistics redrawn, carried
into the port by ``kvq_tpu_torch.core.from_jax.map_clip_tree``) and inputs
go through both; the text is the tiny synthetic BPE of
tests/test_clip_full.py.  Tolerances: embeddings and logits atol 1e-5
(logits at the scale exp(logit_scale) ~ 1); token ids bit-equal.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kvq_tpu.core.torch_import import convert_clip_full
from kvq_tpu.data import tokenizer as JT
from kvq_tpu.nn import clip_model as JCM
from kvq_tpu_torch.core.from_jax import map_clip_tree
from kvq_tpu_torch.data import tokenizer as T
from kvq_tpu_torch.nn import clip_model as CM

from test_torch_convnext import random_stats, random_tree

ATOL = 1e-5
MERGES = [("l", "l"), ("h", "e"), ("he", "ll"), ("hell", "o</w>"),
          ("w", "o"), ("wo", "r"), ("wor", "l"), ("worl", "d</w>")]
TEXTS = ["Hello   WORLD", "hello", "world, hello! 42", "héllo &amp; wörld",
         "it's the world's"]
CTX = 16

VIT = JCM.CLIPConfig(embed_dim=16, vision_width=128, vision_layers=2,
                     vision_patch_size=8, image_resolution=32,
                     context_length=CTX, vocab_size=522,
                     transformer_width=128, transformer_heads=2,
                     transformer_layers=2)
RN = dataclasses.replace(VIT, vision_width=16, vision_layers=(1, 1, 1, 1),
                         vision_patch_size=None, image_resolution=64)


# ---------------------------------------------------------------------------
# tokenizer


def test_tokenizer_ids_match_kvq_tpu():
    jt, t = JT.SimpleTokenizer(merges=MERGES), T.SimpleTokenizer(merges=MERGES)
    assert t.vocab_size == jt.vocab_size == 522
    assert (t.sot_token, t.eot_token) == (jt.sot_token, jt.eot_token)
    assert T.bytes_to_unicode() == JT.bytes_to_unicode()
    for text in TEXTS:
        assert t.encode(text) == jt.encode(text), text
        assert t.decode(t.encode(text)) == jt.decode(jt.encode(text))
        assert T.whitespace_clean(T.basic_clean(text)) == \
            JT.whitespace_clean(JT.basic_clean(text))
    assert t.bpe("hello") == jt.bpe("hello") == "hello</w>"
    got = T.tokenize(TEXTS, t, context_length=CTX)
    want = JT.tokenize(TEXTS, jt, context_length=CTX)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    long = "hello " * 40
    np.testing.assert_array_equal(
        T.tokenize(long, t, CTX, truncate=True),
        JT.tokenize(long, jt, CTX, truncate=True))
    with pytest.raises(RuntimeError):
        T.tokenize(long, t, CTX)


def test_tokenizer_reads_a_merges_file(tmp_path):
    """A merges file (the reference's format: a header line, then one
    merge a line; gzip when named .gz) gives the ids of the same list."""
    import gzip

    path = tmp_path / "merges.txt.gz"
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(" ".join(m) for m in MERGES))
    t = T.SimpleTokenizer(str(path))
    jt = JT.SimpleTokenizer(merges=MERGES)
    for text in TEXTS:
        assert t.encode(text) == jt.encode(text)


# ---------------------------------------------------------------------------
# the model


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    r = cfg.image_resolution
    image = rng.normal(size=(3, r, r, 3)).astype(np.float32)
    text = JT.tokenize(TEXTS[:4], JT.SimpleTokenizer(merges=MERGES), CTX)
    return image, text


@functools.lru_cache(maxsize=None)
def _jax_clip_of(cfg):
    return _jax_clip(cfg, *_inputs(cfg))


def _jax_clip(cfg, image, text):
    """JAX CLIP with redrawn params (and statistics) and its outputs:
    (params, stats, (image embeddings, text embeddings, logits))."""
    model = JCM.CLIP(config=cfg)
    ji, jtxt = jnp.asarray(image), jnp.asarray(text)
    v = jax.jit(lambda i, t: model.init(jax.random.key(0), i, t))(ji, jtxt)
    params = random_tree(v["params"])
    stats = random_stats(v.get("batch_stats", {}))
    var = jax.tree.map(jnp.asarray, {"params": params, "batch_stats": stats})
    out = jax.jit(lambda i, t: (
        model.apply(var, i, method=model.encode_image),
        model.apply(var, t, method=model.encode_text),
        model.apply(var, i, t)[0]))(ji, jtxt)
    return params, stats, [np.asarray(o) for o in out]


def _port_outputs(net, image, text):
    with torch.no_grad():
        i, t = torch.from_numpy(image), torch.from_numpy(text).long()
        return [o.numpy() for o in (net.encode_image(i), net.encode_text(t),
                                    net(i, t)[0])]


@pytest.mark.parametrize("cfg", [VIT, RN], ids=["vit", "modified_resnet"])
def test_clip_matches_jax(cfg):
    """encode_image, encode_text (the causal mask, EOT pooling) and the
    logits, each tower."""
    image, text = _inputs(cfg)
    params, stats, want = _jax_clip_of(cfg)
    sd, unread = map_clip_tree(params, stats)
    assert not unread
    net = CM.CLIP(CM.CLIPConfig(**dataclasses.asdict(cfg)))
    net.load_state_dict(sd, strict=True)
    got = _port_outputs(net.eval(), image, text)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=ATOL)


def test_text_encoder_is_causal():
    """A token changes no earlier position's output: the text after the
    end-of-text token leaves the pooled embedding as it is."""
    net = CM.CLIP(CM.CLIPConfig(**dataclasses.asdict(VIT))).eval()
    for p in net.parameters():
        torch.nn.init.normal_(p, std=0.05)
    text = torch.from_numpy(_inputs(VIT)[1]).long()
    tail = text.clone()
    tail[text == 0] = 7  # text past EOT (the argmax) where padding was
    with torch.no_grad():
        np.testing.assert_allclose(net.encode_text(tail).numpy(),
                                   net.encode_text(text).numpy(), atol=1e-6)


@pytest.mark.parametrize("cfg", [VIT, RN], ids=["vit", "modified_resnet"])
def test_openai_state_dict_round_trips_through_kvq_tpu(cfg, tmp_path):
    """The port's state_dict() under OpenAI's names: kvq_tpu infers the
    same architecture from it and ``convert_clip_full`` gives the same
    logits; ``load_clip`` reads the file back."""
    image, text = _inputs(cfg, seed=1)
    params, stats, _ = _jax_clip_of(cfg)
    net = CM.CLIP(CM.CLIPConfig(**dataclasses.asdict(cfg)))
    net.load_state_dict(map_clip_tree(params, stats)[0], strict=True)
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    assert dataclasses.asdict(JCM.clip_config_from_state_dict(sd)) == \
        dataclasses.asdict(CM.clip_config_from_state_dict(sd)) == \
        dataclasses.asdict(cfg)
    jp, js = convert_clip_full(sd)
    model = JCM.CLIP(config=JCM.clip_config_from_state_dict(sd))
    var = jax.tree.map(jnp.asarray,
                       {"params": jp, **({"batch_stats": js} if js else {})})
    want = np.asarray(jax.jit(lambda i, t: model.apply(var, i, t)[0])(
        jnp.asarray(image), jnp.asarray(text)))
    path = str(tmp_path / "clip.pt")
    torch.save(net.state_dict(), path)
    loaded = CM.load_clip(path, device="cpu")
    for m in (net.eval(), loaded):
        np.testing.assert_allclose(_port_outputs(m, image, text)[2], want,
                                   atol=ATOL)


def test_logit_scale_starts_at_ln_1_over_0_07():
    net = CM.CLIP(CM.CLIPConfig(**dataclasses.asdict(VIT)))
    assert abs(net.logit_scale.item() - np.log(1 / 0.07)) < 1e-6

"""The JAX package's checkpoint files in the port, on the CPU.

Every file here is written by ``kvq_tpu`` in the test (its
``save_checkpoint``, its ``Trainer.save_full_state``, flax's
``msgpack_serialize``):

  - the reader: each leaf equals what ``flax.serialization.msgpack_restore``
    returns, bit for bit;
  - weights: ``test_load_path`` naming a ``{"params", "batch_stats"}``
    file, a best-weights file or a full state of the tiny KSVQE scores
    within atol 1e-5 of the JAX model on the same weights and batch (f32
    roundoff through ~40 layers, as tests/test_torch_ksvqe.py); a partial
    tree loads its leaves exactly and leaves the rest as they were;
  - resume: the JAX trainer's full state after two steps, resumed by the
    port's ``Trainer``; the next step's loss within rtol 1e-5 and the
    parameters, AdamW moments and EMA within rtol 1e-5 / atol 1e-6 of the
    JAX trainer's next step (a few f32 operations past the forward, as
    test_optimizer_schedule_frozen_and_ema_match_jax), the learning rate,
    the step and each moment's step equal;
  - refusal: an ``opt_state`` of another optimizer raises ``ValueError``
    and loads nothing.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import flax.serialization as ser
import jax
import jax.numpy as jnp

import kvq_tpu.models.heads_util as JH
import kvq_tpu.nn.ksvqe as JK
import kvq_tpu.ops.window_attention as WA
from kvq_tpu.core import checkpoint as jckpt
from kvq_tpu.core.torch_import import convert_ksvqe_full
from kvq_tpu.nn.heads import VQAHead as JVQAHead
from kvq_tpu.train import optim as JO
from kvq_tpu.train.trainer import Trainer as JTrainer
from kvq_tpu.train.trainer import array_batch, ser_to_state
from kvq_tpu_torch.core import msgpack_io
from kvq_tpu_torch.core.checkpoint import (
    is_msgpack, load_checkpoint, load_weights)
from kvq_tpu_torch.core.from_jax import state_dict_from_jax
from kvq_tpu_torch.models.vqa_network import build_model
from kvq_tpu_torch.train.evaluator import Evaluator
from kvq_tpu_torch.train.trainer import Trainer

from test_torch_ksvqe import _jax_scores, _packed, jax_weights_at
from test_torch_modules import _batch, tiny_config

CFG = dict(use_pallas=True, s2d_input=True)


# ------------------------------------------------------------------ reader
def _equal(got, want, path="") -> None:
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            _equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, np.ndarray) and want.dtype == jnp.bfloat16:
        assert isinstance(got, torch.Tensor), path
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      want.view(np.int16), err_msg=path)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


def _tree():
    rng = np.random.default_rng(0)
    opt = JO.build_optimizer(
        {"CLIP_tool": {"w": jnp.ones(3)}, "stage": {"w": jnp.ones((2, 2))}},
        lr=1e-3, weight_decay=0.05, warmup_iters=1, max_iters=4,
        frozen_patterns=JO.KSVQE_FROZEN_PATTERNS)
    return {
        "f32": rng.normal(size=(3, 4)).astype(np.float32),
        "bf16": jnp.asarray(rng.normal(size=(5, 2)), jnp.bfloat16),
        "int32": np.arange(6, dtype=np.int32).reshape(2, 3),
        "uint8": rng.integers(0, 255, (4,), dtype=np.uint8),
        "f64_scalar": np.float64(2.5),
        "nested": {"a": {"b": np.zeros((0, 2), np.float32),
                         "c": np.asarray(7, np.int32)}},
        "empty": {},
        "masked_state": ser_to_state(opt.init(
            {"CLIP_tool": {"w": jnp.ones(3)}, "stage": {"w": jnp.ones((2, 2))}})),
    }


@pytest.mark.parametrize("writer", ["save_checkpoint", "msgpack_serialize",
                                    "chunked"])
def test_reader_matches_flax_restore(tmp_path, monkeypatch, writer):
    """Every leaf kvq_tpu writes (through save_checkpoint, which turns
    every leaf into an ndarray; through flax's own serializer, which also
    writes numpy scalars and complex numbers; and with arrays chunked, as
    flax stores those over 2^30 bytes) reads back as flax restores it."""
    tree = _tree()
    path = tmp_path / "t.msgpack"
    if writer == "save_checkpoint":
        jckpt.save_checkpoint(str(path), tree)
    else:
        tree.update(np_scalar=np.float32(1.25), i64=np.int64(-3),
                    bf16_scalar=jnp.bfloat16(0.5), cplx=complex(1.5, -2.0),
                    text="kvq", number=3, flag=True)
        if writer == "chunked":
            monkeypatch.setattr(ser, "MAX_CHUNK_SIZE", 16)
        path.write_bytes(ser.msgpack_serialize(tree))
    want = ser.msgpack_restore(path.read_bytes())
    if writer == "chunked":
        assert "__msgpack_chunked_array__" in str(
            __import__("msgpack").unpackb(path.read_bytes(),
                                          strict_map_key=False)["f32"])
    got = load_checkpoint(str(path))
    _equal(got, want)
    assert got["masked_state"]["0"]["inner_state"]["0"]["mu"]["CLIP_tool"] \
        == {"w": {}}  # a masked leaf: an empty state


def test_file_kind_is_read_from_the_content(tmp_path):
    """A JAX file named .pt and a torch file named .msgpack are each read
    as what they are."""
    jax_file, torch_file = tmp_path / "w.pt", tmp_path / "w.msgpack"
    jckpt.save_checkpoint(str(jax_file), {"params": {"a": np.ones(2)}})
    torch.save({"params": {"a": torch.ones(2)}}, torch_file)
    assert is_msgpack(str(jax_file)) and not is_msgpack(str(torch_file))
    assert isinstance(load_checkpoint(str(jax_file))["params"]["a"],
                      np.ndarray)
    assert isinstance(load_checkpoint(str(torch_file))["params"]["a"],
                      torch.Tensor)
    assert not msgpack_io.is_torch_file(b"\x80")  # msgpack's empty map


# ----------------------------------------------------------------- weights
@pytest.fixture(scope="module")
def jax_model():
    return jax_weights_at()


def _scores_through_test_load_path(path, batch):
    n = len(batch["label"])
    config = dict(tiny_config(**CFG), test_load_path=str(path),
                  eval_batch_size=n)
    ev = Evaluator(config, device="cpu")
    return np.asarray([s for _, _, p in ev.scored_batches([batch])
                       for s in p])


@pytest.mark.parametrize("kind", ["convert", "best_weights"])
def test_jax_weights_file_scores_as_jax(jax_model, tmp_path, kind):
    """``test_load_path`` naming a file kvq_tpu wrote: cli.convert's
    ``{"params", "batch_stats"}`` or a best-weights file (with its
    validation results)."""
    cfg, v, hv, params, stats = jax_model
    state = {"params": params, "batch_stats": stats}
    if kind == "best_weights":
        state["validation_results"] = np.asarray([0.5, 0.4, 0.3, 0.2])
    path = tmp_path / "tiny.ckpt"
    jckpt.save_checkpoint(str(path), state)
    batch = _packed(_batch(B=2, T=8, seed=4))
    flags = (WA.ALLOW_CPU_PALLAS, WA.EVAL_INTERPRET)
    WA.ALLOW_CPU_PALLAS = WA.EVAL_INTERPRET = True
    try:
        ref, _ = _jax_scores(dataclasses.replace(cfg, **CFG), v, hv, batch)
    finally:
        WA.ALLOW_CPU_PALLAS, WA.EVAL_INTERPRET = flags
    got = _scores_through_test_load_path(path, batch)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_partial_tree_grafts_what_it_has(jax_model, tmp_path, capsys):
    """A file without the head, without CONTRIQUE's statistics and with an
    extra leaf: the leaves it holds load exactly, the rest keep their
    initial values, and the report counts as merge_params would."""
    _, _, _, params, stats = jax_model
    backbone = {k: v for k, v in params["KSVQE_backbone"].items()
                if k != "dist_adapter"}
    backbone["not_a_module"] = {"w": np.ones(3, np.float32)}
    path = tmp_path / "partial.msgpack"
    jckpt.save_checkpoint(str(path), {"params": {"KSVQE_backbone": backbone}})
    model = build_model(tiny_config(**CFG), device="cpu", seed=0)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    report = load_weights(model, str(path))
    assert "loaded" in capsys.readouterr().out
    full = build_model(tiny_config(**CFG), device="cpu", seed=1)
    full.load_state_dict(state_dict_from_jax(params, stats))
    want = full.state_dict()
    got = model.state_dict()
    loaded = [k for k in got if k.startswith("KSVQE_backbone.")
              and ".dist_adapter." not in k and "running_" not in k
              and "num_batches" not in k]
    kept = [k for k in got if k not in loaded]
    assert loaded and kept
    for k in loaded:
        assert torch.equal(got[k], want[k]), k
    for k in kept:
        assert torch.equal(got[k], init[k]), k
    assert sorted(report["missing"]) == sorted(kept)
    assert report["unexpected"] == ["KSVQE_backbone/not_a_module/w"]
    assert report["mismatched"] == []


# ------------------------------------------------------------------ resume
RESUME_CONFIG = dict(
    tiny_config(use_pallas=False, s2d_input=True, drop_path_rate=0.0,
                sigma=0.0),
    warmup_epochs=1, num_epochs=6, ema=True, ema_decay=0.999,
    optimizer={"lr": 1e-3, "wd": 0.05})


def _train_batch(seed):
    return _packed(_batch(B=4, T=8, seed=seed))


@pytest.fixture(scope="module")
def jax_resume(tmp_path_factory):
    """The JAX trainer after two steps, its full state written, then its
    next step.  Its head dropout is off and its QRS sigma 0 (its config
    reader takes no ``sigma``), as the port's below and as
    tests/test_torch_train.py sets them: both steps are deterministic."""
    root = tmp_path_factory.mktemp("resume")
    mp = pytest.MonkeyPatch()
    mp.setattr(JH, "VQAHead", functools.partial(JVQAHead, dropout_ratio=0.0))
    read_config = JK.ksvqe_config
    mp.setattr(JK, "ksvqe_config",
               lambda bb: dataclasses.replace(read_config(bb), sigma=0.0))
    try:
        tr = JTrainer(RESUME_CONFIG, workdir=str(root))
        tr.build_models(_train_batch(0))
        rng = jax.random.key(0)
        for i in range(2):
            tr.state, _ = tr._train_step(tr.state,
                                         array_batch(_train_batch(i)), rng)
        path = root / "tiny_last_state.msgpack"
        tr.best, tr.best_ema = (0.5, 0.4, 0.3, 0.2), (0.6, 0.5, 0.4, 0.1)
        tr.save_full_state(str(path))
        saved = tr.state
        nxt, aux = tr._train_step(saved, array_batch(_train_batch(2)), rng)
    finally:
        mp.undo()
    return path, saved, nxt, {k: float(v) for k, v in aux.items()}


def _port_trainer(config=RESUME_CONFIG, seed=5):
    tr = Trainer(config, device="cpu", seed=seed, steps_per_epoch=1)
    tr.model.KSVQE_head.dropout_ratio = 0.0
    return tr


def _as_jax(tr, values):
    """Port per-parameter tensors (``values[name]``; zeros for frozen
    parameters) -> the JAX params tree, through kvq_tpu's own converter."""
    sd = {k: v.numpy() for k, v in tr.model.state_dict().items()}
    for n, p in tr.model.named_parameters():
        sd[n] = values.get(n, torch.zeros_like(p)).detach().numpy()
    return convert_ksvqe_full(sd, depths=(1, 1), clip_layers=2,
                              contrique_layers=(1, 1, 1, 1))[0]


def _flat(tree):
    return dict(jax.tree_util.tree_flatten_with_path(tree)[0])


def _close_tree(got, want, what):
    flat_want, flat_got = _flat(want), _flat(got)
    assert flat_want
    for path, leaf in flat_want.items():
        np.testing.assert_allclose(
            flat_got[path], np.asarray(leaf), rtol=1e-5, atol=1e-6,
            err_msg=f"{what} {jax.tree_util.keystr(path)}")


def _updated_params_close(got, want, mu, lr):
    """The parameters after an AdamW step.  Where the first moment exceeds
    its own tolerance (|mu| > 1e-6), it fixes the update's direction: rtol
    1e-5, atol 1e-6.  Elsewhere the gradients are f32 roundoff (key
    biases, which the softmax's shift invariance gives a zero gradient; the
    head's last bias, PLCC being shift-invariant; the semantic FiLM's
    beta), which Adam's normalisation m / sqrt(v) turns into steps of up to
    about lr in a direction neither side's roundoff fixes: there the two
    agree within 2 lr.  Frozen parameters (no moment) must not move.  The
    tight check must cover most of the trainable elements (64 % at this
    tiny width)."""
    flat_want, flat_got, flat_mu = _flat(want), _flat(got), _flat(mu)
    resolved = total = 0
    for path, leaf in flat_want.items():
        g, w = np.asarray(flat_got[path]), np.asarray(leaf)
        where = jax.tree_util.keystr(path)
        if path not in flat_mu:
            np.testing.assert_array_equal(g, w, err_msg=where)
            continue
        ok = np.abs(np.asarray(flat_mu[path])) > 1e-6
        np.testing.assert_allclose(g[ok], w[ok], rtol=1e-5, atol=1e-6,
                                   err_msg=where)
        assert np.abs(g - w)[~ok].max(initial=0.0) <= 2 * lr, where
        resolved, total = resolved + ok.sum(), total + ok.size
    assert resolved > 0.5 * total, (resolved, total)


def test_resume_jax_full_state_then_step_matches_jax(jax_resume):
    path, saved, nxt, aux = jax_resume
    tr = _port_trainer()
    tr.load(str(path))
    assert tr.step == 2 and tr.best == (0.5, 0.4, 0.3, 0.2)
    assert tr.best_ema == (0.6, 0.5, 0.4, 0.1)
    # the state as loaded: the JAX trainer's after two steps
    named = dict(tr.model.named_parameters())
    _close_tree(_as_jax(tr, named), saved.params, "params")
    got = tr.train_step(_train_batch(2))
    np.testing.assert_allclose(got["total_loss"], aux["total_loss"],
                               rtol=1e-5)
    assert tr.step == int(nxt.step) == 3
    adam = nxt.opt_state[0].inner_state[0]
    lr = float(JO.warmup_cosine_schedule(1e-3, 1, 6)(2))  # this step's
    _updated_params_close(_as_jax(tr, named), nxt.params, adam.mu, lr)
    names = [n for n, _ in tr.model.named_parameters()]
    _close_tree(_as_jax(tr, dict(zip(names, tr.ema))), nxt.ema_params, "ema")
    for key, ref in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        moments = {n: tr.optimizer.state[p][key] for n, p in named.items()
                   if p in tr.optimizer.state}
        _close_tree(_as_jax(tr, moments), ref, key)
    steps = {float(s["step"]) for s in tr.optimizer.state.values()}
    assert steps == {float(adam.count)} == {3.0}
    want_lr = float(JO.warmup_cosine_schedule(1e-3, 1, 6)(int(adam.count)))
    np.testing.assert_allclose(tr.schedule.get_last_lr()[0], want_lr,
                               rtol=1e-6)
    np.testing.assert_allclose(tr.optimizer.param_groups[0]["lr"], want_lr,
                               rtol=1e-6)


def test_full_state_as_load_path_takes_its_weights(jax_resume, capsys):
    """``load_path`` naming a full state: only its params and batch_stats
    are taken (the model equals the saved params; the optimizer is new)."""
    path, saved, _, _ = jax_resume
    tr = _port_trainer(dict(RESUME_CONFIG, load_path=str(path)))
    assert "loaded" in capsys.readouterr().out
    named = dict(tr.model.named_parameters())
    _close_tree(_as_jax(tr, named), saved.params, "params")
    assert tr.step == 0 and not tr.optimizer.state


@pytest.mark.parametrize("mismatch", ["no_frozen_mask", "scale_appended",
                                      "moment_missing"])
def test_mismatched_opt_state_raises(jax_resume, tmp_path, mismatch):
    """An opt_state of another optimizer (no frozen mask; a backbone_lr_mult
    the config does not set; a moment short) raises ValueError, and the
    trainer keeps its state."""
    path, saved, _, _ = jax_resume
    state = jckpt.load_checkpoint(str(path))
    if mismatch == "moment_missing":
        mu = state["opt_state"]["0"]["inner_state"]["0"]["mu"]
        del mu["KSVQE_head"]["fc_last"]
    else:
        tx = JO.build_optimizer(
            saved.params, lr=1e-3, weight_decay=0.05, warmup_iters=1,
            max_iters=6,
            backbone_lr_mult=0.5 if mismatch == "scale_appended" else 1.0,
            frozen_patterns=(JO.KSVQE_FROZEN_PATTERNS
                             if mismatch == "scale_appended" else ()))
        state["opt_state"] = ser_to_state(tx.init(saved.params))
    bad = tmp_path / "bad.msgpack"
    jckpt.save_checkpoint(str(bad), state)
    tr = _port_trainer()
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    with pytest.raises(ValueError, match="opt_state"):
        tr.load(str(bad))
    assert tr.step == 0 and not tr.optimizer.state
    after = tr.model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)

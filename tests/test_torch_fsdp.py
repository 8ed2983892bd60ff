"""The port's (data, fsdp) layout (kvq_tpu_torch/parallel/fsdp.py, the
parameter rule of parallel/sharding.py, make_mesh and the dry run of
parallel/dryrun.py) against the JAX package's, on the CPU.

The port runs in one spawned gloo world of 4 ranks, data 2 x fsdp 2, that
every scenario shares (tests/_torch_ddp_worker.py, test_torch_parallel.py's
``World``); this process runs JAX's ``make_sharded_train_step`` on
``make_mesh(data=2, fsdp=2)`` of conftest's virtual CPU devices, and the
one-process references.  Inputs are seeded numpy; the weights JAX's
``init``, carried over by ``core/from_jax.py``.  ``min_size`` is 2**12 on
both sides (no parameter of the tiny models reaches JAX's 2**17 on a
trainable Swin layer); the tiny KSVQE is 32 wide, so that its stage-1 MLP
(64 -> 256) is trainable and sharded.  Tolerances:

  - the sharded parameters and each one's shard shape: equal to JAX's
    ``param_shardings``, by name (the JAX spec carried into the port's
    layout through ``from_jax``'s own maps);
  - tiny KSVQE (QRS sigma 0, DropPath 0, head in eval: the random parts
    off on both sides), one row a rank: the loss terms rtol 1e-5 against
    JAX's sharded step; the reduced gradient, assembled from the shards,
    by ``_grad_close`` (atol 2e-4 x scale, rtol 1e-3) against JAX's first
    moment / (1 - b1); the gathered parameters, moments and EMA after the
    step rtol 1e-5 / atol 1e-6, except where JAX's gradient is below 1e-6,
    above the f32 roundoff of these gradients (the two packages' gradients
    differ by 100 % of values up to ~3e-7, a third of the elements at
    this width are below 1e-6): AdamW's first
    update, lr x g / (|g| + eps), turns that roundoff into a change of the
    update itself (up to lr x its sign), so those elements are held to one
    update, 2 x lr (the EMA to 2 x lr x (1 - decay)), and every updated
    parameter to AdamW's first step on the port's own gradient within
    1e-6;
  - the same step against the port's one-process Trainer on the whole
    batch: loss terms rtol 1e-6;
  - tiny SimpleVQA, BatchNorm over the whole batch: the running statistics
    rtol 1e-5 / atol 1e-6 and the loss rtol 1e-5 against JAX's sharded
    step; the reduced gradient of the same step in float64 against JAX's
    float64 gradient by ``_grad_close``, as test_torch_parallel.py holds
    the DDP step (f32 gradients of this ReLU network move by percents
    where a pre-activation sits within roundoff of 0);
  - each rank's bytes of masters, moments and EMA of the sharded
    parameters: exactly 1/fsdp of a replicated state's;
  - the sharded eval's gathered rows: the one-process Evaluator's scores
    atol 1e-6;
  - ``dryrun_multichip(4)``: finite losses for the three flavours.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.serialization import to_state_dict

from kvq_tpu.parallel import sharding as jsharding
from kvq_tpu.parallel import steps as jsteps
from kvq_tpu.parallel.mesh import make_mesh as jmake_mesh
from kvq_tpu.train import optim as joptim
from kvq_tpu.train.trainer import Trainer as JTrainer
from kvq_tpu.train.trainer import TrainState, array_batch
from kvq_tpu_torch.core.from_jax import (
    adamw_state_from_jax,
    map_jax_tree,
    state_dict_from_jax,
)
from kvq_tpu_torch.models.vqa_network import VQANetwork, build_train_model
from kvq_tpu_torch.parallel.sharding import param_shardings
from kvq_tpu_torch.train.evaluator import Evaluator
from kvq_tpu_torch.train.trainer import Trainer

from test_torch_ksvqe import jax_weights_at
from test_torch_modules import tiny_config
from test_torch_parallel import World, _KSVQEHeadInEval
from test_torch_simplevqa import _jax_grads_f64, _np_tree, svqa_batch, svqa_cfg
from test_torch_train import _grad_close, _packed_batch

MIN_SIZE = 2 ** 12
LR = 1e-3
KSVQE_CFG = dict(
    tiny_config(use_pallas=True, s2d_input=True, drop_path_rate=0.0,
                sigma=0.0, embed_dim=32),
    ema=True, warmup_epochs=0, num_epochs=4,
    optimizer={"lr": LR, "wd": 0.05})
SVQA_CFG = svqa_cfg(warmup_epochs=0, num_epochs=4, ema=True,
                    optimizer={"lr": LR, "wd": 0.05})
SCENARIOS = ("fsdp_ksvqe", "fsdp_svqa", "fsdp_svqa_f64", "fsdp_dryrun")


def _jax_mesh():
    return jmake_mesh(data=2, fsdp=2, devices=jax.devices()[:4])


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The inputs the 4 ranks read, and the JAX models they mirror."""
    root = tmp_path_factory.mktemp("fsdp_in")
    cfg, _, _, params, stats = jax_weights_at(embed_dim=32)
    kw = root / "ksvqe_weights.pth"
    torch.save({"params": state_dict_from_jax(params, stats)}, kw)
    kcfg = dict(KSVQE_CFG, load_path=str(kw))
    kbatch = _packed_batch(B=4, T=8, seed=3)
    ebatch = dict(_packed_batch(B=4, T=8, seed=8), sample_index=np.arange(4))
    torch.save({"config": kcfg, "batch": kbatch, "eval_batch": ebatch,
                "min_size": MIN_SIZE}, root / "fsdp_ksvqe.pt")

    jt = JTrainer(SVQA_CFG, workdir=str(root / "jax_work"))
    sbatch = svqa_batch(B=4, seed=10)
    jt.build_models(sbatch)
    sd, unread = map_jax_tree(_np_tree(jt.state.params),
                              _np_tree(jt.state.batch_stats))
    assert unread == []
    sw = root / "svqa_weights.pth"
    torch.save({"params": sd}, sw)
    torch.save({"config": dict(SVQA_CFG, load_path=str(sw)),
                "batch": sbatch, "min_size": MIN_SIZE},
               root / "fsdp_svqa.pt")
    return {"root": root, "ksvqe": (cfg, params, stats, kbatch, ebatch),
            "kcfg": kcfg, "jax_trainer": jt, "svqa_batch": sbatch}


@pytest.fixture(scope="module")
def world4(setup, tmp_path_factory):
    """The 4 ranks running every scenario; the JAX references are computed
    here while they run."""
    return World(tmp_path_factory.mktemp("world4"), 4, SCENARIOS,
                 setup["root"])


# ------------------------------------------------------------- references
def _jax_spec_in_port_layout(params, min_size=MIN_SIZE):
    """JAX's ``param_shardings`` on the (2, 2) mesh, carried into the
    port's names and layout: each leaf becomes a marker array that counts
    along its sharded axis, mapped through ``map_jax_tree``; the port axis
    is the one along which the marker varies (None: replicated)."""
    sh = jsharding.param_shardings(_jax_mesh(), params, min_size)

    def marker(x, s):
        spec = tuple(s.spec) + (None,) * (np.ndim(x) - len(s.spec))
        if "fsdp" not in spec:
            return np.zeros(np.shape(x), np.float32)
        a = spec.index("fsdp")
        shape = [1] * np.ndim(x)
        shape[a] = np.shape(x)[a]
        return np.broadcast_to(np.arange(np.shape(x)[a], dtype=np.float32)
                               .reshape(shape), np.shape(x)).copy()

    markers = jax.tree_util.tree_map(marker, params, sh)
    sd, _ = map_jax_tree(markers)
    out = {}
    for n, t in sd.items():
        varying = [a for a in range(t.dim()) if t.shape[a] > 1 and not
                   torch.equal(t.narrow(a, 0, 1).expand_as(t), t)]
        assert len(varying) <= 1, n
        out[n] = varying[0] if varying else None
    return out


@pytest.fixture(scope="module")
def ksvqe_ref(setup, world4):
    """JAX's sharded step on the tiny KSVQE from the same weights: its loss
    terms and the state after it."""
    cfg, params, stats, batch, _ = setup["ksvqe"]
    jcfg = dataclasses.replace(cfg, s2d_input=True, drop_path_rate=0.0,
                               sigma=0.0)
    model = _KSVQEHeadInEval(jcfg)
    config = {"model": {"type": "KSVQE"}, "contra_loss_weight": 0.3,
              "rank_loss_weight": 0.0, "ema": True}
    tx = joptim.build_optimizer(params, lr=LR, weight_decay=0.05,
                                warmup_iters=0, max_iters=4,
                                frozen_patterns=joptim.KSVQE_FROZEN_PATTERNS)
    state = TrainState(params=params, batch_stats=stats,
                       opt_state=tx.init(params),
                       ema_params=jax.tree_util.tree_map(np.copy, params),
                       step=jnp.asarray(0, jnp.int32))
    mesh = _jax_mesh()
    step, sh_state = jsteps.make_sharded_train_step(model, tx, config, mesh,
                                                    state)
    new_state, aux = step(sh_state, jsharding.shard_batch(mesh, {
        k: jnp.asarray(v) for k, v in batch.items()}), jax.random.key(0))
    return {k: float(v) for k, v in aux.items()}, new_state


@pytest.fixture(scope="module")
def svqa_ref(setup, world4):
    jt, batch = setup["jax_trainer"], setup["svqa_batch"]
    mesh = _jax_mesh()
    step, sh_state = jsteps.make_sharded_train_step(
        jt.model, jt._tx, SVQA_CFG, mesh, jt.state, jt.ema_decay)
    new_state, aux = step(sh_state, jsharding.shard_batch(
        mesh, array_batch(batch, to_device=False)), jax.random.key(0))
    _, grads64 = _jax_grads_f64(jt.state, batch)
    return float(aux["total_loss"]), new_state, grads64


# -------------------------------------------------------------------- tests
@pytest.mark.parametrize("which", ["ksvqe", "svqa"])
def test_param_shardings_match_jax(setup, which):
    if which == "ksvqe":
        params = setup["ksvqe"][1]
        net = VQANetwork(KSVQE_CFG)
    else:
        params = _np_tree(setup["jax_trainer"].state.params)
        net = VQANetwork(SVQA_CFG)
    want = _jax_spec_in_port_layout(params)
    got = param_shardings(net, 2, MIN_SIZE)
    assert set(got) == set(want)
    assert got == want
    sharded = [n for n, a in got.items() if a is not None]
    trained = [n for n in sharded if "CLIP_tool" not in n
               and "distortion_tool" not in n]
    assert len(sharded) > 10 and trained  # trainable ones among them


def test_sharded_state_on_each_rank(world4):
    shapes = {n: tuple(p.shape) for n, p in
              VQANetwork(KSVQE_CFG).named_parameters()}
    for r, res in enumerate(world4.scenario("fsdp_ksvqe")):
        assert res["step"] == 1 and res["params_equal_rank0"], r
        for n, (shape, axis) in res["shards"].items():
            if axis is not None:
                whole = list(shape)
                whole[axis] *= 2
                assert shapes[n] == tuple(whole), n
        b = res["bytes"]
        assert b["sharded"] * 2 == b["sharded_replicated"] > 0
        assert b["total"] < b["total_replicated"]


GRAD_ROUNDOFF = 1e-6  # above the f32 roundoff of the tiny model's gradients


def _close_after_adamw(got, want, grad, name, lr):
    """``got`` within rtol 1e-5 / atol 1e-6 of ``want``, except where
    ``grad`` is below GRAD_ROUNDOFF: there one AdamW update (``lr``) may
    differ, as the first update g / (|g| + eps) turns the gradient's
    roundoff into a change of the update itself."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    small = np.zeros(got.shape, bool)
    if grad is not None:  # a frozen parameter has none and does not move
        small = np.abs(np.asarray(grad, np.float64)) < GRAD_ROUNDOFF
    np.testing.assert_allclose(got[~small], want[~small], rtol=1e-5,
                               atol=1e-6, err_msg=name)
    assert np.all(np.abs(got[small] - want[small]) <= 2 * lr * 1.0001), name
    return int(small.sum())


def _adamw_first_step(p0, g, lr, wd=0.05, eps=1e-8):
    """AdamW's first update in float64: the bias-corrected moments are g
    and g^2."""
    p0, g = np.asarray(p0, np.float64), np.asarray(g, np.float64)
    return p0 - lr * (g / (np.abs(g) + eps) + wd * p0)


def test_ksvqe_sharded_step_matches_jax(setup, world4, ksvqe_ref):
    aux_ref, new_state = ksvqe_ref
    ranks = world4.scenario("fsdp_ksvqe")
    for r in ranks:
        assert r["aux"].keys() == aux_ref.keys()
        for k in aux_ref:
            np.testing.assert_allclose(r["aux"][k], aux_ref[k], rtol=1e-5,
                                       err_msg=k)
    r0 = ranks[0]
    count, mu, nu = adamw_state_from_jax(
        to_state_dict(_np_tree(new_state.opt_state)), frozen=True,
        scaled=False)
    assert count == 1 and set(mu) == set(r0["grads"])
    grad_ref = {n: m.numpy() / 0.1 for n, m in mu.items()}  # mu = (1-b1) g
    assert len(grad_ref) > 50
    for n, g in r0["grads"].items():
        _grad_close(g, grad_ref[n], n)
    params = state_dict_from_jax(_np_tree(new_state.params))
    ema, _ = map_jax_tree(_np_tree(new_state.ema_params))
    init = state_dict_from_jax(setup["ksvqe"][1])
    assert set(params) == set(r0["params"]) == set(r0["ema"])
    small = 0
    for n, want in params.items():
        g = grad_ref.get(n)
        small += _close_after_adamw(r0["params"][n], want, g, n, LR)
        _close_after_adamw(r0["ema"][n], ema[n], g, n, LR * 1e-3)
        if g is not None:  # the port's step is AdamW on its own gradient
            np.testing.assert_allclose(
                r0["params"][n], _adamw_first_step(init[n], r0["grads"][n],
                                                   LR), rtol=0, atol=1e-6,
                err_msg=n)
    assert small < 0.5 * sum(g.size for g in grad_ref.values()), small
    for n, (m, v) in r0["moments"].items():
        np.testing.assert_allclose(m.numpy(), mu[n].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=n)
        np.testing.assert_allclose(v.numpy(), nu[n].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=n)


def test_ksvqe_sharded_step_is_the_one_process_step(setup, world4):
    tr = Trainer(setup["kcfg"], device="cpu", seed=0)
    tr.model.KSVQE_head.dropout_ratio = 0.0
    want = tr.train_step(setup["ksvqe"][3])
    for r in world4.scenario("fsdp_ksvqe"):
        for k, v in want.items():
            np.testing.assert_allclose(r["aux"][k], v, rtol=1e-6, err_msg=k)


def test_sharded_eval_gathers_the_one_process_rows(setup, world4):
    r0 = world4.scenario("fsdp_ksvqe")[0]
    net = VQANetwork(KSVQE_CFG)
    net.load_state_dict({**r0["params"], **r0["buffers"]})
    ebatch = setup["ksvqe"][4]
    ev = Evaluator(dict(KSVQE_CFG, eval_batch_size=4), model=net.eval(),
                   device="cpu")
    (_, n, want), = list(ev.scored_batches([ebatch]))
    for r in world4.scenario("fsdp_ksvqe"):
        index, scores, labels = r["eval"]
        assert index == list(range(4)) and n == 4
        np.testing.assert_allclose(scores, want, atol=1e-6)
        np.testing.assert_allclose(labels, ebatch["label"], rtol=1e-7)


def test_simplevqa_sharded_step_batchnorm_over_the_whole_batch(world4,
                                                               svqa_ref):
    loss_ref, new_state, grads64 = svqa_ref
    ranks = world4.scenario("fsdp_svqa")
    for r in ranks:
        np.testing.assert_allclose(r["aux"]["total_loss"], loss_ref,
                                   rtol=1e-5)
        assert r["params_equal_rank0"] and r["buffers_equal_rank0"]
        b = r["bytes"]
        assert b["sharded"] * 2 == b["sharded_replicated"] > 0
    want, _ = map_jax_tree(_np_tree(new_state.params),
                           _np_tree(new_state.batch_stats))
    stats = [n for n in want if "running_" in n]
    assert len(stats) == 2 * (1 + 4 * 4)
    for n in stats:
        np.testing.assert_allclose(ranks[0]["buffers"][n].numpy(),
                                   want[n].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=n)
    gsd = state_dict_from_jax(grads64)
    (r0, *_) = world4.scenario("fsdp_svqa_f64")
    assert set(r0["grads"]) == set(gsd)
    for n, g in r0["grads"].items():
        assert g.dtype == torch.float64, n
        _grad_close(g.numpy(), gsd[n].numpy(), n)


def test_dryrun_multichip_on_four_ranks(world4):
    ranks = world4.scenario("fsdp_dryrun")
    for r in ranks:
        assert r["mesh"] == {"data": 2, "fsdp": 2} and r["global_batch"] == 4
        for k in ("fsdp_loss", "ddp_loss", "kernel_path_loss"):
            assert np.isfinite(r[k]), k
        assert len(r["eval_scores"]) == 4
        assert np.all(np.isfinite(r["eval_scores"]))
    assert all(r["fsdp_loss"] == ranks[0]["fsdp_loss"] for r in ranks)


def test_dryrun_entry_forward_and_train_model():
    from kvq_tpu_torch.parallel.dryrun import dryrun_config, entry

    fn, (model, batch) = entry("cpu")
    scores, dis = fn(model, batch)
    assert scores.shape[0] == 2 and torch.isfinite(scores).all()
    assert np.isfinite(float(dis))
    assert build_train_model(dryrun_config(), "cpu").training

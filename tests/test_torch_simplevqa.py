"""The port's SimpleVQA against the JAX package, on the CPU in float32.

Inputs are seeded numpy; the JAX weights come from ``init`` (their
BatchNorm scales, biases and statistics drawn at random for the eval
checks) and reach the port through ``core/from_jax.py``.  The ResNet-50 is
cut in depth to one block a stage (``backbone.layers`` (1, 1, 1, 1)); its
widths, and so the 9472 features, are the architecture's.  Frames are
32 x 32, T = 2.  Tolerances:

  - eval score and the (B, T, 9472) features: atol 1e-5 (f32 roundoff
    through the trunk, summed in another order); the BasicBlock trunk's
    stage maps (values up to ~5) rtol 1e-5 / atol 1e-5 in eval, atol 1e-4
    in train mode (flax's fast batch variance);
  - train-mode BatchNorm statistics: rtol 1e-5 / atol 1e-6 (the mean and
    biased variance of each channel, folded into the running statistics);
  - one ``Trainer`` step against the JAX trainer's ``_train_step``: loss
    rtol 1e-5, the running statistics after the step rtol 1e-5 / atol
    1e-6; every gradient within 2e-4 of its scale (rtol 1e-3) of JAX's
    computed in float64 (``_jax_grads_f64`` says why);
  - a JAX-written weights file: score atol 1e-5; a JAX full state: the
    next step's loss rtol 1e-5 and statistics as above;
  - SimpleVQADataset: items bit-equal; the CLIs' scores within 1e-5 of the
    Evaluator's.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kvq_tpu.core import checkpoint as jckpt
from kvq_tpu.core.torch_import import convert_simplevqa_full
from kvq_tpu.data import datasets as JD
from kvq_tpu.models.vqa_network import VQANetwork as JNet
from kvq_tpu.nn.heads import SimpleVQAHead as JSimpleVQAHead
from kvq_tpu.nn.layers import avg_std_pool as javg_std_pool
from kvq_tpu.nn.resnet import FeatureResNet as JFeatureResNet
from kvq_tpu.nn.resnet import ResNetTrunk as JTrunk
from kvq_tpu.train import losses as JL
from kvq_tpu.train.trainer import Trainer as JTrainer
from kvq_tpu.train.trainer import array_batch
from kvq_tpu_torch.cli import test as cli_test
from kvq_tpu_torch.cli import train as cli_train
from kvq_tpu_torch.core.checkpoint import (
    load_checkpoint, load_weights, merge_jax_weights, merge_state_dict)
from kvq_tpu_torch.core.from_jax import map_jax_tree, state_dict_from_jax
from kvq_tpu_torch.core.registry import DATASETS
from kvq_tpu_torch.data import datasets as PD
from kvq_tpu_torch.data.pipeline import train_fields
from kvq_tpu_torch.models.vqa_network import (
    VQANetwork, build_model, cast_model, compute_tensors)
from kvq_tpu_torch.nn.layers import avg_std_pool
from kvq_tpu_torch.nn.resnet import BatchNorm, ResNet
from kvq_tpu_torch.train.evaluator import Evaluator
from kvq_tpu_torch.train.trainer import Trainer

from test_torch_train import _grad_close

LAYERS = (1, 1, 1, 1)


def svqa_cfg(compute_dtype="float32", **top):
    return {"name": "tiny_svqa", **top, "model": {
        "type": "simpleVQA", "compute_dtype": compute_dtype,
        "args": {"simpleVQA": {"backbone": {"layers": list(LAYERS)},
                               "head": {"in_channels": 9472,
                                        "hidden_channels": 128}}}}}


TRAIN_CFG = svqa_cfg(warmup_epochs=1, num_epochs=4, ema=True,
                     optimizer={"lr": 1e-3, "wd": 0.05})


def svqa_batch(B=2, T=2, S=32, seed=0):
    r = np.random.default_rng(seed)
    return {"simpleVQA": r.normal(size=(B, T, S, S, 3)).astype(np.float32),
            "feat": r.normal(size=(B, T, 2304)).astype(np.float32),
            "label": r.normal(size=(B,)).astype(np.float32)}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items() if k != "label"}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _randomize_bn(params, stats, seed=1):
    """BatchNorm scales, biases and running statistics drawn at random, so
    that eval normalisation is not the identity."""
    r = np.random.default_rng(seed)

    def walk(node, in_bn):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, in_bn or "bn" in k)
            elif k in ("scale", "var"):
                node[k] = r.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k == "mean" or (k == "bias" and in_bn):
                node[k] = (0.1 * r.normal(size=v.shape)).astype(np.float32)

    walk(params, False)
    walk(stats, False)


@pytest.fixture(scope="module")
def jax_net():
    """The tiny JAX SimpleVQA, its params and batch_stats (numpy)."""
    jm = JNet(config=svqa_cfg())
    v = jax.jit(lambda b: jm.init(jax.random.key(0), b, train=False))(
        _jb(svqa_batch()))
    params, stats = _np_tree(v["params"]), _np_tree(v["batch_stats"])
    _randomize_bn(params, stats)
    return jm, params, stats


def _port_net(params, stats):
    net = VQANetwork(svqa_cfg())
    sd, unread = map_jax_tree(params, stats)
    assert unread == []
    net.load_state_dict(sd, strict=True)
    return net


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _stats_close(net, jax_params, jax_stats):
    """Every running mean and variance of ``net`` against a JAX
    ``batch_stats`` tree (of the model of ``jax_params``)."""
    want, unread = map_jax_tree(jax_params, jax_stats)
    assert unread == []
    want = {k: v for k, v in want.items() if "running_" in k}
    names = [n for n, _ in net.named_buffers() if "running_" in n]
    assert names and set(names) == set(want)
    buffers = dict(net.named_buffers())
    for n in names:
        assert buffers[n].dtype == torch.float32, n
        np.testing.assert_allclose(buffers[n].numpy(), want[n].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=n)


# --------------------------------------------------------------------- model
def test_avg_std_pool_matches_jax():
    """Unbiased (n - 1) standard deviation with eps 1e-10 inside the sqrt,
    in float32; the gradient stays finite on a dead channel."""
    x = np.random.default_rng(0).normal(size=(3, 5, 4, 6)).astype(np.float32)
    x[:, :, :, 2] = 0.0  # a dead channel
    jm, js = javg_std_pool(jnp.asarray(x), (1, 2))
    xt = torch.from_numpy(x).requires_grad_()
    m, s = avg_std_pool(xt, (1, 2))
    np.testing.assert_allclose(m.detach().numpy(), np.asarray(jm), atol=1e-6)
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(js), rtol=1e-6,
                               atol=1e-7)
    s.sum().backward()
    assert torch.isfinite(xt.grad).all()


def test_simplevqa_eval_score_and_features_match_jax(jax_net):
    jm, params, stats = jax_net
    batch = svqa_batch()
    jv = {"params": params, "batch_stats": stats}
    ref = jax.jit(lambda b: jm.apply(jv, b, train=False)[0])(_jb(batch))
    jfeat = JFeatureResNet(layers=LAYERS).apply(
        {"params": params["simpleVQA_backbone"],
         "batch_stats": stats["simpleVQA_backbone"]}, _jb(batch))
    net = _port_net(params, stats).eval()
    with torch.no_grad():
        feat = net.simpleVQA_backbone(_t(batch))
        score = net(_t(batch), reduce_scores=True)
    assert feat.shape == (2, 2, 9472) and feat.dtype == torch.float32
    np.testing.assert_allclose(feat.numpy(), np.asarray(jfeat), atol=1e-5)
    np.testing.assert_allclose(score.numpy(), np.asarray(ref), atol=1e-5)


def test_train_mode_batchnorm_statistics_match_jax(jax_net):
    """One train-mode forward: the port's running statistics against the
    ``batch_stats`` that JAX's ``mutable=["batch_stats"]`` returns (the
    biased batch variance, momentum 0.9), and the same scores."""
    jm, params, stats = jax_net
    batch = svqa_batch(seed=3)
    out, mut = jax.jit(lambda b: jm.apply(
        {"params": params, "batch_stats": stats}, b, train=True,
        mutable=["batch_stats"]))(_jb(batch))
    net = _port_net(params, stats).train()
    scores = net(_t(batch))
    np.testing.assert_allclose(scores[0].detach().numpy(),
                               np.asarray(out[0]), atol=1e-5)
    _stats_close(net, params, _np_tree(mut["batch_stats"]))
    for mod in net.modules():
        if isinstance(mod, BatchNorm):
            assert int(mod.num_batches_tracked) == 1


def test_basic_block_resnet_matches_jax():
    """The BasicBlock trunk (kvq_tpu/nn/resnet.py's ``_BLOCKS``), its four
    stage maps in eval and train mode (4 frames of 64 x 64: train mode
    normalises layer 4 over 16 values a channel).  Train mode within 1e-4:
    flax's batch variance E[x^2] - E[x]^2 loses about eps_f32 * mean^2 /
    var of its relative accuracy, the port's (torch's batch_norm) is
    computed about the mean."""
    x = np.random.default_rng(0).normal(size=(4, 64, 64, 3)).astype(
        np.float32)
    jt = JTrunk(layers=LAYERS, block="basic")
    v = jax.jit(lambda a: jt.init(jax.random.key(0), a))(jnp.asarray(x))
    params, stats = _np_tree(v["params"]), _np_tree(v["batch_stats"])
    _randomize_bn(params, stats)
    sd, unread = map_jax_tree({"simpleVQA_backbone": {"trunk": params}},
                              {"simpleVQA_backbone": {"trunk": stats}})
    assert unread == []
    net = ResNet(LAYERS, block="basic")
    prefix = "simpleVQA_backbone."
    net.load_state_dict({k[len(prefix):]: t for k, t in sd.items()},
                        strict=True)
    jv = {"params": params, "batch_stats": stats}
    for train in (False, True):
        ref = jax.jit(lambda a: jt.apply(
            jv, a, train=train, mutable=["batch_stats"])[0])(jnp.asarray(x))
        net.train(train)
        with torch.no_grad():
            got = net.stages(torch.from_numpy(x).permute(0, 3, 1, 2))
        for g, w in zip(got, ref):
            np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                       np.asarray(w), rtol=1e-5,
                                       atol=1e-4 if train else 1e-5)


@pytest.mark.parametrize("key,width", [("simpleVQA", 9472), ("swin_tiny", 96)])
def test_head_width_is_the_backbones_not_in_channels(key, width):
    """A config whose ``head.in_channels`` (768) is not the backbone's
    width: kvq_tpu's head infers its width from the input, the port's is
    built as wide as the backbone, and the same weights give the same
    scores (atol 1e-5)."""
    from kvq_tpu.models.heads_util import build_head as jbuild_head
    from kvq_tpu_torch.models.vqa_network import build_head

    cfg = {"in_channels": 768, "hidden_channels": 16}
    shape = (2, 2, width) if key == "simpleVQA" else (2, 2, 3, 3, width)
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    jh = jbuild_head(key, cfg, jnp.float32)
    jp = _np_tree(jh.init(jax.random.key(0), jnp.asarray(x))["params"])
    ref = jh.apply({"params": jp}, jnp.asarray(x))
    sd, unread = map_jax_tree({f"{key}_head": jp})
    assert unread == []
    head = build_head(key, cfg, width).eval()
    head.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()},
                         strict=True)
    with torch.no_grad():
        got = head(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_reference_checkpoint_names(jax_net):
    """The port's state_dict is a reference ``VQA_Network`` SimpleVQA
    checkpoint: kvq_tpu's ``convert_simplevqa_full`` reads it back to the
    JAX trees it came from, and a reference ``.pth`` (``module.`` prefix,
    the bypassed in-model ``quality`` head) merges with that head as its
    only unexpected entries."""
    _, params, stats = jax_net
    net = _port_net(params, stats)
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    jp, js = convert_simplevqa_full(sd)
    for got, want in ((jp, params), (js, stats)):
        flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
        flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
        assert flat_g.keys() == flat_w.keys()
        for path, leaf in flat_w.items():
            np.testing.assert_array_equal(flat_g[path], leaf)
    ref = {f"module.{k}": torch.from_numpy(v.copy()) for k, v in sd.items()}
    quality = {"module.simpleVQA_backbone.quality.0.weight": torch.ones(2, 3),
               "module.simpleVQA_backbone.quality.0.bias": torch.ones(2)}
    fresh = VQANetwork(svqa_cfg())
    report = merge_state_dict(fresh, {**ref, **quality})
    assert report["missing"] == [] and report["mismatched"] == []
    assert sorted(report["unexpected"]) == sorted(
        k[len("module."):] for k in quality)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, net.state_dict()[k]), k


def test_bf16_keeps_batchnorm_in_f32():
    """Under a bf16 compute dtype every BatchNorm tensor stays float32, in
    the eval model and in the train step's tensors (which are the module's
    own, so the train-mode update lands in the buffers)."""
    model = build_model(svqa_cfg("bfloat16"), device="cpu")
    bn = model.simpleVQA_backbone.layer1[0].bn2
    assert model.simpleVQA_backbone.conv1.weight.dtype == torch.bfloat16
    assert model.simpleVQA_head.quality[0].weight.dtype == torch.bfloat16
    for t in (bn.weight, bn.bias, bn.running_mean, bn.running_var):
        assert t.dtype == torch.float32
    batch = svqa_batch()
    with torch.no_grad():
        out = model({"simpleVQA": torch.from_numpy(batch["simpleVQA"]).to(
            torch.bfloat16), "feat": torch.from_numpy(batch["feat"])},
            reduce_scores=True)
    assert out.shape == (2, 1) and torch.isfinite(out.float()).all()
    train = VQANetwork(svqa_cfg("bfloat16"))
    tensors = compute_tensors(train, torch.bfloat16)
    buffers = dict(train.named_buffers())
    name = "simpleVQA_backbone.layer1.0.bn2.running_mean"
    assert tensors[name] is buffers[name]
    assert tensors["simpleVQA_backbone.conv1.weight"].dtype == torch.bfloat16
    cast = cast_model(VQANetwork(svqa_cfg()), torch.bfloat16)
    assert cast.simpleVQA_backbone.bn1.running_var.dtype == torch.float32


# ------------------------------------------------------------------ training
def _jax_grads_f64(state, batch):
    """The gradients of the JAX train-mode loss (its ``_train_step``
    loss_fn: FeatureResNet and SimpleVQAHead, PLCC) at ``state``, computed
    in float64.  In float32 a pre-ReLU value within roundoff of zero can
    fall on either side in the two packages, and each such flip moves the
    gradients of its block by percents at this width; in float64 both
    packages agree to ~1e-7, so float64 is the reference the port's
    float32 step is held to."""
    with jax.enable_x64(True):
        f64 = functools.partial(jax.tree_util.tree_map,
                                lambda a: jnp.asarray(a, jnp.float64))
        jb = f64(_jb(batch))
        backbone = JFeatureResNet(layers=LAYERS, dtype=jnp.float64)
        head = JSimpleVQAHead(hidden_channels=128, dtype=jnp.float64)
        stats = f64(state.batch_stats["simpleVQA_backbone"])

        def loss_fn(p):
            feat, _ = backbone.apply(
                {"params": p["simpleVQA_backbone"], "batch_stats": stats},
                jb, train=True, mutable=["batch_stats"])
            s = head.apply({"params": p["simpleVQA_head"]}, feat)
            return JL.total_loss([s], jnp.asarray(batch["label"],
                                                  jnp.float64),
                                 None, 0.3, 0.0)[0]

        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(f64(state.params))
        return float(loss), jax.tree_util.tree_map(np.asarray, grads)


@pytest.fixture(scope="module")
def jax_trained(tmp_path_factory):
    """The JAX trainer's first two steps from ``init``; its weights file and
    full state written after the first."""
    root = tmp_path_factory.mktemp("svqa_jax")
    jt = JTrainer(TRAIN_CFG, workdir=str(root))
    b0, b1 = svqa_batch(B=4, seed=10), svqa_batch(B=4, seed=11)
    jt.build_models(b0)
    s0 = jt.state
    loss, grads = _jax_grads_f64(s0, b0)
    rng = jax.random.key(0)
    s1, aux1 = jt._train_step(s0, array_batch(b0), rng)
    jt.state = s1
    full = root / "tiny_svqa_last_state.msgpack"
    jt.save_full_state(str(full))
    weights = root / "tiny_svqa_weights.msgpack"
    jckpt.save_checkpoint(str(weights), {"params": s1.params,
                                         "batch_stats": s1.batch_stats})
    s2, aux2 = jt._train_step(s1, array_batch(b1), rng)
    return {"batches": (b0, b1), "states": (s0, s1, s2),
            "loss_f64": loss, "grads_f64": grads,
            "aux": (float(aux1["total_loss"]), float(aux2["total_loss"])),
            "full": str(full), "weights": str(weights), "jt": jt}


def test_trainer_step_matches_jax(jax_trained):
    """One port ``Trainer`` step from the JAX trainer's initial state: the
    loss against JAX's ``_train_step``, every gradient against JAX's in
    float64 (``_jax_grads_f64``), and the running statistics after the
    step (the step updates the module's own buffers, once)."""
    j = jax_trained
    s0, s1, _ = j["states"]
    tr = Trainer(TRAIN_CFG, device="cpu", seed=0, steps_per_epoch=1)
    report = merge_jax_weights(tr.model, _np_tree(s0.params),
                               _np_tree(s0.batch_stats))
    assert not any(report.values())
    assert tr.fields == train_fields(["simpleVQA"]) == (
        "simpleVQA", "feat", "label")
    aux = tr.train_step(j["batches"][0])
    np.testing.assert_allclose(aux["total_loss"], j["aux"][0], rtol=1e-5)
    np.testing.assert_allclose(aux["total_loss"], j["loss_f64"], rtol=1e-5)
    gsd = state_dict_from_jax(j["grads_f64"])
    named = dict(tr.model.named_parameters())
    assert set(named) == set(gsd)
    for n, p in named.items():
        _grad_close(p.grad, gsd[n].numpy(), n)
    _stats_close(tr.model, s1.params, _np_tree(s1.batch_stats))
    for mod in tr.model.modules():
        if isinstance(mod, BatchNorm):
            assert int(mod.num_batches_tracked) == 1
    # the EMA covers the parameters only; an EMA evaluation takes the live
    # running statistics
    assert len(tr.ema) == len(named)
    sd = tr.weights(use_ema=True)
    for n, b in tr.model.named_buffers():
        assert torch.equal(sd[n], b), n


def test_jax_weights_file_and_full_state_load(jax_trained, tmp_path):
    """kvq_tpu's weights file scores as the JAX model does; its full state
    resumes: the next step's loss and running statistics as JAX's; the
    port's own save/load keeps the statistics."""
    j = jax_trained
    _, s1, s2 = j["states"]
    b0, b1 = j["batches"]
    model = build_model(svqa_cfg(), device="cpu")
    report = load_weights(model, j["weights"])
    assert not any(report.values())
    ref = j["jt"].model.apply({"params": s1.params,
                               "batch_stats": s1.batch_stats},
                              _jb(b1), train=False)[0]
    with torch.no_grad():
        got = model(_t(b1), reduce_scores=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)

    tr = Trainer(TRAIN_CFG, device="cpu", seed=3, steps_per_epoch=1)
    tr.load(j["full"])
    assert tr.step == 1
    _stats_close(tr.model, s1.params, _np_tree(s1.batch_stats))
    path = str(tmp_path / "state.pt")
    tr.save(path)
    aux = tr.train_step(b1)
    np.testing.assert_allclose(aux["total_loss"], j["aux"][1], rtol=1e-5)
    _stats_close(tr.model, s2.params, _np_tree(s2.batch_stats))

    again = Trainer(TRAIN_CFG, device="cpu", seed=4, steps_per_epoch=1)
    again.load(path)
    _stats_close(again.model, s1.params, _np_tree(s1.batch_stats))
    assert again.train_step(b1) == aux
    for (n, b), c in zip(tr.model.named_buffers(), again.model.buffers()):
        assert torch.equal(b, c), n


# ------------------------------------------------------------------- dataset
SAMPLE = {"simpleVQA": dict(resize=48, crop=32, clip_len=4, frame_interval=2,
                            t_frag=4, num_clips=1)}


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _same(a[k], b[k])
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("phase", ["train", "test"])
def test_simplevqa_dataset_items_match_jax(phase):
    opt = JD.make_synthetic_opt(n_videos=3, n_frames=60, height=72,
                                width=96, sample_types=SAMPLE, phase=phase,
                                with_features=True)
    popt = PD.make_synthetic_opt(n_videos=3, n_frames=60, height=72,
                                 width=96, sample_types=SAMPLE, phase=phase,
                                 with_features=True)
    ja, pa = JD.SimpleVQADataset(opt), PD.SimpleVQADataset(popt)
    assert len(ja) == len(pa) == 3
    for i, epoch in ((0, 0), (2, 1)):
        a, b = ja.__getitem__(i, epoch=epoch), pa.__getitem__(i, epoch=epoch)
        assert b["simpleVQA"].shape == (4, 32, 32, 3)
        assert b["feat"].shape == (4, 2304) and b["feat"].dtype == np.float32
        assert b["simpleVQA"].max() > 200  # the 0-255 normalisation quirk
        _same(a, b)
    assert DATASETS.get("ViewDecompositionDataset_add_forSimpleVQA") is \
        PD.SimpleVQADataset


@pytest.mark.parametrize("feature_type,dims",
                         [("Slow", 2048), ("Fast", 256), ("SlowFast", 2304)])
def test_simplevqa_dataset_reads_feature_files(tmp_path, feature_type, dims):
    """CSV annotations with a header; ``feature_{i}_{slow,fast}_feature.
    npy`` under ``data_prefix_3D/<video>``, ``clip_len`` rows."""
    r = np.random.default_rng(0)
    (tmp_path / "ann.csv").write_text("filename,score\na.mp4,3.5\nb.mp4,1.25\n")
    for name in ("a.mp4", "b.mp4"):
        d = tmp_path / "feat" / name
        d.mkdir(parents=True)
        for i in range(6):
            np.save(d / f"feature_{i}_slow_feature.npy",
                    r.normal(size=(1, 2048)).astype(np.float32))
            np.save(d / f"feature_{i}_fast_feature.npy",
                    r.normal(size=(1, 256)).astype(np.float32))
    opt = {"anno_file": str(tmp_path / "ann.csv"), "data_prefix": "vids",
           "data_prefix_3D": str(tmp_path / "feat"),
           "feature_type": feature_type, "sample_types": SAMPLE,
           "phase": "test",
           "source_factory": lambda p: JD.SyntheticVideoSource(40, 64, 64)}
    ja, pa = JD.SimpleVQADataset(opt), PD.SimpleVQADataset(opt)
    assert ja.video_infos == pa.video_infos
    assert pa.video_infos[1] == {"filename": "vids/b.mp4", "label": 1.25,
                                 "video_name": "b.mp4"}
    for i in range(2):
        a, b = ja[i], pa[i]
        assert b["feat"].shape == (4, dims)
        _same(a, b)


# ---------------------------------------------------------------------- CLIs
def _cli_config(workdir):
    def split(phase, n):
        return {"type": "ViewDecompositionDataset_add_forSimpleVQA",
                "args": PD.make_synthetic_opt(
                    n_videos=n, n_frames=60, height=72, width=96,
                    sample_types=SAMPLE, phase=phase, with_features=True)}

    return dict(TRAIN_CFG, batch_size=4, num_workers=2, seed=3,
                data={"train": split("train", 4), "val": split("test", 3)})


def test_cli_test_and_train_run_simplevqa(tmp_path):
    """``cli.train.run`` one epoch (best-weights files, the last state),
    then ``cli.test.run`` on its EMA best weights: ``output.txt`` scores
    within 1e-5 of the Evaluator's on the same Loader's batches."""
    config = _cli_config(tmp_path)
    tr = cli_train.run(config, str(tmp_path / "work"), epochs=1,
                       device="cpu")
    assert tr.step == 1
    files = sorted(p.name for p in (tmp_path / "work").iterdir())
    assert files == ["tiny_svqa_head_val_n_finetuned.pth",
                     "tiny_svqa_head_val_s_finetuned.pth",
                     "tiny_svqa_last_state.pt"]
    state = load_checkpoint(str(tmp_path / "work" / files[2]))
    assert "simpleVQA_backbone.layer4.0.bn3.running_var" in state["params"]
    best = str(tmp_path / "work" / files[1])
    out = str(tmp_path / "output.txt")
    results = cli_test.run(dict(config, test_load_path=best), out,
                           device="cpu")
    lines = open(out).read().splitlines()
    assert [ln.split(",")[0] for ln in lines] == [
        f"synthetic_{i}.mp4" for i in range(3)]
    from kvq_tpu_torch.data.pipeline import build_loaders

    _, val = build_loaders(config)
    ev = Evaluator(dict(config, test_load_path=best), device="cpu")
    want = [s for _, _, p in ev.scored_batches(val.epoch(0)) for s in p]
    np.testing.assert_allclose([s for _, s in results], want, atol=1e-5)
    assert np.isfinite(want).all()


def test_shipped_config_builds_its_loaders(tmp_path):
    """config/kwai_simpleVQA.yml as shipped (its ``backbone:`` is empty)
    builds both Loaders once pointed at files: CSV annotations, cv2-written
    mp4s and SlowFast feature files; a val batch holds the 8 x 448 x 448
    view and the (8, 2304) features."""
    cv2 = pytest.importorskip("cv2")
    from kvq_tpu_torch.core.config import load_config
    from kvq_tpu_torch.data.pipeline import build_loaders

    vids, feat = tmp_path / "videos", tmp_path / "feat"
    vids.mkdir()
    rng = np.random.default_rng(0)
    lines = ["filename,score\n"]
    for i in range(4):
        name = f"v{i}.mp4"
        wr = cv2.VideoWriter(str(vids / name),
                             cv2.VideoWriter_fourcc(*"mp4v"), 30, (48, 64))
        base = rng.integers(0, 255, size=(64, 48, 3), dtype=np.uint8)
        for t in range(90):
            wr.write(np.roll(base, t, axis=0))
        wr.release()
        (feat / name).mkdir(parents=True)
        for k in range(8):
            np.save(feat / name / f"feature_{k}_slow_feature.npy",
                    rng.normal(size=2048).astype(np.float32))
            np.save(feat / name / f"feature_{k}_fast_feature.npy",
                    rng.normal(size=256).astype(np.float32))
        lines.append(f"{name},{1.0 + i}\n")
    (tmp_path / "split.csv").write_text("".join(lines))
    config = load_config("config/kwai_simpleVQA.yml")
    assert config["model"]["args"]["simpleVQA"]["backbone"] is None
    for split in ("train", "val"):
        config["data"][split]["args"].update(
            anno_file=str(tmp_path / "split.csv"), data_prefix=str(vids),
            data_prefix_3D=str(feat))
    config["num_workers"] = 2
    train, val = build_loaders(config)
    assert len(train) == 1 and len(val) == 4
    batch = next(iter(val))
    assert batch["simpleVQA"].shape == (1, 8, 448, 448, 3)
    assert batch["feat"].shape == (1, 8, 2304)
    np.testing.assert_array_equal(
        batch["feat"][0, 3, :2048],
        np.load(feat / "v0.mp4" / "feature_3_slow_feature.npy"))

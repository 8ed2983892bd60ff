"""The port's data-parallel path (kvq_tpu_torch/parallel/, the DDP route of
train/trainer.py, the gathered eval, the CLIs under a process group and
core/logging.py) against the JAX package, on the CPU.

The port runs in gloo worlds of spawned processes
(tests/_torch_ddp_worker.py: a ``file://`` rendezvous under tmp_path, a
timeout of their own, killed on failure); this process runs the JAX side on
two of conftest's virtual CPU devices, and the one-process references.
Inputs are seeded numpy, the weights JAX's ``init`` carried over by
``core/from_jax.py``.  Tolerances:

  - tiny KSVQE, a 2-rank DDP step (4 samples a rank, QRS sigma 0, DropPath
    0, head in eval: the random parts off on both sides) against
    ``shard_map`` of ``kvq_tpu.parallel.steps._loss_and_aux`` with
    ``pmean`` on a 2-device mesh: the averaged loss terms rtol 1e-5; every
    reduced trainable gradient atol 2e-4 x scale, rtol 1e-3
    (``_grad_close``: f32 roundoff through ~40 layers, summed in another
    order); both ranks' parameters bit-equal after the step;
  - tiny SimpleVQA with the synced BatchNorm, the Trainer's 2-rank step
    against JAX's ``make_ddp_train_step`` with ``bn_axis_name="data"``: the
    running statistics rtol 1e-5 / atol 1e-6 and the loss rtol 1e-5, both
    ranks' parameters bit-equal after the step; the reduced gradients of
    the same 2-rank step run in float64 against JAX's, pmean'd in float64,
    by ``_grad_close``.  In float32 the gradients of this ReLU network move
    by more than that bound when the statistics are summed over two halves
    instead of the whole batch (a pre-activation within roundoff of a
    ReLU's or a max-pool's switch; tests/test_torch_simplevqa.py:
    _jax_grads_f64), so float64 is where the step's gradient is held;
  - the DDP route at world 1 against the one-process Trainer: bit-equal;
  - the gathered eval of 5 videos on 2 ranks (one wrap duplicate): metrics
    rtol 1e-6 and output.txt's scores atol 1e-6 against one process (the
    same float32 forwards in processes of other thread counts), names and
    order equal; the merged rows equal ``kvq_tpu``'s ``_merge_rows``;
  - the Loader's shards: indices equal to ``kvq_tpu``'s Loader's;
  - MetricLogger: records equal to ``kvq_tpu``'s, ``time_s`` aside.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

cv2 = pytest.importorskip("cv2")

from kvq_tpu.core import logging as jlogging
from kvq_tpu.core.torch_import import convert_ksvqe_full
from kvq_tpu.data.pipeline import Loader as JLoader
from kvq_tpu.nn.heads import SimpleVQAHead as JSimpleVQAHead
from kvq_tpu.nn.heads import VQAHead as JVQAHead
from kvq_tpu.nn.ksvqe import KSVQE as JKSVQE
from kvq_tpu.nn.resnet import FeatureResNet as JFeatureResNet
from kvq_tpu.parallel import steps as jsteps
from kvq_tpu.parallel.mesh import make_mesh
from kvq_tpu.parallel.sharding import shard_batch
from kvq_tpu.train import losses as JL
from kvq_tpu.train.trainer import Trainer as JTrainer
from kvq_tpu.train.trainer import array_batch
from kvq_tpu_torch.cli import test as cli_test
from kvq_tpu_torch.core import logging as plogging
from kvq_tpu_torch.core.from_jax import map_jax_tree, state_dict_from_jax
from kvq_tpu_torch.core.registry import DATASETS
from kvq_tpu_torch.data import datasets as PD
from kvq_tpu_torch.data.pipeline import build_loaders
from kvq_tpu_torch.models.vqa_network import VQANetwork
from kvq_tpu_torch.parallel import steps as psteps
from kvq_tpu_torch.train.trainer import Trainer

from test_torch_ksvqe import jax_weights_at
from test_torch_modules import tiny_config
from test_torch_simplevqa import LAYERS, _np_tree, svqa_batch, svqa_cfg
from test_torch_train import _grad_close, _packed_batch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_ddp_worker.py")
WORLD_TIMEOUT = 240  # seconds a spawned world may take before it is killed
N_VAL, N_TRAIN = 5, 4  # the CLI split's videos: 5 on 2 ranks wrap once
SAMPLE = dict(fragments_h=5, fragments_w=5, fsize_h=8, fsize_w=8,
              size_h=32, size_w=32, aligned=8, clip_len=8, frame_interval=2)
SVQA_DDP_CFG = svqa_cfg(warmup_epochs=1, num_epochs=4, ema=True, ddp=True,
                        optimizer={"lr": 1e-3, "wd": 0.05})


class World:
    """``n`` worker processes running ``scenarios``; started at once,
    waited for (with the timeout) by :meth:`results`."""

    def __init__(self, tmp, n, scenarios, inputs):
        self.out = tmp / "out"
        self.out.mkdir()
        self.n = n
        env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=os.pathsep.join(
            [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        self.logs = [open(self.out / f"rank{r}.log", "w") for r in range(n)]
        self.procs = [subprocess.Popen(
            [sys.executable, WORKER, str(r), str(n), str(tmp / "rendezvous"),
             str(inputs), str(self.out), *scenarios],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=ROOT)
            for r, log in enumerate(self.logs)]
        self.deadline = time.monotonic() + WORLD_TIMEOUT
        self._results = None

    def _log(self, r):
        return (self.out / f"rank{r}.log").read_text()[-4000:]

    def results(self) -> list[dict]:
        if self._results is not None:
            return self._results
        try:
            while any(p.poll() is None for p in self.procs):
                failed = [r for r, p in enumerate(self.procs)
                          if p.poll() not in (None, 0)]
                if failed:
                    raise AssertionError(f"rank {failed[0]} failed:\n"
                                         f"{self._log(failed[0])}")
                if time.monotonic() > self.deadline:
                    raise AssertionError(
                        f"the world of {self.n} timed out:\n{self._log(0)}")
                time.sleep(0.1)
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for log in self.logs:
                log.close()
        for r, p in enumerate(self.procs):
            assert p.returncode == 0, f"rank {r}:\n{self._log(r)}"
        self._results = [torch.load(self.out / f"rank{r}.pt",
                                    weights_only=False)
                         for r in range(self.n)]
        return self._results

    def scenario(self, name) -> list:
        got = [res[name] for res in self.results()]
        for r, g in enumerate(got):
            assert not (isinstance(g, dict) and "error" in g), \
                f"rank {r}, {name}:\n{g['error']}"
        return got


# ------------------------------------------------------------------ inputs
def _write_videos(vids, n, seed):
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        name = f"v{seed}_{i}.mp4"
        h, w = (72, 96) if i % 2 else (90, 64)
        wr = cv2.VideoWriter(str(vids / name),
                             cv2.VideoWriter_fourcc(*"mp4v"), 30, (w, h))
        base = rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)
        for t in range(40 + 20 * i):
            wr.write(np.roll(base, 3 * t, axis=1))
        wr.release()
        lines.append(f"{name},{i % 3},{i % 2},{1.0 + 0.7 * i}\n")
    return "".join(lines)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The files the workers read: each train case's config, weights and
    batch; the CLI project (tiny mp4s, both splits, tiny weights)."""
    root = tmp_path_factory.mktemp("ddp_in")
    # tiny KSVQE: JAX's seeded weights, 8 samples (4 a rank)
    cfg, _, _, params, stats = jax_weights_at()
    kw = root / "ksvqe_weights.pth"
    torch.save({"params": state_dict_from_jax(params, stats)}, kw)
    kcfg = dict(tiny_config(use_pallas=True, s2d_input=True,
                            drop_path_rate=0.0, sigma=0.0),
                ddp=True, load_path=str(kw))
    kbatch = _packed_batch(B=8, T=8, seed=3)
    torch.save({"config": kcfg, "batch": kbatch}, root / "ksvqe.pt")

    # tiny SimpleVQA: the JAX DDP trainer's initial state, 8 samples
    mesh = make_mesh(data=2, devices=jax.devices()[:2])
    jt = JTrainer(SVQA_DDP_CFG, workdir=str(root / "jax_work"), mesh=mesh)
    sbatch = svqa_batch(B=8, seed=10)
    jt.build_models(sbatch)
    sd, unread = map_jax_tree(_np_tree(jt.state.params),
                              _np_tree(jt.state.batch_stats))
    assert unread == []
    sw = root / "svqa_weights.pth"
    torch.save({"params": sd}, sw)
    torch.save({"config": dict(SVQA_DDP_CFG, load_path=str(sw)),
                "batch": sbatch}, root / "svqa.pt")

    # the DDP route at world 1: the tiny KSVQE with its random parts on
    torch.save({"config": tiny_config(use_pallas=True, s2d_input=True),
                "batches": [_packed_batch(B=4, T=8, seed=s)
                            for s in (4, 5)]}, root / "world_one.pt")

    # the CLI project
    vids = root / "videos"
    vids.mkdir()
    (root / "train.txt").write_text(_write_videos(vids, N_TRAIN, 1))
    (root / "val.txt").write_text(_write_videos(vids, N_VAL, 2))

    def split(phase, num_clips, ann):
        return {"type": "ViewDecompositionDataset_KVQ", "args": {
            "phase": phase, "anno_file": str(root / ann),
            "data_prefix": str(vids), "sample_types": {
                "technical": dict(SAMPLE, num_clips=num_clips)}}}

    ccfg = dict(tiny_config(s2d_input=True, use_pallas=True), ddp=True,
                num_epochs=1, warmup_epochs=0.5, batch_size=2,
                num_workers=2, seed=7, load_path=str(kw),
                test_load_path=str(kw), optimizer={"lr": 1e-3, "wd": 0.05},
                data={"train": split("train", 1, "train.txt"),
                      "val": split("test", 3, "val.txt")})
    torch.save({"config": ccfg}, root / "cli.pt")
    return {"root": root, "jax_trainer": jt, "mesh": mesh,
            "ksvqe": (cfg, params, stats, kbatch), "svqa_batch": sbatch,
            "cli_config": ccfg}


SCENARIOS_2 = ("ksvqe", "svqa", "svqa_bf16", "svqa_f64", "evaluate",
               "cli_train", "refusals")


@pytest.fixture(scope="module")
def world2(inputs, tmp_path_factory):
    """Two ranks running every two-rank scenario; the JAX references are
    computed here while they run."""
    return World(tmp_path_factory.mktemp("world2"), 2, SCENARIOS_2,
                 inputs["root"])


@pytest.fixture(scope="module")
def world1(inputs, tmp_path_factory):
    return World(tmp_path_factory.mktemp("world1"), 1, ("world_one",),
                 inputs["root"])


# ------------------------------------------------------------- references
class _KSVQEHeadInEval:
    """The JAX VQANetwork's KSVQE branch for ``_loss_and_aux`` with the
    head in eval (no dropout), as the port's side runs it."""

    def __init__(self, cfg):
        self.backbone = JKSVQE(config=cfg, dtype=jnp.float32)
        self.head = JVQAHead(hidden_channels=16)

    def apply(self, variables, batch, train, mutable, rngs):
        p = variables["params"]
        (feat, dis), mutated = self.backbone.apply(
            {"params": p["KSVQE_backbone"],
             "batch_stats": variables["batch_stats"]["KSVQE_backbone"]},
            batch, train=train, mutable=mutable, rngs=rngs)
        s = self.head.apply({"params": p["KSVQE_head"]}, feat, train=False)
        return ([s], dis), {"batch_stats": {
            "KSVQE_backbone": mutated["batch_stats"]}}


def _data_mesh():
    return Mesh(np.asarray(jax.devices()[:2]), ("data",))


def _pmean_step(loss_fn):
    """shard_map over 2 devices of ``value_and_grad(loss_fn)`` (params
    replicated, batch split), the gradients and aux pmean'd: JAX's DDP
    step before its optimizer (kvq_tpu/parallel/steps.py:91-106)."""
    def step(params, stats, batch):
        (_, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, stats, batch)
        return jax.lax.pmean(grads, "data"), jax.lax.pmean(aux, "data")

    return jax.jit(shard_map(step, mesh=_data_mesh(),
                             in_specs=(P(), P(), P("data")),
                             out_specs=(P(), P()), check_vma=False))


@pytest.fixture(scope="module")
def ksvqe_ref(inputs, world2):
    cfg, params, stats, batch = inputs["ksvqe"]
    jcfg = dataclasses.replace(cfg, s2d_input=True, drop_path_rate=0.0,
                               sigma=0.0)
    model = _KSVQEHeadInEval(jcfg)
    config = {"model": {"type": "KSVQE"}, "contra_loss_weight": 0.3,
              "rank_loss_weight": 0.0}

    def loss_fn(p, s, b):
        rng = jax.random.fold_in(jax.random.key(0),
                                 jax.lax.axis_index("data"))
        loss, (aux, _) = jsteps._loss_and_aux(model, config, p, s, b, rng)
        return loss, aux

    grads, aux = _pmean_step(loss_fn)(
        params, stats, {k: jnp.asarray(v) for k, v in batch.items()})
    return {k: float(v) for k, v in aux.items()}, grads


@pytest.fixture(scope="module")
def svqa_ref(inputs, world2):
    """JAX's DDP step (f32) from the trainer's initial state, and the
    pmean'd gradients of the same step in float64."""
    jt, mesh, batch = inputs["jax_trainer"], inputs["mesh"], \
        inputs["svqa_batch"]
    step = jsteps.make_ddp_train_step(jt.model, jt._tx, SVQA_DDP_CFG, mesh,
                                      jt.ema_decay)
    new_state, aux = step(jt.state, shard_batch(
        mesh, array_batch(batch, to_device=False)), jax.random.key(0))
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda a: jnp.asarray(a, jnp.float64), t)
        backbone = JFeatureResNet(layers=LAYERS, dtype=jnp.float64,
                                  bn_axis_name="data")
        head = JSimpleVQAHead(hidden_channels=128, dtype=jnp.float64)

        def loss_fn(p, stats, b):
            feat, _ = backbone.apply(
                {"params": p["simpleVQA_backbone"], "batch_stats": stats},
                b, train=True, mutable=["batch_stats"])
            s = head.apply({"params": p["simpleVQA_head"]}, feat)
            loss = JL.total_loss([s], b["label"], None, 0.3, 0.0)[0]
            return loss, loss

        grads, _ = _pmean_step(loss_fn)(
            f64(jt.state.params), f64(jt.state.batch_stats[
                "simpleVQA_backbone"]), f64(batch))
        grads = jax.tree_util.tree_map(np.asarray, grads)
    return float(aux["total_loss"]), new_state, grads


# -------------------------------------------------------------------- tests
def test_two_rank_ksvqe_step_matches_jax_ddp_step(inputs, world2, ksvqe_ref):
    aux_ref, grads_ref = ksvqe_ref
    r0, r1 = world2.scenario("ksvqe")
    for r in (r0, r1):
        assert r["aux"].keys() == aux_ref.keys()
        for k in aux_ref:
            np.testing.assert_allclose(r["aux"][k], aux_ref[k], rtol=1e-5,
                                       err_msg=k)
    cfg = inputs["ksvqe"][0]
    grads = dict(r0["grads"])
    assert set(grads) == set(r0["trainable"])

    def to_jax(values):
        sd = {n: values.get(n, np.zeros(p.shape, np.float32))
              for n, p in r0["params"].items()}
        sd.update({n: b.numpy() for n, b in r0["buffers"].items()})
        return dict(jax.tree_util.tree_flatten_with_path(convert_ksvqe_full(
            sd, depths=cfg.depths, clip_layers=cfg.clip_layers,
            contrique_layers=cfg.contrique_layers)[0])[0])

    got = to_jax(grads)
    trained = to_jax({n: np.ones(r0["params"][n].shape, np.float32)
                      for n in r0["trainable"]})
    checked = 0
    for path, want in jax.tree_util.tree_flatten_with_path(grads_ref)[0]:
        if np.asarray(trained[path]).max() > 0:
            _grad_close(got[path], want, jax.tree_util.keystr(path))
            checked += 1
    assert checked > 50
    for n, p in r0["params"].items():
        assert torch.equal(p, r1["params"][n]), n


def test_two_rank_simplevqa_synced_batchnorm_step_matches_jax(world2,
                                                              svqa_ref):
    loss_ref, new_state, grads_f64 = svqa_ref
    r0, r1 = world2.scenario("svqa")
    for r in (r0, r1):
        np.testing.assert_allclose(r["aux"]["total_loss"], loss_ref,
                                   rtol=1e-5)
    want, _ = map_jax_tree(_np_tree(new_state.params),
                           _np_tree(new_state.batch_stats))
    stats = [n for n in want if "running_" in n]
    # the stem's BatchNorm and 4 bottlenecks' 3 + their downsample's
    assert len(stats) == 2 * (1 + 4 * 4)
    for n in stats:
        np.testing.assert_allclose(r0["buffers"][n].numpy(),
                                   want[n].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=n)
        assert torch.equal(r0["buffers"][n], r1["buffers"][n]), n
    for n, p in r0["params"].items():
        assert torch.equal(p, r1["params"][n]), n
    gsd = state_dict_from_jax(grads_f64)
    f64 = world2.scenario("svqa_f64")
    for r in f64:
        assert set(r["grads"]) == set(gsd)
        for n, g in r["grads"].items():
            _grad_close(g, gsd[n].numpy(), n)


def test_two_rank_simplevqa_step_in_bf16_keeps_f32_synced_statistics(
        world2):
    """The shipped compute dtype: a finite loss, every running statistic
    float32, moved and equal on both ranks, the ranks' parameters
    bit-equal."""
    r0, r1 = world2.scenario("svqa_bf16")
    assert np.isfinite(r0["aux"]["total_loss"]) and r0["aux"] == r1["aux"]
    stats = [n for n in r0["buffers"] if "running_" in n]
    assert stats
    for n in stats:
        assert r0["buffers"][n].dtype == torch.float32, n
        assert torch.equal(r0["buffers"][n], r1["buffers"][n]), n
    assert not torch.equal(r0["buffers"][stats[0]],
                           torch.zeros_like(r0["buffers"][stats[0]]))
    for n, p in r0["params"].items():
        assert torch.equal(p, r1["params"][n]), n


def test_ddp_route_at_world_one_is_the_one_process_step(world1):
    (diffs,) = world1.scenario("world_one")
    assert diffs == {k: 0.0 for k in diffs} and len(diffs) == 6, diffs


def _one_process_eval(config, tmp_path, monkeypatch):
    monkeypatch.setattr(PD, "NATIVE", False)
    _, val = build_loaders(config)
    metrics = Trainer(config, device="cpu", seed=0).evaluate(val.epoch(0))
    results = cli_test.run(config, str(tmp_path / "ref.txt"), device="cpu")
    return metrics, results


def test_gathered_eval_equals_one_process(inputs, world2, tmp_path,
                                          monkeypatch):
    """5 videos on 2 ranks: rank 0 scores 0, 2, 4 and rank 1 1, 3, 0 (the
    wrap); the gathered metrics and output.txt are the one process's."""
    config = inputs["cli_config"]
    metrics, results = _one_process_eval(config, tmp_path, monkeypatch)
    ranks = world2.scenario("evaluate")
    assert [r["shard"] for r in ranks] == [(0, 2), (1, 2)]
    assert [r["rows"][0] for r in ranks] == [[0, 2, 4], [1, 3, 0]]
    for r in ranks:
        np.testing.assert_allclose(r["metrics"], tuple(metrics), rtol=1e-6)
        assert [n for n, _ in r["cli"]] == [n for n, _ in results]
        np.testing.assert_allclose([s for _, s in r["cli"]],
                                   [s for _, s in results], atol=1e-6)
    out = world2.out
    assert not (out / "output_rank1.txt").exists()
    lines = (out / "output_rank0.txt").read_text().splitlines()
    ref = (tmp_path / "ref.txt").read_text().splitlines()
    assert [ln.split(",")[0] for ln in lines] == \
        [ln.split(",")[0] for ln in ref]
    np.testing.assert_allclose([float(ln.split(",")[1]) for ln in lines],
                               [float(ln.split(",")[1]) for ln in ref],
                               atol=1e-6)


def test_gathered_rows_merge_as_jax(world2):
    ranks = world2.scenario("evaluate")
    index, scores, labels = (sum((r["rows"][c] for r in ranks), [])
                             for c in range(3))
    seen, order = {}, []
    JTrainer._merge_rows(seen, order, index, scores, labels)
    assert len(index) == N_VAL + 1 and len(order) == N_VAL
    want = (sorted(order), [seen[i][0] for i in sorted(order)],
            [seen[i][1] for i in sorted(order)])
    for r in ranks:
        assert tuple(r["gathered"]) == want
    assert psteps.merge_rows(index, scores, labels) == want


def test_cli_train_on_two_ranks_writes_on_rank_0_only(world2):
    r0, r1 = world2.scenario("cli_train")
    assert r0["step"] == r1["step"] == 1  # 4 videos, 2 a rank a step
    assert r0["files"] == ["tiny_head_val_n_finetuned.pth",
                           "tiny_head_val_s_finetuned.pth",
                           "tiny_last_state.pt", "tiny_metrics.jsonl"]
    assert r1["files"] == []
    for n, p in r0["params"].items():
        assert torch.equal(p, r1["params"][n]), n
    for e, f in zip(r0["ema"], r1["ema"]):
        assert torch.equal(e, f)
    # the last state keeps each rank's generator, which a resume takes back
    assert not torch.equal(r0["generator"], r1["generator"])
    for r in (r0, r1):
        assert torch.equal(r["resumed_generator"], r["generator"])
    first = json.loads((world2.out / "work_rank0" / "tiny_metrics.jsonl")
                       .read_text().splitlines()[0])
    assert first["step"] == 1 and "train/total_loss" in first


def test_two_ranks_refuse_no_ddp_and_a_batch_of_one(world2):
    for r in world2.scenario("refusals"):
        assert r["world"] == 2
        assert "ddp" in r["no ddp"]
        assert "at least 2 samples" in r["batch of 1"]


def test_trainer_without_a_group_ignores_ddp():
    tr = Trainer(dict(svqa_cfg(), ddp=True), device="cpu")
    assert not tr.ddp and (tr.rank, tr.world) == (0, 1)


class _Counting:
    """A dataset whose items are their own index."""

    def __init__(self, opt):
        self.n = opt["n"]

    def __len__(self):
        return self.n

    def __getitem__(self, i, epoch=0):
        return {"label": float(i)}


@pytest.mark.parametrize("world", [2, 3])
def test_loader_shards_match_jax(world, monkeypatch):
    monkeypatch.setitem(DATASETS._items, "_Counting", _Counting)
    n = 11
    config = {"batch_size": 2, "eval_batch_size": 2, "num_workers": 2,
              "seed": 5, "model": {"type": "KSVQE"},
              "data": {s: {"type": "_Counting", "args": {"n": n}}
                       for s in ("train", "val")}}
    seen = {"train": set(), "val": set()}
    for k in range(world):
        train, val = build_loaders(config, (k, world))
        jtrain = JLoader(_Counting({"n": n}), batch_size=2, shuffle=True,
                         num_workers=2, seed=5, drop_last=True,
                         shard=(k, world))
        jval = JLoader(_Counting({"n": n}), batch_size=2, shuffle=False,
                       num_workers=2, shard=(k, world))
        for split, port, ref in (("train", train, jtrain),
                                 ("val", val, jval)):
            assert len(port) == len(ref)
            for epoch in (0, 1):
                got = [b["sample_index"].tolist() for b in port.epoch(epoch)]
                want = [b["sample_index"].tolist() for b in ref.epoch(epoch)]
                assert got == want, (split, k, epoch)
                seen[split].update(i for b in got for i in b)
    assert seen["val"] == set(range(n))


def test_metric_logger_records_match_jax(tmp_path, capsys):
    calls = [(2, {"total_loss": 0.5, "plcc_loss": np.float32(0.25)},
              "train/"),
             (2, {"best_srcc": 0.75, "note": "x"}, "val_n/"),
             (3, {"best_rmse": 1999.0}, "")]
    out = {}
    for name, mod in (("jax", jlogging), ("port", plogging)):
        logger = mod.MetricLogger(str(tmp_path / name), "tiny")
        for step, values, prefix in calls:
            logger.log(step, values, prefix=prefix)
        recs = [json.loads(ln) for ln in
                (tmp_path / name / "tiny_metrics.jsonl").read_text()
                .splitlines()]
        out[name] = ([{k: v for k, v in r.items() if k != "time_s"}
                      for r in recs], capsys.readouterr().out)
    assert out["port"] == out["jax"]
    assert not (tmp_path / "unused").exists()
    plogging.MetricLogger(str(tmp_path / "unused"))  # writes nothing yet
    assert not (tmp_path / "unused").exists()


def test_count_params_flops_and_trace(inputs, tmp_path):
    params = inputs["ksvqe"][1]
    net = VQANetwork(tiny_config())
    assert plogging.count_params(net) == jlogging.count_params(params)
    lin = torch.nn.Linear(16, 8)
    x = torch.zeros(4, 16)
    assert plogging.flops_estimate(lin, x) == 2 * 4 * 16 * 8
    with plogging.profile_trace(str(tmp_path / "trace")):
        lin(x)
    assert json.loads((tmp_path / "trace" / "trace.json").read_text())

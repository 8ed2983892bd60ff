"""The port's CLIs end to end on the CPU, over tiny mp4 files written with
cv2 and a tiny KSVQE config written as YAML.

``cli.test``: the scores are within 1e-5 (float32) of the JAX tiny model's
scores on the JAX Loader's batches, with the same weights (the JAX trees
carried over by ``core/from_jax.py`` and loaded through
``test_load_path``); ``output.txt`` and the CSV are written as the JAX CLI
writes them.  ``cli.train``: one epoch, then a resume from the
``_last_state.pt`` it wrote, at tiny width.  ``cli.metric_score``: the JSON
of ``score_prediction_file``.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

cv2 = pytest.importorskip("cv2")

import kvq_tpu.runtime
from __graft_entry__ import _tiny_ksvqe_config
from kvq_tpu.data.datasets import KVQDataset as JKVQDataset
from kvq_tpu.data.pipeline import Loader as JLoader
from kvq_tpu.nn.heads import VQAHead as JVQAHead
from kvq_tpu.nn.ksvqe import KSVQE as JKSVQE
from kvq_tpu_torch.cli import metric_score as cli_metric
from kvq_tpu_torch.cli import test as cli_test
from kvq_tpu_torch.cli import train as cli_train
from kvq_tpu_torch.core.checkpoint import load_checkpoint
from kvq_tpu_torch.core.from_jax import state_dict_from_jax

from test_torch_modules import _batch, tiny_config

# fragments 5 x 8 px = 40 px, resize view 32 px: the tiny model's shapes
SAMPLE = dict(fragments_h=5, fragments_w=5, fsize_h=8, fsize_w=8,
              size_h=32, size_w=32, aligned=8, clip_len=8, frame_interval=2)
N_VIDEOS = 4


@pytest.fixture(autouse=True)
def no_native_runtime(monkeypatch):
    """The JAX package's cv2/numpy path is the reference."""
    monkeypatch.setattr(kvq_tpu.runtime, "available", lambda: False)


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    """Tiny mp4s (some shorter than 131 frames: padded), annotation TXTs,
    the tiny JAX weights saved for the port, and a YAML config."""
    root = tmp_path_factory.mktemp("kvq")
    vids = root / "videos"
    vids.mkdir()
    rng = np.random.default_rng(0)
    lines = []
    for i in range(N_VIDEOS):
        name = f"v{i}.mp4"
        h, w = (72, 96) if i % 2 else (90, 64)
        wr = cv2.VideoWriter(str(vids / name),
                             cv2.VideoWriter_fourcc(*"mp4v"), 30, (w, h))
        base = rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)
        for t in range(60 + 50 * i):
            wr.write(np.roll(base, 3 * t, axis=1))
        wr.release()
        lines.append(f"{name},{i % 3},{i % 2},{1.0 + 0.7 * i}\n")
    for split in ("train", "val"):
        (root / f"{split}.txt").write_text("".join(lines))

    cfg = _tiny_ksvqe_config()
    model = JKSVQE(config=cfg, dtype=jnp.float32)
    jb = {k: jnp.asarray(v) for k, v in _batch().items()}
    v = jax.jit(lambda b: model.init(
        {"params": jax.random.key(0), "qrs": jax.random.key(1)}, b,
        train=False))(jb)
    head = JVQAHead(hidden_channels=16)
    hv = head.init(jax.random.key(2), jnp.zeros((1, 4, 3, 3, 32)))
    params = {"KSVQE_backbone": jax.tree.map(np.asarray, v["params"]),
              "KSVQE_head": jax.tree.map(np.asarray, hv["params"])}
    stats = {"KSVQE_backbone": jax.tree.map(np.asarray, v["batch_stats"])}
    weights = root / "tiny_ksvqe.pth"
    torch.save({"params": state_dict_from_jax(params, stats)}, weights)

    def split(phase, num_clips, ann):
        return {"type": "ViewDecompositionDataset_KVQ", "args": {
            "phase": phase, "anno_file": str(root / ann),
            "data_prefix": str(vids), "sample_types": {
                "technical": dict(SAMPLE, num_clips=num_clips)}}}

    config = dict(tiny_config(s2d_input=True, use_pallas=True),
                  num_epochs=3, warmup_epochs=0.5, batch_size=2,
                  num_workers=3, seed=7, test_load_path=str(weights),
                  optimizer={"lr": 1e-3, "wd": 0.05},
                  data={"train": split("train", 1, "train.txt"),
                        "val": split("test", 3, "val.txt")})
    path = root / "tiny.yml"
    path.write_text(yaml.safe_dump(config))
    jax_model = (dataclasses.replace(cfg, s2d_input=True), v, hv)
    return root, str(path), config, jax_model


def _jax_scores(config, jax_model):
    """The JAX tiny model on the JAX Loader's val batches: per-video mean
    score, in loader order."""
    cfg, v, hv = jax_model
    args = dict(config["data"]["val"]["args"], fragment_s2d=True)
    loader = JLoader(JKVQDataset(args), batch_size=1, num_workers=2)
    model = JKSVQE(config=cfg, dtype=jnp.float32)
    head = JVQAHead(hidden_channels=16)

    @jax.jit
    def fwd(frag, res, dis):
        feat, _ = model.apply(v, {"fragment": frag, "resize_video": res,
                                  "dis_label": dis}, train=False)
        return head.apply(hv, feat)

    out = []
    for b in loader.epoch(0):
        s = fwd(b["fragment"], b["resize_video"], b["dis_label"])
        out.append((b["video_name"][0], float(np.asarray(s).mean())))
    return out


def test_cli_test_scores_match_jax(project, tmp_path, capsys):
    root, cfg_path, config, jax_model = project
    out, csv_out = tmp_path / "output.txt", tmp_path / "pred.csv"
    results = cli_test.main(["-o", cfg_path, "-out", str(out), "--csv",
                             str(csv_out), "--device", "cpu"])
    assert "loaded" in capsys.readouterr().out  # test_load_path merged
    want = _jax_scores(config, jax_model)
    assert [n for n, _ in results] == [n for n, _ in want] == [
        f"v{i}.mp4" for i in range(N_VIDEOS)]
    np.testing.assert_allclose([s for _, s in results],
                               [s for _, s in want], atol=1e-5, rtol=0)
    # the JAX CLI's files: video_name,score lines; the CSV with a header
    assert out.read_text() == "".join(f"{n},{s}\n" for n, s in results)
    assert csv_out.read_text() == "filename,score\n" + out.read_text()


def test_cli_metric_score_reads_the_cli_csv(project, tmp_path, capsys):
    root, cfg_path, _, _ = project
    pred = tmp_path / "pred.csv"
    cli_test.main(["-o", cfg_path, "-out", str(tmp_path / "o.txt"),
                   "--csv", str(pred), "--device", "cpu"])
    truth = tmp_path / "truth.csv"
    truth.write_text("filename,score\n" + "".join(
        f"v{i}.mp4,{1.0 + 0.7 * i}\n" for i in range(N_VIDEOS)))
    pairs = tmp_path / "pairs"
    pairs.mkdir()
    (pairs / "nonsource.csv").write_text("a,b\nv3.mp4,v0.mp4\nv2.mp4,v1.mp4\n")
    (pairs / "source.csv").write_text("a,b\nv1.mp4,v0.mp4\n")
    capsys.readouterr()
    res = cli_metric.main(["--pred", str(pred), "--truth", str(truth),
                           "--rank_pairs", str(pairs)])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == res
    assert all(np.isfinite(list(res.values())))
    assert res["score"] == pytest.approx(
        0.45 * res["srcc"] + 0.45 * res["plcc"] + 0.05 * res["acc_nonsource"]
        + 0.05 * res["acc_source"], abs=1e-15)


def test_cli_train_one_epoch_then_resume(project, tmp_path):
    root, cfg_path, config, _ = project
    work = tmp_path / "work"
    common = ["-o", cfg_path, "-t", "val", "-r", str(work), "--epochs", "1",
              "--device", "cpu"]
    best, best_ema = cli_train.main(common)
    state = work / "tiny_last_state.pt"
    first = load_checkpoint(str(state))
    assert first["step"] == 2  # 4 videos, batches of 2, drop_last
    assert first["schedule"]["last_epoch"] == 2
    files = sorted(os.listdir(work))
    assert files == ["tiny_head_val_n_finetuned.pth",
                     "tiny_head_val_s_finetuned.pth", "tiny_last_state.pt"]
    assert all(np.isfinite(best)) and all(np.isfinite(best_ema))

    tr = cli_train.run(yaml.safe_load(open(cfg_path)), str(work), "val",
                       epochs=1, resume_from=str(state), device="cpu")
    assert tr.step == 4
    again = load_checkpoint(str(state))
    assert again["step"] == 4 and again["schedule"]["last_epoch"] == 4
    # the schedule went on from where it stopped: lr of update 4 of 6
    steps, warm = 2 * 3, int(0.5 * 2)
    factor = 0.5 * (1 + np.cos(np.pi * (4 - warm) / steps))
    assert tr.optimizer.param_groups[0]["lr"] == pytest.approx(1e-3 * factor)
    assert any(not torch.equal(first["params"][k], again["params"][k])
               for k in first["params"])


def test_cli_test_trace_dir_writes_spans(project, tmp_path, capsys):
    """``--trace_dir``: the run's spans, the Loader's and the kernels'
    among them, in ``spans.jsonl`` and its summary printed."""
    _, cfg_path, _, _ = project
    trace = tmp_path / "spans"
    cli_test.main(["-o", cfg_path, "-out", str(tmp_path / "o.txt"),
                   "--device", "cpu", "--trace_dir", str(trace)])
    spans = [json.loads(x) for x in open(trace / "spans.jsonl")]
    names = {s["name"] for s in spans}
    assert {"kvq.loader.wait", "kvq.loader.item", "kvq.loader.collate",
            "kvq.eval.feed", "kvq.eval.forward", "kvq.eval.readback",
            "kvq.pipeline.prep", "kvq.k1"} <= names
    assert sorted(s["unit"] for s in spans
                  if s["name"] == "kvq.eval.forward") == list(range(N_VIDEOS))
    assert sum(s["name"] == "kvq.loader.item" for s in spans) == N_VIDEOS
    assert "kvq.eval.forward" in capsys.readouterr().out
    assert json.load(open(trace / "spans_summary.json"))[
        "kvq.eval.forward"]["dispatch"]["count"] == N_VIDEOS


def test_cli_train_trace_dir_writes_spans(project, tmp_path):
    _, cfg_path, _, _ = project
    trace = tmp_path / "spans"
    cli_train.main(["-o", cfg_path, "-t", "val", "-r", str(tmp_path / "w"),
                    "--epochs", "1", "--device", "cpu", "--trace_dir",
                    str(trace)])
    spans = [json.loads(x) for x in open(trace / "spans.jsonl")]
    steps = [s["unit"] for s in spans if s["name"] == "kvq.train.backward"]
    assert steps == [0, 1]  # 4 videos, batches of 2
    assert {"kvq.train.feed", "kvq.train.cast", "kvq.train.forward",
            "kvq.train.optimizer", "kvq.train.ema", "kvq.eval.forward",
            "kvq.loader.item"} <= {s["name"] for s in spans}


def test_cli_train_needs_both_splits(project, tmp_path):
    _, _, config, _ = project
    cfg = dict(config, data={"train": config["data"]["train"]})
    with pytest.raises(ValueError, match="data.train and data.val"):
        cli_train.run(cfg, str(tmp_path), device="cpu")
    cfg = dict(config, data={"train": config["data"]["train"]})
    with pytest.raises(ValueError, match="data.val"):
        cli_test.run(cfg, str(tmp_path / "o.txt"), device="cpu")

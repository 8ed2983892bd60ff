"""The port's SlowFast-R50 and ``cli.slowfast_features`` against the JAX
package, on the CPU in float32.

The JAX weights come from ``init`` (BatchNorm scales, biases and running
statistics drawn at random) and reach the port through
``core/from_jax.py:map_slowfast_tree``; the network is cut in depth to one
block a stage, its widths (2048 slow, 256 fast) are the architecture's.
Tolerances: pooled features atol 1e-5 (f32 roundoff through the two
pathways, summed in another order); ``pack_pathways`` indices, the clips of
a cv2-written mp4 and the feature files' names equal; the files' values
atol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

cv2 = pytest.importorskip("cv2")

from kvq_tpu.cli import slowfast_features as jcli
from kvq_tpu.core import checkpoint as jckpt
from kvq_tpu.core.torch_import import convert_slowfast_r50
from kvq_tpu.nn.slowfast import SlowFastR50 as JSlowFast
from kvq_tpu.nn.slowfast import pack_pathways as jpack
from kvq_tpu_torch.cli import slowfast_features as cli
from kvq_tpu_torch.core.checkpoint import merge_state_dict
from kvq_tpu_torch.core.from_jax import map_slowfast_tree
from kvq_tpu_torch.nn.slowfast import SlowFastR50, pack_pathways

from test_torch_simplevqa import _np_tree, _randomize_bn

LAYERS = (1, 1, 1, 1)


@pytest.fixture(scope="module")
def jax_slowfast():
    """Tiny JAX SlowFast-R50 variables (numpy) and its jitted apply."""
    m = JSlowFast(layers=LAYERS)
    slow, fast = jpack(np.zeros((1, 8, 16, 16, 3), np.float32))
    v = jax.jit(lambda s, f: m.init(jax.random.key(0), s, f))(slow, fast)
    params, stats = _np_tree(v["params"]), _np_tree(v["batch_stats"])
    _randomize_bn(params, stats)
    variables = {"params": params, "batch_stats": stats}
    apply = jax.jit(lambda vs, s, f: m.apply(vs, s, f, train=False))
    return m, variables, apply


def _port(variables):
    net = SlowFastR50(layers=LAYERS)
    sd, unread = map_slowfast_tree(variables["params"],
                                   variables["batch_stats"])
    assert unread == []
    net.load_state_dict(sd, strict=True)
    return net.eval()


def test_pack_pathways_matches_jax():
    frames = np.random.default_rng(0).normal(size=(2, 32, 4, 4, 3)).astype(
        np.float32)
    js, jf = jpack(frames)
    ps, pf = pack_pathways(frames)
    ts, tf = pack_pathways(torch.from_numpy(frames))
    for s, f in ((ps, pf), (ts.numpy(), tf.numpy())):
        np.testing.assert_array_equal(s, js)
        np.testing.assert_array_equal(f, jf)
    assert ps.shape == (2, 8, 4, 4, 3)


def test_slowfast_features_match_jax(jax_slowfast):
    m, variables, apply = jax_slowfast
    clip = np.random.default_rng(2).normal(size=(2, 8, 16, 16, 3)).astype(
        np.float32)
    js, jf = apply(variables, *jpack(clip))
    net = _port(variables)
    with torch.no_grad():
        s, f = net(*pack_pathways(torch.from_numpy(clip)))
    assert s.shape == (2, 2048) and f.shape == (2, 256)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-5)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=1e-5)


def test_pytorchvideo_names(jax_slowfast):
    """The port's state_dict under pytorchvideo's names: kvq_tpu's
    ``convert_slowfast_r50`` reads it back to the JAX trees exactly; a hub
    checkpoint's classification head is reported unexpected."""
    _, variables, _ = jax_slowfast
    net = _port(variables)
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    p, s = convert_slowfast_r50(sd, layers=LAYERS)
    for got, want in ((p, variables["params"]),
                      (s, variables["batch_stats"])):
        flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
        flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
        assert flat_g.keys() == flat_w.keys()
        for path, leaf in flat_w.items():
            np.testing.assert_array_equal(flat_g[path], leaf)
    hub = {k: torch.from_numpy(v.copy()) for k, v in sd.items()}
    hub["blocks.6.proj.weight"] = torch.zeros(400, 2304)
    fresh = SlowFastR50(layers=LAYERS)
    report = merge_state_dict(fresh, hub)
    assert report == {"missing": [], "unexpected": ["blocks.6.proj.weight"],
                      "mismatched": []}


def _write_mp4(path, n, fps, h=40, w=56, seed=0):
    rng = np.random.default_rng(seed)
    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps,
                         (w, h))
    base = rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)
    for t in range(n):
        wr.write(np.roll(base, 2 * t, axis=1))
    wr.release()


def _jax_frames(path):
    """Frames and fps as the JAX CLI reads them."""
    cap = cv2.VideoCapture(str(path))
    fps = int(round(cap.get(cv2.CAP_PROP_FPS)))
    frames = []
    while True:
        ok, fr = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(fr, cv2.COLOR_BGR2RGB))
    cap.release()
    return np.stack(frames), fps


@pytest.mark.parametrize("n,fps", [(45, 10), (75, 10)])
def test_video_to_clips_matches_jax(tmp_path, n, fps):
    """Per-second 32-frame clips of a cv2-written mp4: the last frame
    repeated past the end, at least 8 clips (4 and 7 seconds here), 10
    clips at 0 fps; equal whether frames are resized as they are read or
    all at once."""
    path = tmp_path / "v.mp4"
    _write_mp4(path, n, fps)
    frames, got_fps = _jax_frames(path)
    assert got_fps == fps and len(frames) == n
    want = jcli.video_to_clips(frames, fps, 24)
    resized, read_fps = cli.read_resized(str(path), 24)
    assert read_fps == fps
    for got in (cli.video_to_clips(frames, fps, 24),
                cli.clips_of(resized, read_fps)):
        assert len(got) == len(want) == 8
        for a, b in zip(got, want):
            assert a.shape == (32, 24, 24, 3) and a.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    zero = jcli.video_to_clips(frames[:5], 0, 24)
    got = cli.video_to_clips(frames[:5], 0, 24)
    assert len(got) == len(zero) == 10
    for a, b in zip(got, zero):
        np.testing.assert_array_equal(a, b)


def test_cli_writes_the_jax_feature_files(tmp_path, jax_slowfast,
                                          monkeypatch):
    """``main`` on two cv2-written mp4s with tiny weights from a JAX msgpack
    writes the files of kvq_tpu's ``extract_features`` (names equal, values
    atol 1e-5)."""
    m, variables, apply = jax_slowfast
    root = tmp_path / "videos"
    root.mkdir()
    names = ["a.mp4", "b.mp4"]
    for i, name in enumerate(names):
        _write_mp4(root / name, 35 + 20 * i, 10, seed=i)
    (tmp_path / "list.csv").write_text("name,score\na.mp4,1\nb.mp4,2\n")
    weights = tmp_path / "slowfast.msgpack"
    jckpt.save_checkpoint(str(weights), variables)
    monkeypatch.setattr(cli, "SlowFastR50",
                        lambda: SlowFastR50(layers=LAYERS))
    out = tmp_path / "feat"
    stats = cli.main(["--videos_csv", str(tmp_path / "list.csv"),
                      "--video_root", str(root), "--out", str(out),
                      "--resize", "24", "--load_path", str(weights),
                      "--device", "cpu"])
    assert stats["videos"] == 2 and stats["clips"] == 16
    for name in names:
        frames, fps = _jax_frames(root / name)
        clips = jcli.video_to_clips(frames, fps, 24)
        want = jcli.extract_features(m, variables, clips, apply)
        files = sorted(p.name for p in (out / name).iterdir())
        assert files == sorted(
            f"feature_{k}_{w}_feature.npy" for k in range(len(want))
            for w in ("slow", "fast"))
        for k, (s, f) in enumerate(want):
            got_s = np.load(out / name / f"feature_{k}_slow_feature.npy")
            got_f = np.load(out / name / f"feature_{k}_fast_feature.npy")
            assert got_s.shape == (2048,) and got_s.dtype == np.float32
            np.testing.assert_allclose(got_s, s, atol=1e-5)
            np.testing.assert_allclose(got_f, f, atol=1e-5)


def test_cli_needs_cuda_unless_asked_for_cpu(tmp_path, monkeypatch):
    (tmp_path / "list.csv").write_text("name\n")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["--videos_csv", str(tmp_path / "list.csv"), "--video_root",
            str(tmp_path), "--out", str(tmp_path / "feat")]
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(args)
    assert not (tmp_path / "feat").exists()
    monkeypatch.setattr(cli, "SlowFastR50",
                        lambda: SlowFastR50(layers=LAYERS))
    assert cli.main(args + ["--device", "cpu"])["videos"] == 0

"""The port's native host runtime (kvq_tpu_torch/runtime, C++ built with
g++ here) against data/resize.py, the port's numpy branch and the JAX
package's native runtime (kvq_tpu.runtime, C++ on OpenCV):

  - the fused mosaic: bit-equal to kvq_tpu.runtime's (the same expression
    per pixel), within 1e-5 of the numpy branch (which normalises as
    v * (1/std) - mean/std);
  - the resize: its uint8 frames equal data/resize.py's (which equals cv2's
    area and bilinear resize, growing and mixed sizes too), on one thread
    and on four; normalised, within 1e-5 of the numpy branch and within
    one CLIP_LSB (one uint8 step through the CLIP std, plus f32 rounding)
    of kvq_tpu.runtime's, whose bilinear goes through OpenCV's own code;
  - one thread and four give the same bits;
  - KVQDataset takes the native branch exactly where the JAX package's
    does, draws the same frames and fragments as its numpy branch, and
    matches the JAX package's native items;
  - a failed build raises with the compiler's output.

The comparisons with kvq_tpu.runtime skip where its library cannot be
built (it needs OpenCV's C++ headers); everything else runs.
"""

import numpy as np
import pytest

import kvq_tpu.runtime as JR
from kvq_tpu.data import datasets as JD
from kvq_tpu_torch import runtime as R
from kvq_tpu_torch.data import datasets as PD
from kvq_tpu_torch.data import views as PV
from kvq_tpu_torch.data.fragments import fragment_index_maps

CLIP_LSB = 1.0 / (255.0 * float(PV.CLIP_STD.min()))  # 0.0152
ONE_LSB = CLIP_LSB + 1e-5


@pytest.fixture(scope="module")
def jax_native():
    if not JR.ensure_built():
        pytest.skip("kvq_tpu.runtime cannot be built here (no OpenCV C++)")
    return JR


def _video(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape + (3,),
                                                dtype=np.uint8)


MOSAICS = [  # (T, H, W), fragments, fsize, aligned
    ((8, 270, 480), 9, 16, 4),
    ((16, 1280, 720), 9, 32, 8),
    ((1, 64, 96), 2, 16, 32),  # one frame: aligned 1
]


@pytest.mark.parametrize("shape,frags,fsize,aligned", MOSAICS)
def test_mosaic_matches_jax_native_and_numpy(shape, frags, fsize, aligned,
                                             jax_native):
    video = _video(shape)
    T, H, W = shape
    aligned = 1 if T == 1 else aligned
    ymap, xmap = fragment_index_maps(H, W, T, frags, frags, fsize, fsize,
                                     aligned, rng=np.random.default_rng(1))
    got = R.fragment_mosaic_normalize(video, ymap, xmap, aligned,
                                      PV.IMAGENET_255_MEAN,
                                      PV.IMAGENET_255_STD)
    want = jax_native.fragment_mosaic_normalize(
        video, ymap, xmap, aligned, PV.IMAGENET_255_MEAN,
        PV.IMAGENET_255_STD)
    np.testing.assert_array_equal(got, want)
    tg = np.arange(T) // aligned
    gathered = video[np.arange(T)[:, None, None], ymap[tg], xmap[tg]]
    np.testing.assert_allclose(got, PV.normalize(gathered, "imagenet_255"),
                               atol=1e-5, rtol=0)


RESIZES = [  # (T, H, W) -> (oh, ow)
    ((3, 1280, 720), (112, 112)),  # portrait short-form, area
    ((3, 540, 960), (112, 112)),
    ((2, 224, 224), (112, 112)),   # 2x: (sum + 2) >> 2
    ((2, 336, 336), (112, 112)),   # 3x: sum * (1 / 9)
    ((2, 224, 336), (112, 112)),   # 2x by 3x
    ((2, 101, 77), (32, 32)),      # odd sizes
    ((2, 90, 64), (32, 29)),
    ((2, 20, 30), (64, 48)),       # bilinear upscale
    ((2, 50, 30), (40, 45)),       # one side grows: area's linear taps
    ((2, 64, 64), (64, 64)),       # same size: a copy
    ((2, 90, 400), (224, 224)),    # mixed: area's taps, one side grows
    ((2, 400, 90), (112, 112)),
    ((2, 200, 400), (224, 224)),
    ((2, 113, 451), (112, 112)),
    ((2, 240, 426), (520, 520)),   # 240p to SimpleVQA's view: bilinear
    ((2, 240, 320), (288, 384)),
    ((2, 7, 29), (300, 41)),
]


@pytest.mark.parametrize("shape,out", RESIZES)
def test_resize_equals_data_resize_and_jax_native(shape, out, jax_native):
    video = _video(shape, seed=2)
    oh, ow = out
    got = R.resize(video, oh, ow)
    np.testing.assert_array_equal(got, PV.get_resized_video(video, oh, ow))
    np.testing.assert_array_equal(R.resize(video, oh, ow, n_threads=1), got)
    norm = R.resize_normalize(video, oh, ow, PV.CLIP_MEAN, PV.CLIP_STD,
                              div255=True)
    np.testing.assert_allclose(norm, PV.normalize(got, "clip"), atol=1e-5,
                               rtol=0)
    want = jax_native.resize_normalize(video, oh, ow, PV.CLIP_MEAN,
                                       PV.CLIP_STD, div255=True)
    assert np.abs(norm - want).max() <= ONE_LSB


def test_threads_give_the_same_bits():
    video = _video((9, 300, 200), seed=3)
    ymap, xmap = fragment_index_maps(300, 200, 9, 3, 3, 32, 32, 3,
                                     rng=np.random.default_rng(0))
    for fn in (lambda n: R.resize(video, 112, 112, n_threads=n),
               lambda n: R.resize_normalize(video, 50, 70, PV.CLIP_MEAN,
                                            PV.CLIP_STD, True, n_threads=n),
               lambda n: R.fragment_mosaic_normalize(
                   video, ymap, xmap, 3, PV.IMAGENET_255_MEAN,
                   PV.IMAGENET_255_STD, n_threads=n)):
        np.testing.assert_array_equal(fn(1), fn(4))


def test_refuses_what_it_cannot_read():
    with pytest.raises(ValueError, match="uint8"):
        R.resize(np.zeros((1, 8, 8, 3), np.float32), 4, 4)
    ymap = np.full((1, 2, 2), 8, np.int32)
    with pytest.raises(ValueError, match="outside"):
        R.fragment_mosaic_normalize(_video((1, 8, 8)), ymap, ymap * 0, 1,
                                    PV.IMAGENET_255_MEAN, PV.IMAGENET_255_STD)


# --------------------------------------------------------------- datasets
ST = dict(fragments_h=5, fragments_w=5, fsize_h=16, fsize_w=16, size_h=112,
          size_w=112, aligned=8, clip_len=16, frame_interval=2, num_clips=1)


def _opt(size=(540, 960), **view):
    h, w = size
    return JD.make_synthetic_opt(
        n_videos=2, n_frames=140, height=h, width=w,
        sample_types={"technical": dict(ST, **view)}, phase="train", seed=3)


def _items(opt, i=1):
    return PD.KVQDataset(opt).__getitem__(i, epoch=1)


@pytest.mark.parametrize("size,view,native", [
    ((540, 960), {}, True),
    ((1280, 720), {"num_clips": 2}, True),
    ((60, 90), {}, False),                      # smaller than the mosaic
    ((540, 960), {"clip_len": 1}, True),        # one frame: aligned 1
])
def test_dataset_takes_the_native_branch_where_jax_does(
        monkeypatch, jax_native, size, view, native):
    """The branch taken, against the JAX package's own condition; the
    native item against the numpy item (same frames, same fragments: the
    generator is drawn alike, as ``ori_fragment``, drawn after the views,
    shows) and against the JAX package's native item."""
    opt = dict(_opt(size, **view), return_ori_fragment=True)
    calls = []
    mosaic = R.fragment_mosaic_normalize
    monkeypatch.setattr(R, "fragment_mosaic_normalize",
                        lambda *a, **k: calls.append(1) or mosaic(*a, **k))
    got = _items(opt)
    assert bool(calls) == native
    jds = JD.KVQDataset(opt)
    raw = np.zeros((max(1, view.get("clip_len", 16)),) + size + (3,),
                   np.uint8)
    jax_takes = JD._native_fragment_views(
        raw, JD._filter_view_opts(jds.sample_types["technical"]),
        np.random.default_rng(0)) is not None
    assert jax_takes == native
    monkeypatch.setattr(PD, "NATIVE", False)
    plain = _items(opt)
    assert got.keys() == plain.keys()
    for k in ("frame_inds", "ori_fragment", "label", "original_shape"):
        np.testing.assert_array_equal(np.asarray(got[k]["technical"]
                                                 if k == "frame_inds"
                                                 else got[k]),
                                      np.asarray(plain[k]["technical"]
                                                 if k == "frame_inds"
                                                 else plain[k]))
    for k in ("fragment", "resize_video"):
        np.testing.assert_allclose(got[k], plain[k], atol=1e-5, rtol=0)
    if native:
        want = jds.__getitem__(1, epoch=1)
        np.testing.assert_array_equal(got["fragment"], want["fragment"])
        assert np.abs(got["resize_video"] - want["resize_video"]).max() \
            <= ONE_LSB


def test_clip_that_aligned_does_not_divide_is_refused_by_numpy(
        monkeypatch, jax_native):
    """T % aligned != 0: neither package takes its native branch; the numpy
    branch refuses the clip."""
    opt = _opt(clip_len=12)
    monkeypatch.setattr(R, "fragment_mosaic_normalize", None)
    with pytest.raises(ValueError, match="multiple of aligned"):
        _items(opt)
    raw = np.zeros((12, 540, 960, 3), np.uint8)
    sopt = JD._filter_view_opts(opt["sample_types"]["technical"])
    assert JD._native_fragment_views(raw, sopt, None) is None


def test_native_items_s2d_packed_match_jax_native(jax_native):
    opt = dict(_opt((720, 1280), num_clips=3), fragment_s2d=True)
    got, want = _items(opt, 0), JD.KVQDataset(opt).__getitem__(0, epoch=1)
    assert got["fragment"].shape == (24, 20, 20, 96)
    np.testing.assert_array_equal(got["fragment"], want["fragment"])
    assert np.abs(got["resize_video"] - want["resize_video"]).max() <= ONE_LSB


# ------------------------------------------------------------------- build
@pytest.fixture
def fresh_build(monkeypatch, tmp_path):
    monkeypatch.setattr(R, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(R, "_lib", None)
    return tmp_path


def test_a_failed_build_raises_with_the_compiler_output(fresh_build,
                                                        monkeypatch):
    broken = fresh_build / "kvq_runtime.cpp"
    broken.write_text("int kvq_resize( {\n")
    monkeypatch.setattr(R, "SOURCE", broken)
    with pytest.raises(RuntimeError, match="kvq_runtime.cpp:1"):
        R.load()
    assert not list((fresh_build / "_build").iterdir())  # nothing half-built
    # the dataset does not fall back to numpy either
    with pytest.raises(RuntimeError, match="native runtime"):
        _items(_opt())


def test_no_compiler_raises(fresh_build, monkeypatch):
    monkeypatch.setenv("CXX", str(fresh_build / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        R.load()


def test_builds_once_into_the_cache(fresh_build):
    path = R.build()
    assert path.parent == fresh_build / "_build" and path.exists()
    mtime = path.stat().st_mtime_ns
    assert R.build() == path and path.stat().st_mtime_ns == mtime
    assert R.load() is R.load()

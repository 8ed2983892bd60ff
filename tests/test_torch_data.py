"""The port's host pipeline against kvq_tpu.data, on the same seeded inputs.

Samplers, index maps, mosaics, normalisation, the synthetic and OpenCV
sources, GenericViewDataset, KVQDataset and the Loader must be bit-equal.
The resize is held against cv2 itself, bit for bit: area, and bilinear
and area with a side growing, in OpenCV's generic code (its taps'
fractions rounded to float32, the vertical ones unclipped) on uint8 and in
area mode; float32 bilinear in the code of IPP, which cv2 calls for it
(fused multiply-adds, float64 positions).  So are the views of
``get_resized_video`` at growing and mixed sizes against kvq_tpu's, and the
upsample fallback of the mosaic against the JAX package's cv2 branch.
Both packages' native C++ runtimes are switched off: the JAX package's
numpy/cv2 path is the reference here for the port's numpy path.
"""

import itertools
import zlib

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

import kvq_tpu.runtime
from kvq_tpu.core import metrics as JM
from kvq_tpu.data import datasets as JD
from kvq_tpu.data import decode as JDec
from kvq_tpu.data import fragments as JF
from kvq_tpu.data import pipeline as JP
from kvq_tpu.data import samplers as JS
from kvq_tpu.data import views as JV
from kvq_tpu_torch.core import metrics as PM
from kvq_tpu_torch.core.registry import DATASETS
from kvq_tpu_torch.data import datasets as PD
from kvq_tpu_torch.data import decode as PDec
from kvq_tpu_torch.data import fragments as PF
from kvq_tpu_torch.data import pipeline as PP
from kvq_tpu_torch.data import samplers as PS
from kvq_tpu_torch.data import views as PV
from kvq_tpu_torch.data.resize import _fma, resize


@pytest.fixture(autouse=True)
def no_native_runtime(monkeypatch):
    """Both packages' numpy branches; the native ones are held in
    tests/test_torch_runtime.py."""
    monkeypatch.setattr(kvq_tpu.runtime, "available", lambda: False)
    monkeypatch.setattr(PD, "NATIVE", False)


def _video(shape, seed=0, dtype=np.uint8):
    r = np.random.default_rng(seed)
    v = r.integers(0, 256, shape, dtype=np.uint8)
    return v if dtype == np.uint8 else v.astype(np.float32) + r.random(
        shape, dtype=np.float32)


# ---------------------------------------------------------------- samplers
GRID = list(itertools.product((20, 64, 131, 300), (1, 8, 32), (1, 2, 4),
                              (1, 3), (None, 1, 4)))


@pytest.mark.parametrize("n,clip_len,interval,num_clips,t_frag", GRID)
def test_samplers_match_jax(n, clip_len, interval, num_clips, t_frag):
    sopt = dict(clip_len=clip_len, frame_interval=interval,
                num_clips=num_clips)
    if t_frag is not None:
        sopt["t_frag"] = t_frag
    a = JS.make_sampler(sopt, rng=np.random.default_rng(n))
    b = PS.make_sampler(sopt, rng=np.random.default_rng(n))
    for train in (False, True):
        np.testing.assert_array_equal(a(n, train), b(n, train))
    ja = JS.FragmentSampleFrames(clip_len, 2, interval, num_clips,
                                 rng=np.random.default_rng(1))
    pa = PS.FragmentSampleFrames(clip_len, 2, interval, num_clips,
                                 rng=np.random.default_rng(1))
    np.testing.assert_array_equal(ja(n), pa(n))
    for train in (False, True):
        ja = JS.SampleFrames(clip_len, interval, num_clips,
                             rng=np.random.default_rng(2))
        pa = PS.SampleFrames(clip_len, interval, num_clips,
                             rng=np.random.default_rng(2))
        np.testing.assert_array_equal(ja(n, train), pa(n, train))


# ---------------------------------------------------------------- mosaics
MOSAICS = [  # (T, H, W, fragments, fsize, aligned)
    (16, 300, 400, 7, 32, 8), (8, 1280 // 4, 720 // 4, 9, 16, 8),
    (1, 288, 288, 9, 32, 8), (4, 100, 70, 3, 32, 4),
]


@pytest.mark.parametrize("T,H,W,frags,fsize,aligned", MOSAICS)
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_fragment_maps_and_mosaics_match_jax(T, H, W, frags, fsize, aligned,
                                             dtype):
    v = _video((T, H, W, 3), seed=T + H, dtype=dtype)
    kw = dict(fragments_h=frags, fragments_w=frags, fsize_h=fsize,
              fsize_w=fsize, aligned=aligned)
    jm = JF.fragment_index_maps(H, W, T, rng=np.random.default_rng(3), **kw)
    pm = PF.fragment_index_maps(H, W, T, rng=np.random.default_rng(3), **kw)
    for a, b in zip(jm, pm):
        np.testing.assert_array_equal(a, b)
    for fn, h in (("get_spatial_fragments", H),
                  ("get_spatial_cropped_fragments", min(H, W // 3 * 2))):
        a = getattr(JF, fn)(v, rng=np.random.default_rng(4), **kw)
        b = getattr(PF, fn)(v, rng=np.random.default_rng(4), **kw)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", [(8, 200, 150, 3), (4, 64, 96, 3),
                                   (1, 9, 7, 3)])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_upsample_fallback_matches_jax_cv2_branch(shape, dtype):
    """Float32 frames, and uint8 frames truncated back to uint8 after the
    float resize as the JAX package does: bit-equal."""
    assert JF.cv2 is not None  # the JAX package's cv2 branch is the reference
    v = _video(shape, seed=5, dtype=dtype)
    kw = dict(fragments_h=7, fragments_w=7, fsize_h=32, fsize_w=32,
              aligned=shape[0] if shape[0] < 8 else 8)
    a = JF.get_spatial_fragments(v, rng=np.random.default_rng(6), **kw)
    b = PF.get_spatial_fragments(v, rng=np.random.default_rng(6), **kw)
    assert a.shape == b.shape == (shape[0], 224, 224, 3)
    assert a.dtype == b.dtype == dtype
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("h,w", [(180, 320), (240, 426), (200, 250),
                                 (100, 100), (90, 400)])
def test_upsample_fallback_equals_jax_at_low_resolution(h, w):
    """KSVQE's 9x9 mosaic of 32 px fragments (288 px) from sources under
    288 px on a side: upsampled by the float32 bilinear, truncated to
    uint8."""
    v = _video((2, h, w, 3), seed=h + w)
    kw = dict(fragments_h=9, fragments_w=9, fsize_h=32, fsize_w=32,
              aligned=2)
    a = JF.get_spatial_fragments(v, rng=np.random.default_rng(6), **kw)
    b = PF.get_spatial_fragments(v, rng=np.random.default_rng(6), **kw)
    assert b.shape == (2, 288, 288, 3) and b.dtype == np.uint8
    np.testing.assert_array_equal(a, b)


def test_s2d_pack_roundtrip_matches_jax():
    v = _video((8, 32, 32, 3), dtype=np.float32)
    np.testing.assert_array_equal(PF.s2d_pack(v), JF.s2d_pack(v))
    np.testing.assert_array_equal(PF.s2d_unpack(PF.s2d_pack(v)), v)


# ---------------------------------------------------------------- resize
AREA_SIZES = [(1280, 720), (720, 1280), (540, 960), (480, 640), (1080, 1920),
              (333, 517), (113, 451), (224, 224), (336, 224), (224, 112),
              (200, 96), (96, 200)]


@pytest.mark.parametrize("h,w", AREA_SIZES)
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_area_resize_matches_cv2(h, w, dtype):
    v = _video((2, h, w, 3), seed=h * w, dtype=dtype)
    want = np.stack([cv2.resize(f, (112, 112), interpolation=cv2.INTER_AREA)
                     for f in v])
    got = resize(v, 112, 112, "area")
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h,w,oh,ow", [(72, 96, 112, 112), (7, 9, 112, 112),
                                       (100, 100, 288, 288),
                                       (60, 100, 224, 301),
                                       (1, 9, 5, 30)])  # cv2 skips IPP
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_linear_resize_matches_cv2(h, w, oh, ow, dtype):
    v = _video((2, h, w, 3), seed=h + w, dtype=dtype)
    want = np.stack([cv2.resize(f, (ow, oh), interpolation=cv2.INTER_LINEAR)
                     for f in v])
    got = resize(v, oh, ow, "linear")
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# (H, W) -> (oh, ow): a side grows, so kvq_tpu takes INTER_LINEAR, or
# INTER_AREA whose growing side uses bilinear taps
GROWING = [(90, 400, 224, 224), (400, 90, 224, 224), (200, 400, 224, 224),
           (90, 400, 112, 112), (240, 426, 520, 520), (240, 320, 288, 384),
           (7, 29, 300, 41), (720, 1280, 1080, 1920), (360, 640, 520, 520),
           (400, 200, 224, 224), (112, 451, 224, 224), (113, 451, 112, 112)]


@pytest.mark.parametrize("h,w,oh,ow", GROWING)
def test_resized_view_equals_jax_where_a_side_grows(h, w, oh, ow):
    v = _video((1 if oh * ow > 10 ** 6 else 2, h, w, 3), seed=h * w + oh)
    np.testing.assert_array_equal(PV.get_resized_video(v, oh, ow),
                                  JV.get_resized_video(v, oh, ow))


def test_fused_multiply_add_rounds_once():
    """A float64 sum that lands on a float32 tie, the exact value above it:
    rounded up, where rounding the float64 sum would give the even 1."""
    x = np.float32((2 ** 23 + 2048) / 2 ** 35)
    y = np.float32((2 ** 24 - 4095) / 2 ** 36)
    one = np.ones(1, np.float32)
    assert np.float32(np.float64(x) * y + 1) == 1
    assert _fma(np.array([x]), y, one)[0] == np.nextafter(one, 2)[0]
    assert _fma(np.array([-x]), y, -one)[0] == -np.nextafter(one, 2)[0]


def test_resize_refuses_what_cv2_semantics_do_not_cover():
    with pytest.raises(TypeError):
        resize(np.zeros((4, 4, 3), np.float64), 2, 2)
    with pytest.raises(ValueError):
        resize(np.zeros((4, 4, 3), np.uint8), 2, 2, "cubic")
    one = _video((50, 60, 3))
    np.testing.assert_array_equal(resize(one, 50, 60), one)
    assert resize(one, 25, 30).shape == (25, 30, 3)


# ------------------------------------------------------------- normalise
@pytest.mark.parametrize("profile", ["imagenet_255", "clip",
                                     "imagenet_unit_on_255", "unit",
                                     "slowfast"])
def test_normalize_matches_jax(profile):
    v = _video((3, 17, 19, 3))
    np.testing.assert_array_equal(PV.normalize(v, profile),
                                  JV.normalize(v, profile))
    with pytest.raises(ValueError):
        PV.normalize(v, "nope")


def test_views_match_jax():
    v = _video((8, 130, 170, 3), seed=9)
    for fn, kw in (("get_resized_video", dict(size_h=112, size_w=112)),
                   ("get_resizecrop_video", dict(resize=64, crop=48)),
                   ("get_cropped_video", dict(size_h=64, size_w=64,
                                              aligned=8)),
                   ("get_arp_resized_video", dict(short_edge=64)),
                   ("get_arp_fragment_video", dict(short_fragments=3,
                                                   fsize=16, aligned=8))):
        for phase in ("train", "test"):
            a = getattr(JV, fn)(v, rng=np.random.default_rng(1), phase=phase,
                                **kw)
            b = getattr(PV, fn)(v, rng=np.random.default_rng(1), phase=phase,
                                **kw)
            np.testing.assert_array_equal(a, b, err_msg=f"{fn} {phase}")
    np.testing.assert_array_equal(PV.from_reference_layout(
        PV.to_reference_layout(v)), v)


# ---------------------------------------------------------------- sources
@pytest.mark.parametrize("noise_amp", [None, 0.3])
def test_synthetic_source_and_decode_views_match_jax(noise_amp):
    a = JDec.SyntheticVideoSource(150, 36, 52, seed=7, noise_amp=noise_amp)
    b = PDec.SyntheticVideoSource(150, 36, 52, seed=7, noise_amp=noise_amp)
    idx = np.asarray([0, 3, 149, 3])
    np.testing.assert_array_equal(a.get_frames(idx), b.get_frames(idx))
    sopt = dict(clip_len=8, frame_interval=4, num_clips=3)
    va, ia = JDec.decode_views(
        a, {"technical": JS.make_sampler(sopt, np.random.default_rng(2))})
    vb, ib = PDec.decode_views(
        b, {"technical": PS.make_sampler(sopt, np.random.default_rng(2))})
    np.testing.assert_array_equal(ia["technical"], ib["technical"])
    np.testing.assert_array_equal(va["technical"], vb["technical"])


@pytest.fixture(scope="module")
def mp4(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("vids") / "seek.mp4")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30, (96, 64))
    rng = np.random.default_rng(0)
    for i in range(300):
        f = rng.integers(0, 255, size=(64, 96, 3), dtype=np.uint8)
        f[:16, :16] = (i * 7) % 255
        w.write(f)
    w.release()
    return path


@pytest.mark.parametrize("seek", ["never", "always", "auto"])
def test_opencv_source_matches_jax(mp4, seek):
    reqs = ([5, 100, 180, 290], list(range(150, 182)), [0, 1, 2, 3],
            [10, 10 + PDec._SEEK_MIN_SKIP, 280, 281, 282], [20, 120])
    a = JDec.OpenCVVideoSource(mp4, seek=seek)
    b = PDec.OpenCVVideoSource(mp4, seek=seek)
    assert a.num_frames() == b.num_frames() == 300
    for req in reqs:
        np.testing.assert_array_equal(a.get_frames(np.asarray(req)),
                                      b.get_frames(np.asarray(req)))


def test_opencv_source_seek_past_eof_falls_back_like_jax(mp4):
    out = []
    for mod in (JDec, PDec):
        src = mod.OpenCVVideoSource(mp4, seek="always")
        src._n_raw = 400  # an overcounting header: 300 real frames
        out.append(src.get_frames(np.asarray([10, 380])))
        assert src._n_raw == 300 and src._seek == "never"
    np.testing.assert_array_equal(*out)


def test_opencv_source_pads_short_videos_like_jax(tmp_path):
    path = str(tmp_path / "short.mp4")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30, (48, 32))
    for i in range(40):
        w.write(np.full((32, 48, 3), i * 5, np.uint8))
    w.release()
    a = JDec.open_video(path, pad_short=130)
    b = PDec.open_video(path, pad_short=130)
    assert a.num_frames() == b.num_frames() == 131
    idx = np.arange(0, 131, 7)
    np.testing.assert_array_equal(a.get_frames(idx), b.get_frames(idx))
    with pytest.raises(IOError):
        PDec.OpenCVVideoSource(str(tmp_path / "missing.mp4"))


def test_open_video_keeps_sources_and_never_substitutes(monkeypatch):
    src = PDec.SyntheticVideoSource(10, 8, 8)
    assert PDec.open_video(src) is src
    import builtins

    real_import = builtins.__import__

    def no_cv2(name, *a, **k):
        if name == "cv2":
            raise ImportError("no cv2")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    with pytest.raises(RuntimeError, match="OpenCV"):
        PDec.open_video("some/video.mp4")


# --------------------------------------------------------------- datasets
KVQ_ST = {"technical": dict(fragments_h=5, fragments_w=5, fsize_h=16,
                            fsize_w=16, size_h=112, size_w=112, aligned=8,
                            clip_len=16, frame_interval=2, num_clips=1)}


def _kvq_opt(phase, s2d, n=4, size=(540, 960), num_clips=1):
    st = {"technical": dict(KVQ_ST["technical"], num_clips=num_clips)}
    h, w = size
    opt = JD.make_synthetic_opt(n_videos=n, n_frames=140, height=h, width=w,
                                sample_types=st, phase=phase, seed=3)
    opt["fragment_s2d"] = s2d
    return opt


def _same_item(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if k in ("frame_inds", "num_clips", "clip_len"):
            da, db = (a[k], b[k]) if isinstance(a[k], dict) else (
                {i: x for i, x in enumerate(a[k])},
                {i: x for i, x in enumerate(b[k])})
            assert da.keys() == db.keys()
            for kk in da:
                _same_item(da[kk], db[kk]) if isinstance(da[kk], dict) else (
                    np.testing.assert_array_equal(da[kk], db[kk]))
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("phase,num_clips", [("train", 1), ("test", 3)])
@pytest.mark.parametrize("s2d", [False, True])
def test_kvq_dataset_items_match_jax(phase, num_clips, s2d):
    opt = _kvq_opt(phase, s2d, num_clips=num_clips)
    ja, pa = JD.KVQDataset(opt), PD.KVQDataset(opt)
    assert len(ja) == len(pa) == 4 and (ja.max, ja.min) == (pa.max, pa.min)
    for i, epoch in ((0, 0), (3, 1)):
        a, b = ja.__getitem__(i, epoch=epoch), pa.__getitem__(i, epoch=epoch)
        assert b["fragment"].shape == ((8 * num_clips, 20, 20, 96) if s2d
                                       else (16 * num_clips, 80, 80, 3))
        _same_item(a, b)


@pytest.mark.parametrize("h,w", [(240, 426), (90, 400)])
def test_kvq_dataset_items_match_jax_at_low_resolution(h, w):
    """KSVQE's sample at sources under its 288 px mosaic: the upsample
    fallback, and a 112 px resize view that shrinks or mixes."""
    st = {"technical": dict(fragments_h=9, fragments_w=9, fsize_h=32,
                            fsize_w=32, size_h=112, size_w=112, aligned=8,
                            clip_len=8, frame_interval=2, num_clips=1)}
    opt = JD.make_synthetic_opt(n_videos=2, n_frames=40, height=h, width=w,
                                sample_types=st, phase="test", seed=4)
    ja, pa = JD.KVQDataset(opt), PD.KVQDataset(opt)
    a, b = ja.__getitem__(1, epoch=0), pa.__getitem__(1, epoch=0)
    assert b["fragment"].shape == (8, 288, 288, 3)
    _same_item(a, b)


def test_kvq_dataset_reads_the_annotation_file_like_jax(tmp_path):
    ann = tmp_path / "split.txt"
    ann.write_text("a.mp4,1,2,3.5\nb.mp4,0,1,1.25\n")
    opt = {"anno_file": str(ann), "data_prefix": "vids",
           "sample_types": KVQ_ST, "phase": "test",
           "source_factory": lambda p: PDec.SyntheticVideoSource(
               140, 300, 200, seed=zlib.crc32(p.encode()))}
    ja, pa = JD.KVQDataset(opt), PD.KVQDataset(opt)
    assert ja.video_infos == pa.video_infos
    assert pa.video_infos[0]["filename"].endswith("vids/a.mp4")
    _same_item(ja[1], pa[1])
    assert DATASETS.get("ViewDecompositionDataset_KVQ") is PD.KVQDataset
    assert DATASETS.get("ViewDecompositionDataset") is PD.GenericViewDataset
    assert DATASETS.get("ViewDecompositionDataset_add_forSimpleVQA") is \
        PD.SimpleVQADataset
    with pytest.raises(KeyError, match="available"):
        DATASETS.get("ViewDecompositionDataset_forNoModel")


def test_generic_view_dataset_matches_jax():
    st = {"technical": dict(fragments_h=4, fragments_w=4, fsize_h=16,
                            fsize_w=16, aligned=4, clip_len=8,
                            frame_interval=2, num_clips=2)}
    opt = JD.make_synthetic_opt(n_videos=3, n_frames=60, height=90,
                                width=120, sample_types=st, phase="train")
    ja, pa = JD.GenericViewDataset(opt), PD.GenericViewDataset(opt)
    for i in range(3):
        _same_item(ja.__getitem__(i, epoch=2), pa.__getitem__(i, epoch=2))


def test_learnable_synthetic_opt_matches_jax():
    a = JD.make_learnable_synthetic_opt(n_videos=5, n_frames=40, height=64,
                                        width=80, sample_types=KVQ_ST)
    b = PD.make_learnable_synthetic_opt(n_videos=5, n_frames=40, height=64,
                                        width=80, sample_types=KVQ_ST)
    assert a["anno_file"] == b["anno_file"]
    name = a["anno_file"][2]["filename"]
    idx = np.asarray([0, 5, 39])
    np.testing.assert_array_equal(a["source_factory"](name).get_frames(idx),
                                  b["source_factory"](name).get_frames(idx))
    c = PD.make_synthetic_opt(n_videos=2, n_frames=30, height=20, width=20)
    d = JD.make_synthetic_opt(n_videos=2, n_frames=30, height=20, width=20)
    assert c["anno_file"] == d["anno_file"]
    np.testing.assert_array_equal(
        c["source_factory"]("x.mp4").get_frames(idx[:2]),
        d["source_factory"]("x.mp4").get_frames(idx[:2]))


# ----------------------------------------------------------------- Loader
@pytest.mark.parametrize("shuffle,drop_last,shard", [
    (False, False, (0, 1)), (True, True, (0, 1)), (True, False, (1, 2)),
    (False, True, (0, 3)), (True, False, (2, 3))])
def test_loader_batches_match_jax(shuffle, drop_last, shard):
    st = {"technical": dict(fragments_h=3, fragments_w=3, fsize_h=16,
                            fsize_w=16, size_h=32, size_w=32, aligned=8,
                            clip_len=8, frame_interval=1, num_clips=1)}
    opt = JD.make_synthetic_opt(n_videos=7, n_frames=40, height=96,
                                width=64, sample_types=st, phase="train")
    kw = dict(batch_size=2, shuffle=shuffle, num_workers=3, seed=5,
              drop_last=drop_last, shard=shard)
    ja = JP.Loader(JD.KVQDataset(opt), **kw)
    pa = PP.Loader(PD.KVQDataset(opt), **kw)
    assert len(ja) == len(pa)
    for epoch in (0, 1):
        a, b = list(ja.epoch(epoch)), list(pa.epoch(epoch))
        assert len(a) == len(b) == len(pa)
        for x, y in zip(a, b):
            _same_item(x, y)


def test_loader_raises_worker_errors_and_stops_early():
    class Flaky:
        def __len__(self):
            return 40

        def __getitem__(self, i, epoch=0):
            if i == 7:
                raise ValueError("bad sample 7")
            return {"x": np.full((2, 2), i, np.float32), "label": float(i)}

    loader = PP.Loader(Flaky(), batch_size=2, num_workers=4)
    got = []
    with pytest.raises(ValueError, match="bad sample 7"):
        for b in loader.epoch(0):
            got.append(b["sample_index"].tolist())
    assert got == [[0, 1], [2, 3], [4, 5]]
    it = loader.epoch(0)
    np.testing.assert_array_equal(next(it)["label"], [0.0, 1.0])
    it.close()  # the workers see the stop and exit
    c = PP.collate([{"a": 1, "b": "n"}, {"a": 2, "b": "m"}])
    np.testing.assert_array_equal(c["a"], np.asarray([1, 2], np.int32))
    assert c["b"] == ["n", "m"]


def test_build_loaders_bridges_s2d_and_splits():
    opt = _kvq_opt("train", False, n=5)
    cfg = {"batch_size": 2, "num_workers": 2, "seed": 1, "model": {
        "type": "KSVQE", "args": {"KSVQE": {"backbone": {
            "s2d_input": True}}}},
        "data": {"train": {"type": "ViewDecompositionDataset_KVQ",
                           "args": opt},
                 "val": {"type": "KVQDataset", "args": dict(opt,
                                                            phase="test")}}}
    train, val = PP.build_loaders(cfg)
    assert (train.batch_size, train.shuffle, train.drop_last,
            train.seed, train.num_workers) == (2, True, True, 1, 2)
    assert (val.batch_size, val.shuffle, val.drop_last) == (1, False, False)
    assert len(train) == 2 and len(val) == 5
    assert train.dataset.opt["fragment_s2d"] and val.dataset.opt[
        "fragment_s2d"]
    assert opt["fragment_s2d"] is False  # the config is left as it was
    assert PP.build_loaders({"data": {}, "model": cfg["model"]}) == (None,
                                                                    None)


# ---------------------------------------------------------------- metrics
@pytest.fixture
def scored(tmp_path):
    r = np.random.default_rng(0)
    names = [f"v{i:02d}.mp4" for i in range(12)]
    pred, truth = tmp_path / "pred.csv", tmp_path / "truth.csv"
    pred.write_text("filename,score\n" + "".join(
        f"{n},{r.normal()}\n" for n in names + ["extra.mp4"]))
    truth.write_text("name,mos\n" + "".join(
        f"{n},{r.uniform(1, 5)}\n" for n in reversed(names)))
    pairs = tmp_path / "pairs"
    pairs.mkdir()
    for sheet in ("nonsource", "source"):
        idx = r.permutation(12)
        (pairs / f"{sheet}.csv").write_text("better,worse\n" + "".join(
            f"{names[a]},{names[b]}\n" for a, b in zip(idx[:6], idx[6:]))
            + "missing.mp4,v00.mp4\n")
    return str(pred), str(truth), str(pairs)


def test_score_prediction_file_matches_jax(scored):
    pred, truth, pairs = scored
    for rp in (None, pairs):
        a = JM.score_prediction_file(pred, truth, rp)
        b = PM.score_prediction_file(pred, truth, rp)
        assert a.keys() == b.keys()
        for k in a:
            assert abs(a[k] - b[k]) <= 1e-12, (k, a[k], b[k])
    assert b["score"] == pytest.approx(
        0.45 * b["srcc"] + 0.45 * b["plcc"] + 0.05 * b["acc_nonsource"]
        + 0.05 * b["acc_source"], abs=1e-15)
    assert PM.pairwise_rank_accuracy({"a": 1.0}, [("b", "c")]) == 0.0


def test_rank_pair_xlsx_without_openpyxl_points_to_the_directory_form(
        scored, tmp_path, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_openpyxl(name, *a, **k):
        if name == "openpyxl":
            raise ImportError("no openpyxl")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_openpyxl)
    pred, truth, _ = scored
    with pytest.raises(ImportError, match="nonsource.csv/source.csv"):
        PM.score_prediction_file(pred, truth, str(tmp_path / "pairs.xlsx"))

"""The rest of kvq_tpu's host surface in the port, against kvq_tpu on the
CPU: the seven legacy DOVER/FastVQA datasets (data/legacy_datasets.py),
``decode_views_ms`` (data/decode.py) and ``cli.convert``.

Datasets and decode: items bit-equal to kvq_tpu's (arrays, frame indices,
labels, shapes, names) on seeded synthetic sources and readers and on mp4
and PNG files written with cv2 (kvq_tpu's numpy/cv2 path: its native
decoder is switched off, as tests/test_torch_data.py does), at sizes whose
views shrink or crop (the port's area resize is cv2's bit for bit, its
bilinear upscale within 1 LSB, tests/test_torch_data.py); the registry's
names and its opt-dict construction.

cli.convert: for each kind, a reference-named state dict of seeded weights
(the port keeps the reference's names), wrapped as the reference saves it
(``{"state_dict": ...}`` with DDP's ``module.`` prefix), fragment tables
dropped where a Video-Swin checkpoint has none, through both packages'
``main``; kvq_tpu's msgpack output carried into the port's module through
``from_jax`` and the port's own output load to equal tensors (exact: both
are copies of the same floats, transposed), and an equal forward where the
module has one here.  kvq_tpu's converters assume the full depths; they are
called at the tiny models' (``functools.partial`` on their depth
arguments).
"""

import functools

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import kvq_tpu.data.legacy_datasets as JLD  # noqa: E402
import kvq_tpu.runtime  # noqa: E402
from kvq_tpu.cli import convert as jconvert  # noqa: E402
from kvq_tpu.core import torch_import as TI  # noqa: E402
from kvq_tpu.core.registry import DATASETS as JDATASETS  # noqa: E402
from kvq_tpu.data import decode as JDEC  # noqa: E402
from kvq_tpu.data import samplers as JSAMP  # noqa: E402
from kvq_tpu_torch.cli import convert as pconvert  # noqa: E402
from kvq_tpu_torch.core import from_jax as FJ  # noqa: E402
from kvq_tpu_torch.core.checkpoint import (  # noqa: E402
    load_checkpoint,
    merge_state_dict,
    weights_of,
)
from kvq_tpu_torch.core.registry import DATASETS  # noqa: E402
from kvq_tpu_torch.data import datasets as PD  # noqa: E402
from kvq_tpu_torch.data import decode as PDEC  # noqa: E402
from kvq_tpu_torch.data import legacy_datasets as PLD  # noqa: E402
from kvq_tpu_torch.data import samplers as PSAMP  # noqa: E402
from kvq_tpu_torch.models.vqa_network import (  # noqa: E402
    VQANetwork,
    init_weights,
)
from kvq_tpu_torch.nn import clip_model as CM  # noqa: E402
from kvq_tpu_torch.nn import clip_vit as CV  # noqa: E402
from kvq_tpu_torch.nn import swin as S  # noqa: E402
from kvq_tpu_torch.nn.contrique import CONTRIQUE  # noqa: E402
from kvq_tpu_torch.nn.resnet import FeatureResNet  # noqa: E402
from kvq_tpu_torch.nn.slowfast import SlowFastR50  # noqa: E402

from test_torch_modules import tiny_config  # noqa: E402
from test_torch_simplevqa import svqa_cfg  # noqa: E402

LEGACY = ("FastVQAPlusPlusDataset", "FragmentVideoDataset",
          "ResizedVideoDataset", "CroppedVideoDataset", "FragmentImageDataset",
          "ResizedImageDataset", "CroppedImageDataset")


@pytest.fixture(autouse=True)
def no_native_runtime(monkeypatch):
    monkeypatch.setattr(kvq_tpu.runtime, "available", lambda: False)
    monkeypatch.setattr(PD, "NATIVE", False)


def _same(a, b):
    """Two items: the same keys, arrays bit-equal, the rest equal."""
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


# ------------------------------------------------------- legacy datasets
ANN = [dict(filename=f"v{i}.mp4", label=float(i) + 0.5) for i in range(2)]
IMG_ANN = [dict(filename=f"i{i}.png", label=float(i)) for i in range(2)]
# (class, constructor arguments) at small sizes
VIDEO_CASES = [
    ("FragmentVideoDataset", dict(clip_len=8, num_clips=2, fragments=4,
                                  fsize=16, aligned=8)),
    ("FragmentVideoDataset", dict(clip_len=8, num_clips=1, fragments=3,
                                  fsize=16, nfrags=2, cache_in_memory=True)),
    ("FastVQAPlusPlusDataset", dict(fragments=(4, 4, 4), fsize=(2, 16, 16))),
    ("ResizedVideoDataset", dict(clip_len=8, num_clips=2, size=48)),
    ("CroppedVideoDataset", dict(clip_len=8, num_clips=1, size=64,
                                 ncrops=2)),
]
IMAGE_CASES = [
    ("FragmentImageDataset", dict(fragments=4, fsize=16)),
    ("FragmentImageDataset", dict(fragments=4, fsize=16, nfrags=3)),
    ("ResizedImageDataset", dict(size=40)),
    ("CroppedImageDataset", dict(size=48, ncrops=2)),
]


def _sources(pkg):
    src = pkg.SyntheticVideoSource
    return lambda path: src(120, 90, 160, seed=sum(map(ord, path)))


def _reader(path):
    rng = np.random.default_rng(sum(map(ord, path)))
    return rng.integers(0, 255, size=(90, 160, 3)).astype(np.uint8)


@pytest.mark.parametrize("phase", ["train", "test"])
@pytest.mark.parametrize("name,kw", VIDEO_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(VIDEO_CASES)])
def test_legacy_video_datasets_match_jax(name, kw, phase):
    port = getattr(PLD, name)(ANN, "", phase=phase,
                              source_factory=_sources(PDEC), **kw)
    ref = getattr(JLD, name)(ANN, "", phase=phase,
                             source_factory=_sources(JDEC), **kw)
    assert len(port) == len(ref) == 2
    for i in range(2):
        _same(port[i], ref[i])


@pytest.mark.parametrize("name,kw", IMAGE_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(IMAGE_CASES)])
def test_legacy_image_datasets_match_jax(name, kw):
    port = getattr(PLD, name)(IMG_ANN, "", image_reader=_reader, **kw)
    ref = getattr(JLD, name)(IMG_ANN, "", image_reader=_reader, **kw)
    for i in range(2):
        _same(port[i], ref[i])


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Two mp4s and two PNGs written with cv2, and their annotation file."""
    root = tmp_path_factory.mktemp("legacy")
    rng = np.random.default_rng(7)
    lines = []
    for i in range(2):
        w = cv2.VideoWriter(str(root / f"v{i}.mp4"),
                            cv2.VideoWriter_fourcc(*"mp4v"), 30, (96, 72))
        base = rng.integers(0, 255, size=(72, 96, 3), dtype=np.uint8)
        for t in range(50 + 10 * i):
            w.write(np.roll(base, 2 * t, axis=1))
        w.release()
        cv2.imwrite(str(root / f"i{i}.png"),
                    rng.integers(0, 255, size=(96, 128, 3), dtype=np.uint8))
        lines.append(f"v{i}.mp4,0,0,{1.5 + i}\n")
    (root / "videos.txt").write_text("".join(lines))
    (root / "images.txt").write_text("".join(
        ln.replace(f"v{i}.mp4", f"i{i}.png") for i, ln in enumerate(lines)))
    return root


def test_legacy_datasets_on_files_match_jax(files):
    for name, kw in (VIDEO_CASES[0], VIDEO_CASES[3]):
        port = getattr(PLD, name)(str(files / "videos.txt"), str(files), **kw)
        ref = getattr(JLD, name)(str(files / "videos.txt"), str(files), **kw)
        for i in range(2):
            _same(port[i], ref[i])
    for name, kw in IMAGE_CASES:
        port = getattr(PLD, name)(str(files / "images.txt"), str(files), **kw)
        ref = getattr(JLD, name)(str(files / "images.txt"), str(files), **kw)
        for i in range(2):
            _same(port[i], ref[i])


def test_legacy_registry_names_and_opt_dict():
    for name in LEGACY:
        assert name in DATASETS and name in JDATASETS
    opt = dict(anno_file=ANN, data_prefix="", clip_len=8, num_clips=1,
               fragments=3, fsize=16, weight=0.5, phase="train")
    port = DATASETS.get("FragmentVideoDataset")(
        dict(opt, source_factory=_sources(PDEC)))
    ref = JDATASETS.get("FragmentVideoDataset")(
        dict(opt, source_factory=_sources(JDEC)))
    assert port.phase == "train"
    _same(port[1], ref[1])
    port = DATASETS.get("CroppedImageDataset")(
        {"ann_file": IMG_ANN, "size": 32, "image_reader": _reader})
    ref = JDATASETS.get("CroppedImageDataset")(
        {"ann_file": IMG_ANN, "size": 32, "image_reader": _reader})
    _same(port[0], ref[0])


@pytest.mark.parametrize("train", [False, True])
def test_decode_views_ms_matches_jax(train):
    st = {"technical": dict(fragments_h=4, fragments_w=4, fsize_h=16,
                            fsize_w=16, aligned=8),
          "aesthetic": dict(size_h=48, size_w=48)}
    got = []
    for dec, samp in ((PDEC, PSAMP), (JDEC, JSAMP)):
        rng = np.random.default_rng(3)
        samplers = {k: samp.UnifiedFrameSampler(8, 1, frame_interval=2,
                                                num_clips=1, rng=rng)
                    for k in st}
        got.append(dec.decode_views_ms(dec.SyntheticVideoSource(
            90, 288, 320, seed=2), st, samplers, train, rng=rng))
    (sp, fp), (sj, fj) = got
    assert sp.keys() == sj.keys() == st.keys()
    for k in st:
        assert np.array_equal(fp[k], fj[k])
        assert sp[k]["res"] == sj[k]["res"] == 288
        for s in ("scale1", "scale2"):
            a, b = sp[k][s], sj[k][s]
            assert a.dtype == b.dtype and np.array_equal(a, b), (k, s)
    assert sp["technical"]["scale2"].shape == (8, 256, 256, 3)


# ------------------------------------------------------------ cli.convert
def _seeded(module, seed=0):
    """``module``'s state dict with seeded random values."""
    g = torch.Generator().manual_seed(seed)
    return {k: (torch.rand(v.shape, generator=g) + 0.5 if "running_var" in k
                else torch.randn(v.shape, generator=g))
            if v.is_floating_point() else v
            for k, v in module.state_dict().items()}


TINY_SWIN = dict(embed_dim=16, depths=(1, 1, 1, 1), num_heads=(2, 2, 2, 2))
TINY_2D = dict(embed_dim=16, depths=(2, 2, 1, 1), num_heads=(2, 2, 4, 8))
CLIP_VIT = CM.CLIPConfig(embed_dim=16, vision_width=64, vision_layers=2,
                         vision_patch_size=8, image_resolution=32,
                         context_length=16, vocab_size=100,
                         transformer_width=32, transformer_heads=2,
                         transformer_layers=2)
SLOWFAST_LAYERS = (1, 1, 1, 1)


def _ksvqe():
    return VQANetwork(tiny_config())


def _svqa():
    return VQANetwork(svqa_cfg())


def _swin():
    return S.SwinTransformer3D(S.SwinConfig(**TINY_SWIN))


def _clip_visual():
    return CV.CLIPVisionTower(width=64, layers=2, heads=4, patch_size=8,
                              image_grid=4)


# kind -> (the port's module, how the JAX tree maps into its names, the
# reference state dict from the module's, kvq_tpu's depth arguments)
def _prefixed(prefix, nested):
    """A JAX tree mapped under a VQANetwork-level path, the prefix dropped."""
    def carry(params, stats):
        sd, _ = FJ.map_jax_tree(nested(params), nested(stats or {}))
        return {k[len(prefix):]: v for k, v in sd.items()}
    return carry


KINDS = {
    "ksvqe": (_ksvqe, lambda p, s: FJ.map_jax_tree(p, s)[0],
              {"convert_ksvqe_backbone": dict(
                  depths=(1, 1), contrique_layers=(1, 1, 1, 1))}),
    "simplevqa": (_svqa, lambda p, s: FJ.map_jax_tree(p, s)[0], {}),
    "swin": (_swin, _prefixed("swin_tiny_grpb_backbone.", lambda t: {
        "swin_tiny_grpb_backbone": t}),
        {"convert_swin3d": dict(depths=TINY_SWIN["depths"])}),
    "swin2d": (lambda: S.swin_2d_tiny(**TINY_2D), _prefixed(
        "swin_2d_tiny_backbone.", lambda t: {"swin_2d_tiny_backbone": t}),
        {"convert_swin2d": dict(depths=TINY_2D["depths"])}),
    "contrique": (lambda: CONTRIQUE(layers=(1, 1, 1, 1)), _prefixed(
        "KSVQE_backbone.distortion_tool.", lambda t: {
            "KSVQE_backbone": {"distortion_tool": t}}),
        {"convert_contrique": dict(layers=(1, 1, 1, 1))}),
    "clip": (_clip_visual, _prefixed("KSVQE_backbone.CLIP_tool.", lambda t: {
        "KSVQE_backbone": {"CLIP_tool": t}}), {}),
    "clip_full": (lambda: CM.CLIP(CLIP_VIT),
                  lambda p, s: FJ.map_clip_tree(p, s)[0], {}),
    "resnet50": (lambda: FeatureResNet((1, 1, 1, 1)), _prefixed(
        "simpleVQA_backbone.", lambda t: {"simpleVQA_backbone": t}),
        {"convert_resnet_trunk": dict(layers=(1, 1, 1, 1))}),
    "slowfast": (lambda: SlowFastR50(SLOWFAST_LAYERS),
                 lambda p, s: FJ.map_slowfast_tree(p, s)[0],
                 {"convert_slowfast_r50": dict(layers=SLOWFAST_LAYERS)}),
}


def _reference_file(kind, module, path):
    """The module's seeded state dict as the reference saves it: under
    ``state_dict`` with ``module.``, the fragment tables of a Video-Swin
    trunk dropped, a timm / torchvision / OpenAI file's extra entries."""
    sd = _seeded(module)
    if kind in ("ksvqe", "swin"):
        sd = {k: v for k, v in sd.items()
              if not k.endswith(pconvert.FRAG_TABLE)}
    if kind == "swin2d":  # timm: a 2-D patch kernel, a classifier, buffers
        sd["patch_embed.proj.weight"] = sd["patch_embed.proj.weight"][:, :, 0]
        sd["head.weight"] = torch.zeros(3, 128)
        sd["layers.0.blocks.0.attn.relative_position_index"] = torch.zeros(
            49, 49, dtype=torch.long)
    if kind == "resnet50":
        sd["fc.weight"] = torch.zeros(10, 2048)
    if kind == "clip":  # the whole OpenAI CLIP, of which the tower is kept
        sd = {**_seeded(CM.CLIP(CLIP_VIT), 1),
              **{k: v for k, v in sd.items() if k.startswith("visual.")}}
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()},
                "epoch": 3}, path)
    return sd


@pytest.mark.parametrize("kind", list(KINDS))
def test_convert_matches_jax(kind, tmp_path, monkeypatch):
    build, carry, depths = KINDS[kind]
    for fn, kw in depths.items():
        monkeypatch.setattr(TI, fn, functools.partial(getattr(TI, fn), **kw))
    src = tmp_path / "ref.pth"
    _reference_file(kind, build(), src)
    argv = ["--kind", kind, "--src", str(src), "--clip_layers", "2"]
    jconvert.main(argv + ["--out", str(tmp_path / "jax.ckpt")])
    pconvert.main(argv + ["--out", str(tmp_path / "port.pt")])

    jax_file = load_checkpoint(str(tmp_path / "jax.ckpt"))
    from_jax = carry(jax_file["params"], jax_file.get("batch_stats"))
    a, b = build(), build()
    init_weights(a, 1)
    init_weights(b, 2)
    ra = merge_state_dict(a, from_jax, reference=False)
    rb = merge_state_dict(b, weights_of(load_checkpoint(
        str(tmp_path / "port.pt"))))
    assert ra["mismatched"] == rb["mismatched"] == []
    assert rb["unexpected"] == []
    # what kvq_tpu's file lacks (the counters of BatchNorm, the CLIP
    # tower's adapters, which no reference file holds) is missing alike
    assert set(rb["missing"]) <= set(ra["missing"])
    assert all("num_batches_tracked" in n or "adapter" in n
               for n in ra["missing"]), ra["missing"]
    sa, sb = a.state_dict(), b.state_dict()
    for n in sa:
        if n not in ra["missing"]:
            assert torch.equal(sa[n], sb[n]), n
    if kind in ("swin", "swin2d", "ksvqe"):
        a.eval(), b.eval()
        with torch.no_grad():
            if kind == "ksvqe":
                from test_torch_modules import _batch
                x = {k: torch.from_numpy(v) for k, v in _batch().items()}
                ya = a(x, reduce_scores=True)[0]
                yb = b(x, reduce_scores=True)[0]
            else:
                x = torch.randn(1, 2, 56, 56, 3,
                                generator=torch.Generator().manual_seed(0))
                ya, yb = a(x), b(x)
        assert torch.equal(ya, yb)


def test_convert_refuses_fetch_and_deeper_clip(tmp_path, capsys):
    with pytest.raises(SystemExit):
        pconvert.parse_args(["--kind", "swin", "--fetch", "x", "--out", "o"])
    assert "--src" in capsys.readouterr().err
    src = tmp_path / "clip.pth"
    torch.save(_seeded(CM.CLIP(CLIP_VIT)), src)
    with pytest.raises(ValueError, match="more than 1 visual resblocks"):
        pconvert.convert("clip", str(src), clip_layers=1)

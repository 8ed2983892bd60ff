"""Datasets producing the reference's per-sample dict (copy of
kvq_tpu/data/datasets.py; channels-last numpy arrays instead of torch CHW
tensors).

  - :class:`KVQDataset`       == ViewDecompositionDataset_KVQ
        (fusion_datasets.py:930-1051): 4-column TXT annotations
        ``filename,cls_label,dis_label,score``; emits ``fragment``
        (imagenet_255-normalised mosaic, s2d-packed with ``fragment_s2d``),
        ``resize_video`` (CLIP-normalised resize view), ``dis_label``,
        ``label``, ...
  - :class:`SimpleVQADataset` == ViewDecompositionDataset_add_forSimpleVQA
        (fusion_datasets.py:786-927): CSV with a header ``filename,score``;
        emits the ``simpleVQA`` view (resize, crop, the
        ``imagenet_unit_on_255`` normalisation) and the precomputed
        SlowFast features ``feat`` (cli/slowfast_features.py's files, or
        ``opt["feature_factory"]``).
  - :class:`GenericViewDataset` == ViewDecompositionDataset
        (fusion_datasets.py:664-775): TXT ``filename,_,_,label``.

Reference-name aliases are registered so reference YAML configs resolve
unchanged (``data.train.type: ViewDecompositionDataset_KVQ``).  Each sample
draws from ``default_rng((seed, epoch, index))``; ``opt["source_factory"]``
(path -> video source) replaces the decoder, e.g. with synthetic videos.

KVQDataset makes its two views in the native runtime (runtime/, C++) where
the JAX package does (kvq_tpu/data/datasets.py:41-79): uint8 frames, no
upsample of a video smaller than the mosaic, and a clip length that the
fragments' ``aligned`` divides.  It draws the fragment jitter from the
sample's generator as the numpy branch does, so frame indices and
fragments stay the same.  The numpy branch is the plain version, taken
elsewhere and, with the module attribute ``NATIVE`` false, everywhere.
"""

from __future__ import annotations

import csv
import os.path as osp
import zlib
from typing import Any, Callable

import numpy as np

from ..core.registry import DATASETS
from . import views as V
from .decode import SyntheticVideoSource, decode_views, open_video
from .fragments import fragment_index_maps, get_spatial_fragments, s2d_pack
from .samplers import make_sampler

NATIVE = True  # the native branch where it applies; false: numpy only


def _filter_view_opts(sopt: dict) -> dict:
    """Drop non-view keys before passing a sample_types entry to view fns."""
    drop = {"clip_len", "frame_interval", "num_clips", "t_frag", "phase"}
    return {k: v for k, v in sopt.items() if k not in drop}


def _native_views(raw: np.ndarray, sopt: dict, rng):
    """(fragment, resize_video) of the KVQ sample, float32, from the native
    runtime, or None where the numpy branch makes them (kvq_tpu/data/
    datasets.py:41-79's conditions)."""
    if not NATIVE or raw.dtype != np.uint8:
        return None
    fh, fw = sopt.get("fragments_h", 7), sopt.get("fragments_w", 7)
    sh, sw = sopt.get("fsize_h", 32), sopt.get("fsize_w", 32)
    aligned = 1 if raw.shape[0] == 1 else sopt.get("aligned", 32)
    T, H, W = raw.shape[:3]
    if min(H / (fh * sh), W / (fw * sw)) < 1 or T % aligned != 0:
        return None  # the upsample fallback and its checks stay in numpy
    from .. import runtime

    ymap, xmap = fragment_index_maps(H, W, T, fh, fw, sh, sw, aligned,
                                     rng=rng)
    fragment = runtime.fragment_mosaic_normalize(
        raw, ymap, xmap, aligned, V.IMAGENET_255_MEAN, V.IMAGENET_255_STD)
    resize = runtime.resize_normalize(
        raw, sopt.get("size_h", 224), sopt.get("size_w", 224), V.CLIP_MEAN,
        V.CLIP_STD, div255=True)
    return fragment, resize


class _ViewDatasetBase:
    """Common machinery: annotation list, samplers, per-sample RNG, and the
    item of one normalised view per sample type."""

    # views.normalize's profile of every view (0-255 ImageNet, reference
    # fusion_datasets.py:687-688); whether the view functions are told the
    # phase (SimpleVQA's random or centre crop)
    NORM = "imagenet_255"
    VIEW_PHASE = False

    def __init__(self, opt: dict, namelist=None):
        self.opt = opt
        self.weight = opt.get("weight", 0.5)
        self.ann_file = opt["anno_file"]
        self.data_prefix = opt.get("data_prefix", "")
        self.sample_types: dict[str, dict] = opt["sample_types"]
        self.phase = opt.get("phase", "test")
        self.augment = opt.get("augment", False)
        self.seed = int(opt.get("seed", 42))
        self.namelist = namelist
        # source_factory lets tests inject synthetic videos hermetically.
        self.source_factory: Callable[[str], Any] = opt.get(
            "source_factory", lambda path: open_video(path, pad_short=130)
        )
        self.video_infos: list[dict] = []
        self._read_annotations()
        scores = [vi["label"] for vi in self.video_infos]
        self.max = max(scores) if scores else 0.0
        self.min = min(scores) if scores else 0.0

    # per-sample deterministic generator (the reference draws from global,
    # unseeded state)
    def _rng(self, index: int, epoch: int = 0) -> np.random.Generator:
        return np.random.default_rng((self.seed, epoch, index))

    def _read_annotations(self) -> None:
        raise NotImplementedError

    def _samplers(self, rng: np.random.Generator) -> dict:
        return {k: make_sampler(s, rng=rng) for k, s in self.sample_types.items()}

    def __len__(self) -> int:
        return len(self.video_infos)

    def __getitem__(self, index: int, epoch: int = 0) -> dict:
        info = self.video_infos[index]
        rng = self._rng(index, epoch)
        is_train = self.phase == "train"
        source = self.source_factory(info["filename"])
        videos, frame_inds = decode_views(source, self._samplers(rng), is_train)

        data: dict[str, Any] = {}
        for stype, raw in videos.items():
            sopt = _filter_view_opts(self.sample_types[stype])
            if self.VIEW_PHASE:
                sopt["phase"] = self.phase
            view = V.get_single_view(raw, stype, rng=rng, **sopt)
            data[stype] = V.normalize(view, self.NORM)

        data["num_clips"] = {k: s["num_clips"] for k, s in self.sample_types.items()}
        data["clip_len"] = {k: s["clip_len"] for k, s in self.sample_types.items()}
        data["frame_inds"] = frame_inds
        data["label"] = info["label"]
        # global dataset position: lets sharded/mesh eval identify and
        # dedupe rows without assuming device ordering
        data["sample_index"] = int(index)
        data["video_name"] = info["video_name"]
        data["name"] = info["filename"]
        return data


@DATASETS.register("KVQDataset")
class KVQDataset(_ViewDatasetBase):
    def _read_annotations(self) -> None:
        if isinstance(self.ann_file, list):
            self.video_infos = self.ann_file
            return
        with open(self.ann_file, "r") as fin:
            for line in fin:
                filename, cls_label, dis_label, label = line.strip().split(",")
                self.video_infos.append(
                    dict(
                        filename=osp.join(self.data_prefix, filename),
                        label=float(label),
                        cls_label=int(float(cls_label)),
                        dis_label=int(float(dis_label)),
                        video_name=filename,
                    )
                )

    def __getitem__(self, index: int, epoch: int = 0) -> dict:
        info = self.video_infos[index]
        rng = self._rng(index, epoch)
        is_train = self.phase == "train"
        source = self.source_factory(info["filename"])
        videos, frame_inds = decode_views(source, self._samplers(rng), is_train)

        data: dict[str, Any] = {}
        for stype, raw in videos.items():
            sopt = _filter_view_opts(self.sample_types[stype])
            native = _native_views(raw, sopt, rng)
            if native is not None:
                data["fragment"], data["resize_video"] = native
            else:
                frag = V.get_single_view(raw, stype, rng=rng, **sopt)
                resize = V.get_resized_video(raw, **sopt)
                data["fragment"] = V.normalize(frag, "imagenet_255")
                data["resize_video"] = V.normalize(resize, "clip")
            # ``ori_fragment`` (the un-normalised mosaic of the reference
            # batch, fusion_datasets.py:1028, which nothing reads) only with
            # ``opt["return_ori_fragment"] = True``.
            if self.opt.get("return_ori_fragment", False):
                data["ori_fragment"] = get_spatial_fragments(
                    raw, rng=rng, **sopt
                ).astype(np.float32)
            data["original_shape"] = raw.shape

        data["num_clips"] = {k: s["num_clips"] for k, s in self.sample_types.items()}
        data["clip_len"] = {k: s["clip_len"] for k, s in self.sample_types.items()}
        data["frame_inds"] = frame_inds
        data["dis_label"] = info["dis_label"]
        data["label"] = info["label"]
        # global dataset position: lets sharded/mesh eval identify and
        # dedupe rows without assuming device ordering
        data["sample_index"] = int(index)
        data["name"] = info["filename"]
        data["video_name"] = info["video_name"]
        # opt-in: ship the fragment space-to-depth packed (s2d_pack) for a
        # model built with ``s2d_input: true``, whose patch embed is then
        # one plain matmul
        if self.opt.get("fragment_s2d", False):
            data["fragment"] = s2d_pack(np.ascontiguousarray(data["fragment"]))
        return data


@DATASETS.register("SimpleVQADataset")
class SimpleVQADataset(_ViewDatasetBase):
    VIDEO_LENGTH_READ = 8  # reference fusion_datasets.py:860
    # the reference's quirk, kept: unit-scale ImageNet mean/std on 0-255
    # pixels, no /255 (fusion_datasets.py:811-812,901-903)
    NORM = "imagenet_unit_on_255"
    VIEW_PHASE = True

    def __init__(self, opt: dict, namelist=None):
        self.data_prefix_3d = opt.get("data_prefix_3D", "")
        self.feature_type = opt.get("feature_type", "SlowFast")
        # feature_factory(video_name) -> (clip_len, 2304) array, replaces
        # the feature files (synthetic data, tests)
        self.feature_factory = opt.get("feature_factory", None)
        super().__init__(opt, namelist)

    def _read_annotations(self) -> None:
        if isinstance(self.ann_file, list):
            self.video_infos = self.ann_file
            return
        with open(self.ann_file, newline="") as f:
            reader = csv.reader(f)
            next(reader)  # header row (reference fusion_datasets.py:840)
            for row in reader:
                self.video_infos.append(
                    dict(
                        filename=osp.join(self.data_prefix, row[0]),
                        label=float(row[1]),
                        video_name=row[0],
                    )
                )

    def _load_features(self, video_name: str) -> np.ndarray:
        """(n, dims) float32: one row per feature clip, n the sample type's
        ``clip_len`` (the reference hardcodes 8, its config's clip_len)."""
        n = next(
            (s.get("clip_len", self.VIDEO_LENGTH_READ)
             for s in self.sample_types.values()),
            self.VIDEO_LENGTH_READ,
        )
        if self.feature_factory is not None:
            return np.asarray(self.feature_factory(video_name),
                              dtype=np.float32)
        folder = osp.join(self.data_prefix_3d, video_name)
        dims = {"Slow": 2048, "Fast": 256, "SlowFast": 2304}[self.feature_type]
        feat = np.zeros((n, dims), dtype=np.float32)
        for i in range(n):
            parts = []
            if self.feature_type in ("Slow", "SlowFast"):
                parts.append(np.load(
                    osp.join(folder, f"feature_{i}_slow_feature.npy")
                ).reshape(-1))
            if self.feature_type in ("Fast", "SlowFast"):
                parts.append(np.load(
                    osp.join(folder, f"feature_{i}_fast_feature.npy")
                ).reshape(-1))
            feat[i] = np.concatenate(parts)
        return feat

    def __getitem__(self, index: int, epoch: int = 0) -> dict:
        data = super().__getitem__(index, epoch)
        if "simpleVQA" in data:
            data["feat"] = self._load_features(data["video_name"])
        return data


@DATASETS.register("GenericViewDataset")
class GenericViewDataset(_ViewDatasetBase):
    def _read_annotations(self) -> None:
        if isinstance(self.ann_file, list):
            self.video_infos = self.ann_file
            return
        with open(self.ann_file, "r") as fin:
            for line in fin:
                parts = line.strip().split(",")
                filename, label = parts[0], float(parts[-1])
                self.video_infos.append(
                    dict(
                        filename=osp.join(self.data_prefix, filename),
                        label=label,
                        video_name=filename,
                    )
                )


# Reference-name aliases so unmodified reference YAML configs resolve.
ViewDecompositionDataset_KVQ = KVQDataset
ViewDecompositionDataset_add_forSimpleVQA = SimpleVQADataset
ViewDecompositionDataset = GenericViewDataset
DATASETS.register("ViewDecompositionDataset_KVQ")(KVQDataset)
DATASETS.register("ViewDecompositionDataset_add_forSimpleVQA")(SimpleVQADataset)
DATASETS.register("ViewDecompositionDataset")(GenericViewDataset)

# registers the legacy DOVER/FastVQA classes
from . import legacy_datasets  # noqa: E402,F401


def make_synthetic_opt(
    n_videos: int = 4,
    n_frames: int = 140,
    height: int = 540,
    width: int = 960,
    sample_types: dict | None = None,
    phase: str = "train",
    seed: int = 0,
    with_features: bool = False,
) -> dict:
    """Build a dataset opt backed by synthetic in-memory videos (hermetic);
    ``with_features`` adds SimpleVQADataset's synthetic SlowFast features,
    one seeded row per frame of the sampled clip."""
    ann = [
        dict(
            filename=f"synthetic_{i}.mp4",
            label=float(i) / max(n_videos - 1, 1) * 4 + 1,
            cls_label=i % 3,
            dis_label=i % 4,
            video_name=f"synthetic_{i}.mp4",
        )
        for i in range(n_videos)
    ]
    st = sample_types or {}
    opt = {
        "anno_file": ann,
        "data_prefix": "",
        "phase": phase,
        "seed": seed,
        "sample_types": st,
        # NOTE: zlib.crc32, NOT hash() — python string hashing is salted
        # per process, which would give every process (multi-host tests,
        # test re-runs) different synthetic data for the same name.
        "source_factory": lambda path: SyntheticVideoSource(
            n_frames, height, width, seed=zlib.crc32(path.encode()) % (2**31)
        ),
    }
    if with_features:
        n_feat = next(iter(st.values()), {}).get("clip_len", 8)
        opt["feature_factory"] = lambda name: np.random.default_rng(
            zlib.crc32(name.encode()) % (2**31)
        ).normal(size=(n_feat, 2304)).astype(np.float32)
        opt["data_prefix_3D"] = ""
        opt["feature_type"] = "SlowFast"
    return opt


def make_learnable_synthetic_opt(
    n_videos: int = 16,
    n_frames: int = 140,
    height: int = 540,
    width: int = 960,
    sample_types: dict | None = None,
    phase: str = "train",
    seed: int = 0,
) -> dict:
    """Synthetic dataset whose labels are LEARNABLE, not arbitrary.

    Each video is a smooth pattern + Gaussian noise of per-video amplitude
    ``a`` (SyntheticVideoSource noise mode); the quality label is the
    computable statistic ``5 - 4a`` (clean = 5, noisiest = 1) and
    ``dis_label`` buckets ``a`` into 4 groups so the KSVQE supervised
    contrastive distortion loss is also meaningful.  Different phases draw
    different videos AND different amplitudes from the same distribution,
    so a held-out split tests generalisation of the noise -> score
    mapping.
    """
    rng = np.random.default_rng((seed, zlib.crc32(phase.encode())))
    amps = rng.permutation(np.linspace(0.05, 0.95, n_videos))
    # phase-distinct jitter keeps val amplitudes off the train grid
    amps = np.clip(amps + rng.uniform(-0.02, 0.02, n_videos), 0.0, 1.0)
    names = [f"learnable_{phase}_{i}.mp4" for i in range(n_videos)]
    ann = [
        dict(
            filename=names[i],
            label=float(5.0 - 4.0 * amps[i]),
            cls_label=i % 3,
            dis_label=int(min(amps[i] * 4, 3)),
            video_name=names[i],
        )
        for i in range(n_videos)
    ]
    amp_by_path = {names[i]: float(amps[i]) for i in range(n_videos)}
    st = sample_types or {}
    opt = {
        "anno_file": ann,
        "data_prefix": "",
        "phase": phase,
        "seed": seed,
        "sample_types": st,
        "source_factory": lambda path: SyntheticVideoSource(
            n_frames, height, width,
            seed=zlib.crc32(path.encode()) % (2**31),
            noise_amp=amp_by_path[path],
        ),
    }
    return opt

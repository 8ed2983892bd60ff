"""The legacy DOVER/FastVQA dataset classes (copy of
kvq_tpu/data/legacy_datasets.py: the working equivalents of the reference's
datasets/basic_datasets.py, whose classes cannot run as shipped: its decord
and skvideo imports are commented out), with the same constructor surface
and per-sample dict, channels-last, on the port's samplers, sources,
fragments, views and registry.

  - :class:`FastVQAPlusPlusDataset`   == basic_datasets.py:234-375
        (3-D fragment grid: FragmentSampleFrames temporal sampler +
        spatial mosaic)
  - :class:`FragmentVideoDataset`     == basic_datasets.py:376-501
  - :class:`ResizedVideoDataset`      == basic_datasets.py:502-584
        (the reference never assigns its resize result; resized here)
  - :class:`CroppedVideoDataset`      == basic_datasets.py:585-617
  - :class:`FragmentImageDataset`     == basic_datasets.py:618-717
  - :class:`ResizedImageDataset`      == basic_datasets.py:718-789
        (the reference calls get_spatial_fragments with undefined
        attributes; resized here)
  - :class:`CroppedImageDataset`      == basic_datasets.py:790-812

All emit ImageNet-255-normalised float32 arrays (mean 123.675/116.28/
103.53, std 58.395/57.12/57.375, basic_datasets.py:272-273).  Videos:
``{"video": (V, T, H, W, C), "frame_inds", "gt_label",
"original_shape"}`` where V = nfrags*num_clips; images:
``{"image": (H, W, C) or (nfrags, H, W, C), "gt_label",
"original_shape", "name"}``.  Each class is registered under its name in
``core/registry.py:DATASETS``, taking both the reference's positional
``(ann_file, data_prefix, ...)`` and the config's opt dict.  cv2 is
imported when an image is read, never when this module is.
"""

from __future__ import annotations

import os.path as osp
from typing import Any, Callable

import numpy as np

from ..core.registry import DATASETS
from .decode import open_video
from .fragments import get_spatial_fragments
from .samplers import FragmentSampleFrames, SampleFrames
from .views import get_resized_video, normalize


def _read_4col(ann_file, data_prefix: str) -> list[dict]:
    """TXT lines ``filename,_,_,label`` (basic_datasets.py:276-283)."""
    if isinstance(ann_file, list):
        return ann_file
    infos = []
    with open(ann_file, "r") as fin:
        for line in fin:
            filename, _, _, label = line.strip().split(",")
            infos.append(
                dict(
                    filename=osp.join(data_prefix, filename),
                    label=float(label),
                )
            )
    return infos


def _register_legacy(name: str):
    """Register a legacy class under its reference name, adapted to the
    trainer's opt-dict calling convention (Trainer.build_datasets calls
    ``DATASETS.get(type)(args_dict)``) while keeping the reference's
    positional ``(ann_file, data_prefix, ...)`` constructor surface."""
    import inspect

    def deco(cls):
        def factory(*args, **kw):
            if len(args) == 1 and not kw and isinstance(args[0], dict):
                opt = dict(args[0])
                ann = opt.pop("anno_file", None)
                if ann is None:
                    ann = opt.pop("ann_file")
                prefix = opt.pop("data_prefix", "")
                # named params across the MRO (subclass kwargs flow to the
                # base through **kw, so one signature is not enough)
                accepted: set[str] = set()
                for klass in cls.__mro__:
                    init = klass.__dict__.get("__init__")
                    if init is not None:
                        accepted |= {
                            p.name
                            for p in inspect.signature(init).parameters.values()
                            if p.kind
                            not in (p.VAR_KEYWORD, p.VAR_POSITIONAL)
                        }
                opt = {k: v for k, v in opt.items() if k in accepted}
                return cls(ann, prefix, **opt)
            return cls(*args, **kw)

        factory.__name__ = name
        DATASETS.register(name)(factory)
        return cls

    return deco


class _LegacyVideoBase:
    """Shared machinery: annotations, per-index RNG, decode, memory cache."""

    def __init__(
        self,
        ann_file,
        data_prefix,
        cache_in_memory: bool = False,
        phase: str = "test",
        seed: int = 42,
        source_factory: Callable[[str], Any] | None = None,
    ):
        self.video_infos = _read_4col(ann_file, data_prefix)
        self.phase = phase
        self.seed = seed
        self.source_factory = source_factory or (lambda p: open_video(p))
        self.cache: dict[int, dict] | None = {} if cache_in_memory else None

    def _rng(self, index: int) -> np.random.Generator:
        return np.random.default_rng((self.seed, index))

    def __len__(self) -> int:
        return len(self.video_infos)

    def _decode(self, index: int, sampler) -> tuple[np.ndarray, np.ndarray, float, tuple]:
        from .decode import decode_views

        info = self.video_infos[index]
        source = self.source_factory(info["filename"])
        videos, frame_inds = decode_views(
            source, {"v": sampler}, self.phase == "train"
        )
        video = videos["v"]  # (T, H, W, C)
        return video, frame_inds["v"], info["label"], video.shape[1:]

    def _raw_item(self, index: int) -> dict:
        raise NotImplementedError

    def __getitem__(self, index: int) -> dict:
        if self.cache is not None:
            if index not in self.cache:
                self.cache[index] = self._raw_item(index)
            item = dict(self.cache[index])
        else:
            item = self._raw_item(index)
        item["video"] = normalize(item["video"], "imagenet_255")
        return item


@_register_legacy("FragmentVideoDataset")
class FragmentVideoDataset(_LegacyVideoBase):
    """Fragment-mosaic clips (basic_datasets.py:376-501)."""

    fallback_type: str = "upsample"

    def __init__(
        self,
        ann_file,
        data_prefix,
        clip_len: int = 32,
        frame_interval: int = 2,
        num_clips: int = 4,
        aligned: int = 32,
        fragments: int = 7,
        fsize: int = 32,
        nfrags: int = 1,
        cache_in_memory: bool = False,
        phase: str = "test",
        **kw,
    ):
        super().__init__(ann_file, data_prefix, cache_in_memory, phase, **kw)
        self.clip_len = clip_len
        self.num_clips = num_clips
        self.fragments_hw = (fragments, fragments)
        self.fsize_hw = (fsize, fsize)
        # clamp: per-clip jitter groups can't span more frames than a clip
        self.nfrags, self.aligned = nfrags, min(aligned, clip_len)
        self._sampler_args = (clip_len, frame_interval, num_clips)

    def _sampler(self, rng: np.random.Generator):
        # fresh per-item sampler so train-phase temporal offsets are keyed
        # by (seed, index) like the spatial jitter — reproducible and safe
        # under a multithreaded loader
        return SampleFrames(*self._sampler_args, rng=rng)

    def _view(self, video: np.ndarray, rng) -> np.ndarray:
        return get_spatial_fragments(
            video,
            self.fragments_hw[0],
            self.fragments_hw[1],
            self.fsize_hw[0],
            self.fsize_hw[1],
            aligned=self.aligned,
            fallback_type=self.fallback_type,
            rng=rng,
        )

    def _raw_item(self, index: int) -> dict:
        rng = self._rng(index)
        video, frame_inds, label, shape = self._decode(
            index, self._sampler(rng)
        )
        # nfrags independently-jittered mosaics stack along time
        # (basic_datasets.py:455-477 cats on the T axis) and split into
        # V = nfrags*num_clips clip views.
        frags = np.concatenate(
            [self._view(video, rng) for _ in range(self.nfrags)], axis=0
        )
        t, h, w, c = frags.shape
        v = self.nfrags * self.num_clips
        return dict(
            video=frags.reshape(v, t // v, h, w, c),
            frame_inds=frame_inds,
            gt_label=label,
            original_shape=shape,
        )


@_register_legacy("FastVQAPlusPlusDataset")
class FastVQAPlusPlusDataset(FragmentVideoDataset):
    """3-D fragment grid: temporal fragments via FragmentSampleFrames plus
    the spatial mosaic (basic_datasets.py:234-375)."""

    def __init__(
        self,
        ann_file,
        data_prefix,
        frame_interval: int = 2,
        aligned: int = 32,
        fragments: tuple = (8, 8, 8),
        fsize: tuple = (4, 32, 32),
        num_clips: int = 1,
        nfrags: int = 1,
        cache_in_memory: bool = False,
        phase: str = "test",
        fallback_type: str = "oversample",
        **kw,
    ):
        _LegacyVideoBase.__init__(
            self, ann_file, data_prefix, cache_in_memory, phase, **kw
        )
        self.clip_len = fragments[0] * fsize[0]
        self.num_clips = num_clips
        self.fragments_hw = tuple(fragments[1:])
        self.fsize_hw = tuple(fsize[1:])
        self.nfrags = nfrags
        self.aligned = min(aligned, self.clip_len)
        self.fallback_type = fallback_type
        self._sampler_args = (fsize[0], fragments[0], frame_interval, num_clips)

    def _sampler(self, rng: np.random.Generator):
        return FragmentSampleFrames(*self._sampler_args, rng=rng)


@_register_legacy("ResizedVideoDataset")
class ResizedVideoDataset(_LegacyVideoBase):
    """Bilinear-resized clips (basic_datasets.py:502-584; the reference
    never assigns its resize result — fixed here)."""

    def __init__(
        self,
        ann_file,
        data_prefix,
        clip_len: int = 32,
        frame_interval: int = 2,
        num_clips: int = 4,
        aligned: int = 32,
        size: int = 224,
        cache_in_memory: bool = False,
        phase: str = "test",
        **kw,
    ):
        super().__init__(ann_file, data_prefix, cache_in_memory, phase, **kw)
        self.clip_len, self.num_clips, self.size = clip_len, num_clips, size
        self._sampler_args = (clip_len, frame_interval, num_clips)

    def _raw_item(self, index: int) -> dict:
        sampler = SampleFrames(*self._sampler_args, rng=self._rng(index))
        video, frame_inds, label, shape = self._decode(index, sampler)
        resized = get_resized_video(video, self.size, self.size)
        t, h, w, c = resized.shape
        v = self.num_clips
        return dict(
            video=resized.reshape(v, t // v, h, w, c),
            frame_inds=frame_inds,
            gt_label=label,
            original_shape=shape,
        )


@_register_legacy("CroppedVideoDataset")
class CroppedVideoDataset(FragmentVideoDataset):
    """Crops as a 1x1 fragment grid (basic_datasets.py:585-617; the
    reference hardcodes fsize=224 and ignores ``size`` — honored here)."""

    def __init__(
        self,
        ann_file,
        data_prefix,
        clip_len: int = 32,
        frame_interval: int = 2,
        num_clips: int = 4,
        aligned: int = 32,
        size: int = 224,
        ncrops: int = 1,
        cache_in_memory: bool = False,
        phase: str = "test",
        **kw,
    ):
        super().__init__(
            ann_file,
            data_prefix,
            clip_len=clip_len,
            frame_interval=frame_interval,
            num_clips=num_clips,
            aligned=aligned,
            fragments=1,
            fsize=size,
            nfrags=ncrops,
            cache_in_memory=cache_in_memory,
            phase=phase,
            **kw,
        )


def _read_image(path: str) -> np.ndarray:
    try:
        import cv2

        img = cv2.imread(path)
        if img is None:
            raise FileNotFoundError(path)
        return img[:, :, ::-1]  # BGR -> RGB (basic_datasets.py:664-666)
    except ImportError as e:  # pragma: no cover
        raise RuntimeError("cv2 required for image datasets") from e


class _LegacyImageBase:
    def __init__(
        self,
        ann_file,
        data_prefix,
        cache_in_memory: bool = False,
        phase: str = "test",
        seed: int = 42,
        image_reader: Callable[[str], np.ndarray] | None = None,
    ):
        self.image_infos = _read_4col(ann_file, data_prefix)
        self.phase = phase
        self.seed = seed
        self.image_reader = image_reader or _read_image
        self.cache: dict[int, dict] | None = {} if cache_in_memory else None

    def __len__(self) -> int:
        return len(self.image_infos)

    def _raw_item(self, index: int) -> dict:
        raise NotImplementedError

    def __getitem__(self, index: int) -> dict:
        if self.cache is not None:
            if index not in self.cache:
                self.cache[index] = self._raw_item(index)
            item = dict(self.cache[index])
        else:
            item = self._raw_item(index)
        item["image"] = normalize(item["image"], "imagenet_255")
        return item


@_register_legacy("FragmentImageDataset")
class FragmentImageDataset(_LegacyImageBase):
    """Fragment mosaic over a single image (basic_datasets.py:618-717)."""

    def __init__(
        self,
        ann_file,
        data_prefix,
        fragments: int = 7,
        fsize: int = 32,
        nfrags: int = 1,
        cache_in_memory: bool = False,
        phase: str = "test",
        **kw,
    ):
        super().__init__(ann_file, data_prefix, cache_in_memory, phase, **kw)
        self.fragments, self.fsize, self.nfrags = fragments, fsize, nfrags

    def _view(self, image: np.ndarray, rng) -> np.ndarray:
        frag = get_spatial_fragments(
            image[None],
            self.fragments,
            self.fragments,
            self.fsize,
            self.fsize,
            rng=rng,
        )
        return frag[0]

    def _raw_item(self, index: int) -> dict:
        info = self.image_infos[index]
        rng = np.random.default_rng((self.seed, index))
        img = self.image_reader(info["filename"])
        frags = np.stack([self._view(img, rng) for _ in range(self.nfrags)])
        # nfrags==1 squeezes to (H, W, C) — one image per sample; >1 keeps a
        # leading crop axis ("one image as a batch", basic_datasets.py:697)
        image = frags[0] if self.nfrags == 1 else frags
        return dict(
            image=image,
            gt_label=info["label"],
            original_shape=img.shape[:2],
            name=info["filename"],
        )


@_register_legacy("ResizedImageDataset")
class ResizedImageDataset(_LegacyImageBase):
    """Resized image (basic_datasets.py:718-789; the reference body calls
    get_spatial_fragments with undefined attributes — fixed to resize)."""

    def __init__(
        self,
        ann_file,
        data_prefix,
        size: int = 224,
        cache_in_memory: bool = False,
        phase: str = "test",
        **kw,
    ):
        super().__init__(ann_file, data_prefix, cache_in_memory, phase, **kw)
        self.size = size

    def _raw_item(self, index: int) -> dict:
        info = self.image_infos[index]
        img = self.image_reader(info["filename"])
        resized = get_resized_video(img[None], self.size, self.size)[0]
        return dict(
            image=resized,
            gt_label=info["label"],
            original_shape=img.shape[:2],
            name=info["filename"],
        )


@_register_legacy("CroppedImageDataset")
class CroppedImageDataset(FragmentImageDataset):
    """Crops as a 1x1 fragment grid (basic_datasets.py:790-812)."""

    def __init__(
        self,
        ann_file,
        data_prefix,
        size: int = 224,
        ncrops: int = 1,
        cache_in_memory: bool = False,
        phase: str = "test",
        **kw,
    ):
        super().__init__(
            ann_file,
            data_prefix,
            fragments=1,
            fsize=size,
            nfrags=ncrops,
            cache_in_memory=cache_in_memory,
            phase=phase,
            **kw,
        )

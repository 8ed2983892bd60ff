"""Spatial views and normalisation profiles (copy of kvq_tpu/data/views.py).

Channels-last (T, H, W, C) throughout; the reference works on (C, T, H, W)
tensors, and :func:`to_reference_layout` / :func:`from_reference_layout`
convert.  Views of the reference fusion_datasets.py:
  - ``get_resized_video``      (:244) — plain resize to (size_h, size_w)
  - ``get_resizecrop_video``   (:299) — resize to (resize, resize) then
    random (train) / centre (eval) crop of ``crop``
  - ``get_single_view``        (:350) — dispatch by sample-type prefix
Every resize is :func:`~kvq_tpu_torch.data.resize.resize`: area when a side
shrinks, else bilinear, as the JAX package asks cv2 for.
Normalisation profiles:
  - ``imagenet_255``: mean [123.675,116.28,103.53] std [58.395,57.12,57.375]
    applied to 0-255 pixels (KVQ fragment view, fusion_datasets.py:953-954)
  - ``clip``: x/255 then CLIP mean/std (resize view, :956-957,1022-1024)
  - ``imagenet_unit_on_255``: the SimpleVQA quirk — unit-scale ImageNet
    mean/std applied to *0-255* pixels without dividing by 255
    (fusion_datasets.py:811-812,901-903), kept since the reference
    checkpoints were trained with it.
"""

from __future__ import annotations

import numpy as np

from .resize import resize

IMAGENET_255_MEAN = np.array([123.675, 116.28, 103.53], dtype=np.float32)
IMAGENET_255_STD = np.array([58.395, 57.12, 57.375], dtype=np.float32)
IMAGENET_UNIT_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_UNIT_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)


def normalize(video: np.ndarray, profile: str) -> np.ndarray:
    """Apply a named normalization profile to a (T,H,W,C) 0-255 video.

    Every profile is (v - mean)/std for some constants, computed as one
    in-place scale+shift (v*a + b) in float32, as the JAX package does."""
    if profile == "imagenet_255":
        a, b = 1.0 / IMAGENET_255_STD, -IMAGENET_255_MEAN / IMAGENET_255_STD
    elif profile == "clip":
        a = 1.0 / (255.0 * CLIP_STD)
        b = -CLIP_MEAN / CLIP_STD
    elif profile == "imagenet_unit_on_255":
        a = 1.0 / IMAGENET_UNIT_STD
        b = -IMAGENET_UNIT_MEAN / IMAGENET_UNIT_STD
    elif profile == "unit":
        a, b = 1.0 / 255.0, 0.0
    elif profile == "slowfast":
        # SlowFast_features.py:78: (x/255 - 0.45) / 0.225
        a, b = 1.0 / (255.0 * 0.225), -0.45 / 0.225
    else:
        raise ValueError(f"unknown normalization profile {profile!r}")
    # astype always copies -> fresh buffer, in-place ops are safe; asarray
    # first so list/buffer inputs keep working.
    v = np.asarray(video).astype(np.float32)
    v *= np.asarray(a, np.float32)
    v += np.asarray(b, np.float32)
    return v


def _resize_frames(video: np.ndarray, size_h: int, size_w: int) -> np.ndarray:
    h, w = video.shape[-3:-1]
    # Antialiased downscale (area) / bilinear upscale, the JAX package's
    # choice of cv2 interpolation.
    interp = "area" if (size_h < h or size_w < w) else "linear"
    return resize(video, size_h, size_w, interp)


def get_resized_video(
    video: np.ndarray, size_h: int = 224, size_w: int = 224, **_: object
) -> np.ndarray:
    """(T,H,W,C) -> (T,size_h,size_w,C)."""
    return _resize_frames(np.asarray(video), size_h, size_w)


def get_resizecrop_video(
    video: np.ndarray,
    resize: int = 520,
    crop: int = 448,
    phase: str = "train",
    rng: np.random.Generator | None = None,
    **_: object,
) -> np.ndarray:
    """SimpleVQA view: resize to (resize,resize), then crop ``crop``.

    Train: random crop (reference randrange(res-crop), fusion_datasets.py:310).
    Eval: center crop (:314-315)."""
    v = get_resized_video(video, resize, resize)
    h, w = v.shape[1], v.shape[2]
    if phase == "train":
        rng = rng if rng is not None else np.random.default_rng(0)
        rh = int(rng.integers(0, h - crop))
        rw = int(rng.integers(0, w - crop))
    else:
        rh = h // 2 - crop // 2
        rw = w // 2 - crop // 2
    return v[:, rh : rh + crop, rw : rw + crop]


def get_cropped_video(
    video: np.ndarray,
    size_h: int = 224,
    size_w: int = 224,
    rng: np.random.Generator | None = None,
    **kwargs: object,
) -> np.ndarray:
    """Single jittered crop = a 1x1 fragment grid
    (reference get_cropped_video, fusion_datasets.py:318-323)."""
    from .fragments import get_spatial_fragments

    kwargs = dict(kwargs)
    kwargs.update(fragments_h=1, fragments_w=1, fsize_h=size_h, fsize_w=size_w)
    return get_spatial_fragments(video, rng=rng, **kwargs)  # type: ignore[arg-type]


def get_arp_resized_video(
    video: np.ndarray,
    short_edge: int = 224,
    phase: str = "train",
    rng: np.random.Generator | None = None,
    **_: object,
) -> np.ndarray:
    """Aspect-ratio-preserving resize; train mode first random-crops to a
    square (reference get_arp_resized_video, fusion_datasets.py:257-276)."""
    t, h, w = video.shape[:3]
    short = min(h, w)
    if phase == "train" and (h > short or w > short):
        rng = rng if rng is not None else np.random.default_rng(0)
        if h > short:
            y = int(rng.integers(0, h - short))
            video = video[:, y : y + short]
        elif w > short:
            x = int(rng.integers(0, w - short))
            video = video[:, :, x : x + short]
        h, w = video.shape[1], video.shape[2]
    scale = short_edge / min(h, w)
    return get_resized_video(video, int(round(h * scale)), int(round(w * scale)))


def get_arp_fragment_video(
    video: np.ndarray,
    short_fragments: int = 7,
    fsize: int = 32,
    phase: str = "train",
    rng: np.random.Generator | None = None,
    **kwargs: object,
) -> np.ndarray:
    """ARP fragments: short edge gets ``short_fragments`` cells
    (reference get_arp_fragment_video, fusion_datasets.py:325-347 —
    including its hardcoded 2 on the long edge)."""
    from .fragments import get_spatial_fragments

    t, h, w = video.shape[:3]
    if phase == "train":
        rng = rng if rng is not None else np.random.default_rng(0)
        short = min(h, w)
        if h > short:
            y = int(rng.integers(0, h - short))
            video = video[:, y : y + short]
        elif w > short:
            x = int(rng.integers(0, w - short))
            video = video[:, :, x : x + short]
        h, w = video.shape[1], video.shape[2]
    kwargs = dict(kwargs)
    kwargs.update(fsize_h=fsize, fsize_w=fsize)
    if h > w:
        kwargs.update(fragments_w=short_fragments, fragments_h=2)
    else:
        kwargs.update(fragments_h=short_fragments, fragments_w=2)
    return get_spatial_fragments(video, rng=rng, **kwargs)  # type: ignore[arg-type]


def get_single_view(
    video: np.ndarray,
    sample_type: str = "aesthetic",
    rng: np.random.Generator | None = None,
    **sopt: object,
) -> np.ndarray:
    """Dispatch by sample-type prefix (reference fusion_datasets.py:350-361)."""
    from .fragments import get_spatial_fragments

    if sample_type.startswith("aesthetic"):
        return get_resized_video(video, **sopt)  # type: ignore[arg-type]
    if sample_type.startswith("technical"):
        return get_spatial_fragments(video, rng=rng, **sopt)  # type: ignore[arg-type]
    if sample_type.startswith("simpleVQA"):
        return get_resizecrop_video(video, rng=rng, **sopt)  # type: ignore[arg-type]
    raise NotImplementedError(sample_type)


def to_reference_layout(video: np.ndarray) -> np.ndarray:
    """(T,H,W,C) -> (C,T,H,W), the reference's tensor layout."""
    return np.transpose(video, (3, 0, 1, 2))


def from_reference_layout(video: np.ndarray) -> np.ndarray:
    """(C,T,H,W) -> (T,H,W,C)."""
    return np.transpose(video, (1, 2, 3, 0))

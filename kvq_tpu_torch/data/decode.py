"""Video sources and the unique-frame decode of the sampled views (copy of
kvq_tpu/data/decode.py:27-320).

  - :class:`SyntheticVideoSource`: procedural frames from a per-(video,
    frame) seed, bit-equal to the JAX package's in both modes;
  - :class:`OpenCVVideoSource`: cv2 decode with keyframe seek + grab-scan
    and the reference's short-video padding; cv2 is imported when a file is
    opened, never when this module is;
  - :func:`open_video`: a source as it is, else a file through OpenCV's
    Python binding, which computes the frames the JAX package's native
    decoder (kvq_tpu/runtime/kvq_runtime.cpp:40-230) computes; that decoder
    links OpenCV's C++ videoio and is not ported (the port's runtime/
    makes the views, not the frames);
  - :func:`decode_views`: sample each view's frame indices and decode each
    unique frame once;
  - :func:`decode_views_ms`: the multi-scale views of those frames.
"""

from __future__ import annotations

from typing import Mapping, Protocol

import numpy as np


def _cv2():
    """OpenCV, imported on first use: decoding a video file needs it."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            "decoding a video file needs OpenCV (cv2), which is not "
            "installed; pass the dataset a source_factory that returns "
            "video sources (e.g. SyntheticVideoSource)"
        ) from e
    return cv2


class VideoSource(Protocol):
    def num_frames(self) -> int: ...

    def get_frames(self, indices: np.ndarray) -> np.ndarray:
        """Return (len(indices), H, W, 3) uint8 RGB frames."""
        ...


class SyntheticVideoSource:
    """Deterministic procedural video for hermetic tests.

    Frames are generated from a per-(video, frame) hash so any frame is
    randomly accessible without state.

    Two modes:
      - ``noise_amp=None`` (default): i.i.d. uniform uint8 frames — a
        featureless load generator for pipeline/shape tests.
      - ``noise_amp`` in [0, 1]: a *learnable* video — a smooth sinusoidal
        base pattern corrupted by Gaussian noise of amplitude
        ``noise_amp``.  Noise level is a statistic a VQA model can
        regress from any spatial crop (it survives fragment sampling
        unchanged), so datasets built on this mode have labels that are
        actually learnable.
    """

    def __init__(self, n_frames: int, height: int, width: int, seed: int = 0,
                 noise_amp: float | None = None):
        self._n = n_frames
        self._h = height
        self._w = width
        self._seed = seed
        self._noise_amp = noise_amp
        if noise_amp is not None:
            # per-video smooth-pattern parameters (deterministic in seed)
            prng = np.random.default_rng((seed, 0xBA5E))
            self._fx = prng.uniform(1.0, 3.0, size=3)
            self._fy = prng.uniform(1.0, 3.0, size=3)
            self._ph = prng.uniform(0, 2 * np.pi, size=3)

    def num_frames(self) -> int:
        return self._n

    def _base_frame(self, idx: int) -> np.ndarray:
        """Smooth (H, W, 3) float pattern, drifting slowly over time."""
        y = np.linspace(0, 1, self._h, dtype=np.float32)[:, None, None]
        x = np.linspace(0, 1, self._w, dtype=np.float32)[None, :, None]
        arg = 2 * np.pi * (self._fx * x + self._fy * y) + self._ph
        return 127.5 + 90.0 * np.sin(arg + 0.2 * idx).astype(np.float32)

    def get_frames(self, indices: np.ndarray) -> np.ndarray:
        out = np.empty((len(indices), self._h, self._w, 3), dtype=np.uint8)
        for k, idx in enumerate(np.asarray(indices)):
            rng = np.random.default_rng((self._seed, int(idx)))
            if self._noise_amp is None:
                out[k] = rng.integers(
                    0, 256, size=(self._h, self._w, 3), dtype=np.uint8
                )
            else:
                noise = rng.normal(
                    scale=self._noise_amp * 55.0,
                    size=(self._h, self._w, 3),
                ).astype(np.float32)
                out[k] = np.clip(
                    self._base_frame(int(idx)) + noise, 0, 255
                ).astype(np.uint8)
        return out


# Seek instead of grab-scanning when it skips at least this many frames.
# A seek lands on the previous keyframe and decodes forward, so the win
# must clear a typical GOP (~12-60 frames on short-form UGC) with margin.
_SEEK_MIN_SKIP = 64


class OpenCVVideoSource:
    """cv2-backed decoder with decord-parity access cost.

    The reference decodes only the requested unique frames via decord
    random access (fusion_datasets.py:467-478).  This source combines
    **keyframe seek + grab-scan**: the capture seeks (CAP_PROP_POS_FRAMES)
    whenever the next requested frame is more than ``_SEEK_MIN_SKIP``
    frames ahead — e.g. straight to a clip window that starts deep into a
    long video — then grab-scans through the dense request window
    (``grab()`` = bitstream decode only for unrequested frames, retrieve +
    cache for requested ones), early-stopping at the highest requested
    index.  Seek accuracy is codec-dependent in cv2, so ``'auto'``
    restricts seeking to containers that report a sane metadata frame
    count (the misreporting VFR/stream containers are the ones with
    untrustworthy POS_FRAMES), and a read failure after any seek —
    e.g. an overcounting header sent the seek past true EOF — disables
    seeking for the source and redoes the request as a pure scan
    (``seek='never'`` forces scanning; ``'always'`` forces seeking for
    tests).

    Short videos are pad-repeated with the last frame to >130 frames to
    match reference fusion_datasets.py:413-415 when ``pad_short`` is set.
    """

    def __init__(self, path: str, pad_short: int | None = None,
                 seek: str = "auto"):
        cv2 = _cv2()
        self.path = path
        self.pad_short = pad_short
        cap = cv2.VideoCapture(path)
        if not cap.isOpened():
            raise IOError(f"cannot open video {path}")
        n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        # containers that misreport their frame count (VFR/webm/streams)
        # are exactly the ones whose POS_FRAMES seeks are untrustworthy —
        # 'auto' seek restricts itself to well-behaved containers
        self._meta_count_ok = n > 0
        if n <= 0:
            # Some containers (VFR/webm/streams) report CAP_PROP_FRAME_COUNT
            # as 0; without a real length the early-stop clamp in
            # get_frames would freeze the whole clip on frame 0.  Count by
            # a grab()-only bitstream pass (no colorspace conversion).
            n = 0
            while cap.grab():
                n += 1
        cap.release()
        self._n_raw = max(n, 0)
        self._cap: "cv2.VideoCapture | None" = None
        self._pos = 0  # next frame index the open capture would produce
        self._cache: dict[int, np.ndarray] = {}
        assert seek in ("auto", "never", "always"), seek
        self._seek = seek

    def __del__(self):  # pragma: no cover - destructor best-effort
        if getattr(self, "_cap", None) is not None:
            self._cap.release()

    def num_frames(self) -> int:
        n = self._n_raw
        if self.pad_short is not None and 0 < n <= self.pad_short:
            return self.pad_short + 1
        return n

    def _seek_allowed(self) -> bool:
        if self._seek == "never":
            return False
        if self._seek == "always":
            return True
        return self._meta_count_ok

    def _ensure(self, needed: "set[int]") -> None:
        """Seek + grab/retrieve scan satisfying ``needed`` (sorted),
        early-stopping at max(needed).  Gaps of >= _SEEK_MIN_SKIP frames
        between requests are jumped with a container seek instead of
        grab-scanned (decord random-access parity for sparse patterns and
        for clip windows that start deep into long videos)."""
        missing = sorted(i for i in needed if i not in self._cache)
        if not missing:
            return
        cv2 = _cv2()
        if self._cap is None or missing[0] < self._pos:
            if self._cap is not None:
                self._cap.release()
            self._cap = cv2.VideoCapture(self.path)
            self._pos = 0
        want = set(missing)
        stop = missing[-1]
        nxt = 0  # index of the first not-yet-passed entry of `missing`
        seeked = False
        while self._pos <= stop:
            if self._seek_allowed():
                while nxt < len(missing) and missing[nxt] < self._pos:
                    nxt += 1
                if (nxt < len(missing)
                        and missing[nxt] - self._pos >= _SEEK_MIN_SKIP):
                    self._cap.set(cv2.CAP_PROP_POS_FRAMES, missing[nxt])
                    self._pos = missing[nxt]
                    seeked = True
            if self._pos in want:
                ret, frame = self._cap.read()
                if not ret:
                    break
                self._cache[self._pos] = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            elif not self._cap.grab():
                break
            self._pos += 1
        else:
            return
        if seeked:
            # EOF after a seek: self._pos is the (never reached) seek
            # target, NOT the true container length — the overcounting-
            # container recovery below would corrupt _n_raw and fail to
            # cache the real last frame.  Disable seeking for this source
            # and redo the request as a pure scan, which handles the
            # clamp correctly.
            self._cap.release()
            self._cap = None
            self._pos = 0
            self._seek = "never"
            return self._ensure(needed)
        # EOF before the metadata frame count (overcounted header): the
        # true length is self._pos; make sure the real last frame is cached
        # so out-of-range indices clamp to it like the decode-all path did.
        self._n_raw = self._pos
        last = self._n_raw - 1
        if last >= 0 and last not in self._cache:
            self._cap.release()
            self._cap = cv2.VideoCapture(self.path)
            for _ in range(last):
                if not self._cap.grab():
                    break
            ret, frame = self._cap.read()
            if ret:
                self._cache[last] = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            self._pos = last + 1

    def get_frames(self, indices: np.ndarray) -> np.ndarray:
        idx = np.clip(
            np.asarray(indices, np.int64), 0, max(self._n_raw - 1, 0)
        )
        self._ensure(set(int(i) for i in np.unique(idx)))
        if not self._cache:
            raise IOError(f"no frames decoded from {self.path}")
        # _ensure may have shrunk _n_raw on a truncated container
        hi = max(self._cache)
        return np.stack(
            [self._cache[min(int(i), hi)] for i in idx]
        )


def open_video(path_or_source, pad_short: int | None = None) -> VideoSource:
    """A video source as it is (anything with ``get_frames``), else the
    file at the path through :class:`OpenCVVideoSource`.  A file never
    turns into a synthetic source: without cv2 this raises."""
    if hasattr(path_or_source, "get_frames"):
        return path_or_source
    return OpenCVVideoSource(str(path_or_source), pad_short=pad_short)


def decode_views(
    source: VideoSource,
    samplers: Mapping[str, object],
    is_train: bool = False,
) -> tuple[dict[str, np.ndarray], dict[str, np.ndarray]]:
    """Sample frame indices per view and decode each unique frame once.

    Returns ``(videos, frame_inds)`` with videos channels-last (T,H,W,C)
    uint8.  Mirrors reference spatial_temporal_view_decomposition
    (fusion_datasets.py:449-524) minus the torch/decord machinery.
    """
    n = source.num_frames()
    frame_inds = {k: s(n, is_train) for k, s in samplers.items()}  # type: ignore[operator]
    all_inds = np.unique(np.concatenate(list(frame_inds.values())))
    decoded = source.get_frames(all_inds)
    lookup = {int(i): decoded[k] for k, i in enumerate(all_inds)}
    videos = {
        k: np.stack([lookup[int(i)] for i in inds]) for k, inds in frame_inds.items()
    }
    return videos, frame_inds


def decode_views_ms(
    source: VideoSource,
    sample_types: Mapping[str, dict],
    samplers: Mapping[str, object],
    is_train: bool = False,
    rng: "np.random.Generator | None" = None,
) -> tuple[dict[str, dict], dict[str, np.ndarray]]:
    """Multi-scale view decomposition (reference
    spatial_temporal_view_decomposition_ms, fusion_datasets.py:527-604;
    no shipped config uses it).

    For each sample type returns ``{'scale1': <configured fsize view>,
    'scale2': <64x64-fragment view>, 'res': min(H, W)}``.
    """
    from .views import get_single_view

    videos, frame_inds = decode_views(source, samplers, is_train)
    sampled: dict[str, dict] = {}
    for stype, sopt in sample_types.items():
        video = videos[stype]
        sopt2 = dict(sopt)
        sopt2.update(fsize_h=64, fsize_w=64)
        sampled[stype] = {
            "scale1": get_single_view(video, stype, rng=rng, **sopt),
            "scale2": get_single_view(video, stype, rng=rng, **sopt2),
            "res": int(min(video.shape[1], video.shape[2])),
        }
    return sampled, frame_inds

"""Temporal frame samplers (copy of kvq_tpu/data/samplers.py).

Index math of the reference ``UnifiedFrameSampler``
(datasets/fusion_datasets.py:612-660), with randomness drawn from an
explicit ``numpy.random.Generator``.  Reference quirks kept on purpose:
  - the ``train`` flag is accepted but does not alter sampling (the
    reference never forwards it, fusion_datasets.py:652-660);
  - without ``t_frag``, :func:`make_sampler` passes ``num_clips`` as
    ``fragments_t`` (fusion_datasets.py:1000-1012);
  - indices are taken modulo ``total_frames`` after offsetting.
"""

from __future__ import annotations

import numpy as np


class UnifiedFrameSampler:
    """Split the timeline into ``fragments_t`` grids; sample ``fsize_t``
    frames at ``frame_interval`` strides from a random offset inside each
    grid; concatenate ``num_clips`` independent draws.

    KSVQE config: fsize_t=clip_len=32, fragments_t=1, interval=4,
    num_clips=1 (train) / 3 (eval).  SimpleVQA: fsize_t=1, fragments_t=8.
    """

    def __init__(
        self,
        fsize_t: int,
        fragments_t: int,
        frame_interval: int = 1,
        num_clips: int = 1,
        drop_rate: float = 0.0,
        rng: np.random.Generator | None = None,
    ):
        self.fragments_t = fragments_t
        self.fsize_t = fsize_t
        self.size_t = fragments_t * fsize_t
        self.frame_interval = frame_interval
        self.num_clips = num_clips
        self.drop_rate = drop_rate
        self.rng = rng if rng is not None else np.random.default_rng(0)

    def get_frame_indices(self, num_frames: int, train: bool = False) -> np.ndarray:
        tgrids = np.array(
            [num_frames // self.fragments_t * i for i in range(self.fragments_t)],
            dtype=np.int32,
        )
        tlength = num_frames // self.fragments_t

        if tlength > self.fsize_t * self.frame_interval:
            rnd_t = self.rng.integers(
                0, tlength - self.fsize_t * self.frame_interval, size=len(tgrids)
            )
        else:
            rnd_t = np.zeros(len(tgrids), dtype=np.int32)

        ranges_t = (
            np.arange(self.fsize_t)[None, :] * self.frame_interval
            + rnd_t[:, None]
            + tgrids[:, None]
        )

        if self.drop_rate > 0:
            n_drop = int(self.fragments_t * self.drop_rate)
            drop = set(
                self.rng.choice(self.fragments_t, size=n_drop, replace=False).tolist()
            )
            ranges_t = np.stack(
                [rt for i, rt in enumerate(ranges_t) if i not in drop]
            )
        return ranges_t.reshape(-1)

    def __call__(
        self, total_frames: int, train: bool = False, start_index: int = 0
    ) -> np.ndarray:
        frame_inds = np.concatenate(
            [self.get_frame_indices(total_frames, train) for _ in range(self.num_clips)]
        )
        return np.mod(frame_inds + start_index, total_frames).astype(np.int32)


def make_sampler(
    sopt: dict, rng: np.random.Generator | None = None
) -> UnifiedFrameSampler:
    """Build a sampler from a sample_types entry, matching the reference's
    t_frag dispatch (fusion_datasets.py:1000-1012): with ``t_frag`` the clip
    is split into t_frag grids of clip_len//t_frag frames each."""
    if "t_frag" not in sopt:
        return UnifiedFrameSampler(
            sopt["clip_len"], sopt["num_clips"], sopt["frame_interval"], rng=rng
        )
    return UnifiedFrameSampler(
        sopt["clip_len"] // sopt["t_frag"],
        sopt["t_frag"],
        sopt["frame_interval"],
        sopt["num_clips"],
        rng=rng,
    )


class FragmentSampleFrames(UnifiedFrameSampler):
    """Legacy FastVQA sampler (reference basic_datasets.py:110-147).

    Same index math as :class:`UnifiedFrameSampler` with drop_rate=0; kept
    as a named class so legacy configs referencing it keep working.
    """

    def __init__(self, fsize_t, fragments_t, frame_interval=1, num_clips=1,
                 rng=None):
        super().__init__(fsize_t, fragments_t, frame_interval, num_clips,
                         drop_rate=0.0, rng=rng)


class SampleFrames:
    """mmaction-style dense clip sampler (reference basic_datasets.py:150-231).

    Train: clips start at random offsets within each average interval;
    test: clips are centered (offset + avg_interval/2).  Unlike
    UnifiedFrameSampler this one *does* honor the ``train`` flag.
    """

    def __init__(self, clip_len: int, frame_interval: int = 1,
                 num_clips: int = 1,
                 rng: np.random.Generator | None = None):
        self.clip_len = clip_len
        self.frame_interval = frame_interval
        self.num_clips = num_clips
        self.rng = rng if rng is not None else np.random.default_rng(0)

    def _train_offsets(self, num_frames: int) -> np.ndarray:
        ori_clip_len = self.clip_len * self.frame_interval
        avg_interval = (num_frames - ori_clip_len + 1) // self.num_clips
        if avg_interval > 0:
            base = np.arange(self.num_clips) * avg_interval
            return base + self.rng.integers(avg_interval, size=self.num_clips)
        if num_frames > max(self.num_clips, ori_clip_len):
            return np.sort(
                self.rng.integers(
                    num_frames - ori_clip_len + 1, size=self.num_clips
                )
            )
        if avg_interval == 0:
            ratio = (num_frames - ori_clip_len + 1.0) / self.num_clips
            return np.around(np.arange(self.num_clips) * ratio)
        return np.zeros((self.num_clips,), dtype=np.int64)

    def _test_offsets(self, num_frames: int) -> np.ndarray:
        ori_clip_len = self.clip_len * self.frame_interval
        avg_interval = (num_frames - ori_clip_len + 1) / float(self.num_clips)
        if num_frames > ori_clip_len - 1:
            base = np.arange(self.num_clips) * avg_interval
            return (base + avg_interval / 2.0).astype(np.int32)
        return np.zeros((self.num_clips,), dtype=np.int32)

    def __call__(self, total_frames: int, train: bool = False,
                 start_index: int = 0) -> np.ndarray:
        offsets = (
            self._train_offsets(total_frames)
            if train
            else self._test_offsets(total_frames)
        )
        inds = (
            offsets[:, None]
            + np.arange(self.clip_len)[None, :] * self.frame_interval
        )
        inds = np.mod(inds.reshape(-1, self.clip_len), total_frames)
        return (inds.reshape(-1) + start_index).astype(np.int32)

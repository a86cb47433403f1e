"""Fixed-length temporal sampling of raw clip features.

Counterpart of ``video_moment_localization_tpu/data/sampler.py``
(reference dataset.py:40-74):

* stride = nfeats/T when the video is longer than T clips, else 1.0;
* training adds a random integer start offset ``spos`` drawn uniformly from
  [0, stride - 0.5] (with the reference's "integral endpoint shrinks by 1"
  quirk, dataset.py:46-49); evaluation and serving use offset 0, the
  default;
* frame indices are ``round(arange(spos, nfeats - 0.5, stride))`` with
  numpy's round-half-to-even, truncated to T on the rare over-long case;
* the normalized ground-truth span is mapped to sampled-frame indices by a
  linear scan over consecutive frame-index pairs (dataset.py:60-65);
* shorter videos are zero-padded up to T.

The index math runs in the native library (``data/native.py``) when it is
built, else in numpy; both give the same indices. Training jitter is drawn
from an explicit ``np.random.Generator`` so that it is reproducible and
resumable (the reference used the unseeded global numpy RNG).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from video_moment_localization_tpu_torch.data import native


def jitter_offset(nfeats: int, T: int, rng: Optional[np.random.Generator]) -> int:
    """The training start offset ``spos``: uniform over [0, stride - 0.5],
    the endpoint shrunk by 1 when it is integral so that the last sampled
    index cannot run past the video."""
    stride = 1.0 if nfeats <= T else nfeats * 1.0 / T
    random_end = -0.5 + stride
    if random_end == np.floor(random_end):
        random_end -= 1.0
    high = int(random_end + 1.0)  # numpy randint truncates float highs
    if rng is None:
        return int(np.random.randint(0, high))
    return int(rng.integers(0, high))


def sample_frame_indices(nfeats: int, T: int, start_pos_n: float = 0.0,
                         end_pos_n: float = 1.0, train: bool = False,
                         rng: Optional[np.random.Generator] = None
                         ) -> Tuple[np.ndarray, int, int, int]:
    """Index half of the sampler: which raw frames to keep.

    Returns (frame_idx, nfeats_clamped, start_index, end_index). Keeping the
    index math apart from the gather lets dataset readers fetch only the
    sampled rows from disk.
    """
    spos = jitter_offset(nfeats, T, rng) if train else 0
    got = native.sample_indices(nfeats, T, spos, float(start_pos_n), float(end_pos_n))
    if got is not None:
        frame_idx, start_index, end_index = got
        return frame_idx, min(nfeats, T), start_index, end_index

    stride = 1.0 if nfeats <= T else nfeats * 1.0 / T
    frame_idx = np.round(np.arange(spos, nfeats - 0.5, stride)).astype(int)
    start_pos = float(nfeats - 1.0) * float(start_pos_n)
    end_pos = float(nfeats - 1.0) * float(end_pos_n)

    expected = nfeats if nfeats < T else T
    if len(frame_idx) != expected:
        frame_idx = frame_idx[:T]  # drop the spilled final index
    if len(frame_idx) != expected:
        raise ValueError(f"sampled {len(frame_idx)} frames, expected {expected} "
                         f"(nfeats={nfeats}, T={T})")

    start_index, end_index = 0, T - 1
    for i in range(len(frame_idx) - 1):
        if frame_idx[i] <= end_pos < frame_idx[i + 1]:
            end_index = i
        if frame_idx[i] <= start_pos < frame_idx[i + 1]:
            start_index = i
    return frame_idx, min(nfeats, T), start_index, end_index


def sample_fixed_length_features(feat: np.ndarray, T: int, start_pos_n: float = 0.0,
                                 end_pos_n: float = 1.0, train: bool = False,
                                 rng: Optional[np.random.Generator] = None
                                 ) -> Tuple[np.ndarray, int, int, int]:
    """Sample raw features (nfeats, dv) to a fixed-length (T, dv) array.

    Returns (features (T, dv) float32, nfeats_clamped, start_index, end_index).
    """
    frame_idx, nfeats_clamped, start_index, end_index = sample_frame_indices(
        feat.shape[0], T, start_pos_n, end_pos_n, train, rng)
    out = np.zeros((T, feat.shape[1]), dtype=np.float32)
    out[:nfeats_clamped, :] = feat[frame_idx, :]
    return out, nfeats_clamped, start_index, end_index

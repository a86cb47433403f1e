"""Fixed-length temporal sampling of raw clip features, evaluation mode.

Counterpart of the numpy path of ``video_moment_localization_tpu/data/
sampler.py`` (reference dataset.py:40-74) at offset 0, the only mode serving
uses: stride = nfeats/T when the video is longer than T clips, else 1.0;
frame indices are ``round(arange(0, nfeats - 0.5, stride))`` with numpy's
round-half-to-even, truncated to T; the normalized span is mapped to
sampled-frame indices by a linear scan; shorter videos are zero-padded to T.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def sample_frame_indices(nfeats: int, T: int, start_pos_n: float = 0.0,
                         end_pos_n: float = 1.0) -> Tuple[np.ndarray, int, int, int]:
    """Returns (frame_idx, nfeats_clamped, start_index, end_index)."""
    stride = 1.0 if nfeats <= T else nfeats * 1.0 / T
    frame_idx = np.round(np.arange(0, nfeats - 0.5, stride)).astype(int)
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
                                 end_pos_n: float = 1.0) -> Tuple[np.ndarray, int, int, int]:
    """Sample raw features (nfeats, dv) to a fixed-length (T, dv) array.

    Returns (features (T, dv) float32, nfeats_clamped, start_index, end_index).
    """
    frame_idx, nfeats_clamped, start_index, end_index = sample_frame_indices(
        feat.shape[0], T, start_pos_n, end_pos_n)
    out = np.zeros((T, feat.shape[1]), dtype=np.float32)
    out[:nfeats_clamped, :] = feat[frame_idx, :]
    return out, nfeats_clamped, start_index, end_index

"""Masks for a sampled video (counterpart of
``video_moment_localization_tpu/data/labels.py::build_masks``; reference
dataset.py:145-149). The training-target generators are ported with the
training slice."""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def build_masks(nfeats: int, T: int, L: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Masks for a video with `nfeats` valid sampled clips (nfeats <= T).

    Returns (video_mask (T, 1), length_mask (L,), moment_mask (L, L)) as
    float32. moment_mask = upper triangle AND outer(length, length).
    """
    video_mask = np.zeros((T, 1), dtype=np.float32)
    video_mask[:nfeats] = 1.0
    length_mask = np.zeros(L, dtype=np.float32)
    length_mask[: math.ceil(nfeats / (T / L))] = 1.0
    moment_mask = np.triu(np.outer(length_mask, length_mask)).astype(np.float32)
    return video_mask, length_mask, moment_mask

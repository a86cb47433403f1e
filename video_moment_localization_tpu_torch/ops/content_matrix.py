"""Static proposal-map geometry: which frames average into which moment clip.

Counterpart of ``video_moment_localization_tpu/ops/content_matrix.py`` (same
arrays, bit for bit). The reference materializes a dense averaging tensor
``Wc (L, L, C, T)`` at model init (reference models.py:88-98, 117); here the
same geometry is three small static integer arrays (clip start, clip size,
reciprocal weight), from which the plain prefix-sum pooling
(ops/proposal.py) and the CUDA pooling kernel (csrc/smin_stack.cu) both derive.

Geometry (matching models.py:88-98 exactly): moment (i, j) covers frames
[i·T/L, (j+1)·T/L); its ``num_frames`` are split into C clips of
``clip_size = max(1, num_frames // C)``; only ``min(C, num_frames)`` clips
exist — trailing clips of very short moments are identically zero; leftover
frames beyond ``C·clip_size`` are unused.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np


@dataclasses.dataclass(frozen=True)
class ContentSegments:
    """Static clip geometry for an (T, L, C) proposal map."""

    T: int
    L: int
    C: int
    starts: np.ndarray   # (L, L, C) int32: first frame of each clip
    sizes: np.ndarray    # (L, L, C) int32: frames per clip (0 = invalid clip)
    weights: np.ndarray  # (L, L, C) float32: 1/size for valid clips else 0


@lru_cache(maxsize=None)
def content_segments(T: int, L: int, C: int) -> ContentSegments:
    if T % L != 0:
        raise ValueError(f"T ({T}) must be a multiple of L ({L})")
    tl = T // L
    starts = np.zeros((L, L, C), dtype=np.int32)
    sizes = np.zeros((L, L, C), dtype=np.int32)
    ii, jj = np.meshgrid(np.arange(L), np.arange(L), indexing="ij")
    num_frames = (jj - ii + 1) * tl                      # (L, L)
    clip_size = np.maximum(1, num_frames // C)           # (L, L)
    valid_clips = np.minimum(C, num_frames)              # (L, L)
    for c in range(C):
        sel = (jj >= ii) & (c < valid_clips)
        starts[..., c] = np.where(sel, ii * tl + c * clip_size, 0)
        sizes[..., c] = np.where(sel, clip_size, 0)
    weights = np.where(sizes > 0, 1.0 / np.maximum(sizes, 1), 0.0).astype(np.float32)
    return ContentSegments(T, L, C, starts, sizes, weights)

"""Plain training targets over the upper triangle of the L x L moment map.

Frozen copies of the label generators of the SMIN reference
(dataset.py:95-127, 145-149): the scaled IoU with the hull union, the
Gaussian boundary curves with sigma = (end - start) / 5, the snippet labels,
and the masks. NumPy, float32.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def snippet_times(L: int, duration: float) -> Tuple[np.ndarray, np.ndarray]:
    s = np.arange(0, L, dtype=np.float32) * duration / L
    e = np.arange(1, L + 1, dtype=np.float32) * duration / L
    return s, e


def iou_map(gt_s: float, gt_e: float, duration: float, L: int) -> np.ndarray:
    s, e = snippet_times(L, duration)
    ps, pe = s[:, None], e[None, :]
    inter = np.maximum(0.0, np.minimum(pe, gt_e) - np.maximum(ps, gt_s))
    union = np.maximum(0.0, np.maximum(pe, gt_e) - np.minimum(ps, gt_s))
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(union > 0, inter / union, 0.0)
    return iou.astype(np.float32)


def boundary_curves(gt_s: float, gt_e: float, duration: float, L: int):
    s, e = snippet_times(L, duration)
    sigma = (gt_e - gt_s) / 5.0
    denom = 2.0 * sigma * sigma
    return (np.exp(-((s - gt_s) ** 2) / denom).astype(np.float32),
            np.exp(-((e - gt_e) ** 2) / denom).astype(np.float32))


def snippet_inside(gt_s: float, gt_e: float, duration: float, L: int) -> np.ndarray:
    s, e = snippet_times(L, duration)
    return ((s >= gt_s) & (e <= gt_e)).astype(np.float32)


def upper(arr: np.ndarray) -> np.ndarray:
    """(L, L) -> its N upper-triangular entries in row-major order."""
    i, j = np.triu_indices(arr.shape[0])
    return np.ascontiguousarray(arr[i, j])


def masks(nfeats: int, T: int, L: int) -> Tuple[np.ndarray, np.ndarray]:
    """(video_mask (T, 1), length_mask (L,))."""
    vm = np.zeros((T, 1), np.float32)
    vm[:nfeats] = 1.0
    lm = np.zeros(L, np.float32)
    lm[: math.ceil(nfeats / (T / L))] = 1.0
    return vm, lm

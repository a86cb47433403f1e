"""Training targets and masks for the L x L temporal proposal map.

Counterpart of ``video_moment_localization_tpu/data/labels.py`` (numpy only,
the same arithmetic in the same order, so the arrays are equal bit for bit):

* `iou_target_map`: scaled-IoU target of every (start snippet i, end snippet
  j) proposal with the reference's *hull* union
  ``max(0, max(ends) - min(starts))`` (reference dataset.py:95-110);
* `boundary_penalties`: unnormalized Gaussian boundary curves with
  ``sigma = (tau_e - tau_s) / 5`` (dataset.py:112-121);
* `snippet_labels`: snippet-inside-GT auxiliary labels (dataset.py:123-127);
* `pack_triu`: an (L, L) map to its N = L(L+1)/2 packed pairs;
* `build_masks`: length and moment masks (dataset.py:145-149).

All labels are float32.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def _snippet_times(L: int, duration: float) -> Tuple[np.ndarray, np.ndarray]:
    """Start times (i * dur / L) and end times ((j+1) * dur / L) per snippet."""
    s_times = np.arange(0, L, dtype=np.float32) * duration / L
    e_times = np.arange(1, L + 1, dtype=np.float32) * duration / L
    return s_times, e_times


def iou_target_map(gt_spos: float, gt_epos: float, duration: float, L: int) -> np.ndarray:
    """(L, L) IoU of each proposal [i*dur/L, (j+1)*dur/L] with the GT span.

    Row i = start snippet, column j = end snippet. Lower-triangle entries
    (negative spans) evaluate to 0 through the clamped intersection.
    """
    s_times, e_times = _snippet_times(L, duration)
    ps = s_times[:, None]  # (L, 1) proposal starts
    pe = e_times[None, :]  # (1, L) proposal ends
    inter = np.maximum(0.0, np.minimum(pe, gt_epos) - np.maximum(ps, gt_spos))
    union = np.maximum(0.0, np.maximum(pe, gt_epos) - np.minimum(ps, gt_spos))
    with np.errstate(divide="ignore", invalid="ignore"):
        ious = np.where(union > 0, inter / union, 0.0)
    return ious.astype(np.float32)


def boundary_penalties(tau_s: float, tau_e: float, duration: float,
                       L: int) -> Tuple[np.ndarray, np.ndarray]:
    """Soft start/end boundary scores s_s, s_e of shape (L,) each."""
    s_times, e_times = _snippet_times(L, duration)
    sigma = (tau_e - tau_s) / 5.0
    denom = 2.0 * sigma * sigma
    s_s = np.exp(-((s_times - tau_s) ** 2) / denom)
    s_e = np.exp(-((e_times - tau_e) ** 2) / denom)
    return s_s.astype(np.float32), s_e.astype(np.float32)


def snippet_labels(tau_s: float, tau_e: float, duration: float, L: int) -> np.ndarray:
    """(L,) binary label: snippet l lies fully inside the GT span."""
    s_times, e_times = _snippet_times(L, duration)
    return np.logical_and(s_times >= tau_s, e_times <= tau_e).astype(np.float32)


def pack_triu(arr: np.ndarray) -> np.ndarray:
    """(L, L) -> (N = L(L+1)/2,) upper-triangular entries in the row-major
    pair order of ops/packing.py (numpy.triu_indices)."""
    L = arr.shape[0]
    i, j = np.triu_indices(L)
    return np.ascontiguousarray(arr[i, j])


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

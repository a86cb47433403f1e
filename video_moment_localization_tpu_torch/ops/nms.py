"""Gaussian soft-NMS over proposals, packed or dense.

Counterpart of ``video_moment_localization_tpu/ops/nms.py::soft_nms_topk``:
after each selection, the remaining scores decay by exp(-IoU^2 / sigma)
against the selected span (hull-union IoU), and the selected proposal is
removed. Scores are the N = L(L+1)/2 packed pairs (the default here, the
port's main path) or the flattened L x L grid (``packed=False``).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch


@lru_cache(maxsize=None)
def _proposal_spans(L: int, packed: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Normalized [start, end) span of each score column: the N packed
    pairs, or the L * L cells of the flattened grid (row i = start)."""
    if packed:
        i, j = np.triu_indices(L)
    else:
        i, j = np.repeat(np.arange(L), L), np.tile(np.arange(L), L)
    i, j = i.astype(np.float32), j.astype(np.float32)
    return i / L, (j + 1.0) / L


def soft_nms_topk(scores: torch.Tensor, L: int, k: int, sigma: float = 0.5,
                  packed: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Select k proposals per row of scores: packed (B, N), or with
    ``packed=False`` dense-flat (B, L * L).

    Returns (values (B, k), indices (B, k)) in selection order, indices into
    the given score columns; of equal scores the lowest index is selected
    first."""
    starts_np, ends_np = _proposal_spans(L, packed)
    starts = torch.from_numpy(starts_np).to(scores.device)
    ends = torch.from_numpy(ends_np).to(scores.device)
    B = scores.shape[0]
    s = scores.clone()
    vals = scores.new_zeros((B, k))
    idxs = torch.zeros((B, k), dtype=torch.int64, device=scores.device)
    for t in range(k):
        top_idx = torch.argmax(s, dim=1)
        vals[:, t] = s.gather(1, top_idx[:, None])[:, 0]
        idxs[:, t] = top_idx
        s0 = starts[top_idx][:, None]
        e0 = ends[top_idx][:, None]
        inter = torch.clamp(torch.minimum(ends, e0) - torch.maximum(starts, s0), min=0.0)
        union = torch.clamp(torch.maximum(ends, e0) - torch.minimum(starts, s0), min=0.0)
        iou = torch.where(union > 0, inter / union, torch.zeros_like(union))
        s = s * torch.exp(-(iou * iou) / sigma)
        s.scatter_(1, top_idx[:, None], float("-inf"))
    return vals, idxs

"""Proposal-map features in plain PyTorch, packed and dense.

Counterpart of ``video_moment_localization_tpu/ops/proposal.py::
proposal_features_packed`` and ``::proposal_features`` (prefix-sum
differences instead of the reference's dense einsum against Wc, reference
models.py:113-125):

* fc (B, N, C, D) packed, or (B, L, L, C, D) dense: clip means
  (P[start+size] - P[start]) / size over the inclusive time cumsum P, weight
  0 for missing clips (every clip of a cell with i > j), masked by the packed
  validity of each pair, or by the given moment_mask;
* fm (B, N, D) or (B, L, L, D): the mean over **all** C clips, zero clips
  included;
* fb (B, L, D): the unmasked non-overlapping window mean (AvgPool1d).
"""

from __future__ import annotations

from typing import Tuple

import torch

from video_moment_localization_tpu_torch.ops.content_matrix import content_segments
from video_moment_localization_tpu_torch.ops.packing import packed_valid_mask, triu_packing


def _clip_means(f: torch.Tensor, starts, sizes, weights) -> torch.Tensor:
    """(B, M, D) clip means of f (B, T, D) for M clips given as numpy
    (start, size, weight) arrays, by prefix-sum differences in fp32."""
    B, _, D = f.shape
    P = torch.cumsum(f.float(), dim=1)
    P = torch.cat([P.new_zeros((B, 1, D)), P], dim=1)                 # (B, T+1, D)
    idx_s = torch.from_numpy(starts.reshape(-1).astype("int64")).to(f.device)
    idx_e = torch.from_numpy((starts + sizes).reshape(-1).astype("int64")).to(f.device)
    w = torch.from_numpy(weights.reshape(1, -1, 1)).to(f.device)
    return ((P[:, idx_e] - P[:, idx_s]) * w).to(f.dtype)


def proposal_features_packed(f: torch.Tensor, length_mask: torch.Tensor, L: int,
                             C: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, T, D = f.shape
    seg = content_segments(T, L, C)
    p = triu_packing(L)
    ij = (p.i_idx, p.j_idx)
    fc = _clip_means(f, seg.starts[ij], seg.sizes[ij], seg.weights[ij]).reshape(B, p.N, C, D)
    fc = fc * packed_valid_mask(length_mask).to(f.dtype)[..., None, None]

    fm = fc.mean(dim=2)
    fb = f.reshape(B, L, T // L, D).mean(dim=2)
    return fc, fm, fb


def proposal_features(f: torch.Tensor, moment_mask: torch.Tensor, L: int,
                      C: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense (fc (B, L, L, C, D), fm (B, L, L, D), fb (B, L, D)) of f
    (B, T, D), fc masked by ``moment_mask`` (B, L, L)."""
    B, T, D = f.shape
    seg = content_segments(T, L, C)
    fc = _clip_means(f, seg.starts, seg.sizes, seg.weights).reshape(B, L, L, C, D)
    fc = fc * moment_mask.to(f.dtype)[..., None, None]

    fm = fc.mean(dim=3)
    fb = f.reshape(B, L, T // L, D).mean(dim=2)
    return fc, fm, fb

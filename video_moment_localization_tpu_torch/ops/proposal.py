"""Packed proposal-map features in plain PyTorch.

Counterpart of ``video_moment_localization_tpu/ops/proposal.py::
proposal_features_packed`` (prefix-sum differences instead of the
reference's dense einsum against Wc, reference models.py:113-125):

* fc (B, N, C, D): clip means (P[start+size] - P[start]) / size over the
  inclusive time cumsum P, weight 0 for missing clips, masked by the packed
  validity of each pair;
* fm (B, N, D): the mean over **all** C clips, zero clips included;
* fb (B, L, D): the unmasked non-overlapping window mean (AvgPool1d).
"""

from __future__ import annotations

from typing import Tuple

import torch

from video_moment_localization_tpu_torch.ops.content_matrix import content_segments
from video_moment_localization_tpu_torch.ops.packing import packed_valid_mask, triu_packing


def proposal_features_packed(f: torch.Tensor, length_mask: torch.Tensor, L: int,
                             C: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, T, D = f.shape
    seg = content_segments(T, L, C)
    p = triu_packing(L)
    starts = seg.starts[p.i_idx, p.j_idx].reshape(-1)                 # (N*C,)
    ends = starts + seg.sizes[p.i_idx, p.j_idx].reshape(-1)
    w = torch.from_numpy(seg.weights[p.i_idx, p.j_idx].reshape(1, -1, 1)).to(f.device)

    P = torch.cumsum(f.float(), dim=1)
    P = torch.cat([P.new_zeros((B, 1, D)), P], dim=1)                 # (B, T+1, D)
    idx_s = torch.from_numpy(starts.astype("int64")).to(f.device)
    idx_e = torch.from_numpy(ends.astype("int64")).to(f.device)
    fc = ((P[:, idx_e] - P[:, idx_s]) * w).reshape(B, p.N, C, D).to(f.dtype)
    fc = fc * packed_valid_mask(length_mask).to(f.dtype)[..., None, None]

    fm = fc.mean(dim=2)
    fb = f.reshape(B, L, T // L, D).mean(dim=2)
    return fc, fm, fb

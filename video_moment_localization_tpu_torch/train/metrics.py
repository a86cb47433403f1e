"""Final proposal scores and metric names of the serving path.

Counterpart of the packed scoring in ``video_moment_localization_tpu/
train/metrics.py`` (reference utils.py:10-31): the final score of pair
(i, j) is ``pm * sqrt(ps[i]) * sqrt(pe[j])``, masked to valid pairs. The
recall counts are ported with the training slice.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from video_moment_localization_tpu_torch.ops.packing import packed_valid_mask, pair_index

METRIC_NS: Tuple[int, ...] = (1, 5)
METRIC_MS: Tuple[float, ...] = (0.1, 0.3, 0.5, 0.7)


def metric_names(n: Sequence[int] = METRIC_NS, m: Sequence[float] = METRIC_MS):
    """Exact reference metric-name strings (utils.py:29)."""
    return [f"R@{n_}, IoU={m_}" for n_ in n for m_ in m]


def proposal_scores_packed(pm: torch.Tensor, ps: torch.Tensor, pe: torch.Tensor,
                           length_mask: torch.Tensor, L: int) -> torch.Tensor:
    """(B, N) packed final moment scores."""
    i_idx, j_idx = pair_index(L, pm.device)
    s_i = torch.sqrt(ps)[:, i_idx]
    e_j = torch.sqrt(pe)[:, j_idx]
    return pm * s_i * e_j * packed_valid_mask(length_mask.float())

"""Final proposal scores and R@n, IoU=m recall counts, packed and dense.

Counterpart of ``video_moment_localization_tpu/train/metrics.py``
(reference utils.py:10-31): the final score of moment (i, j) is
``pm * sqrt(ps[i]) * sqrt(pe[j])``, masked to valid moments; the top-k =
max(n) scores (or k soft-NMS selections) gather the ground-truth IoU at
their indices, and R@n,IoU=m counts the samples where any of the top-n
gathered IoUs exceeds m. Counts are un-normalized; a padded batch's
``sample_mask`` weights them. The packed layout ranks the N valid pairs; the
dense one (``packed: False`` and ``compat_head``) ranks all L * L cells, as
the reference does, with its tie behaviour: equal scores go to the lower
flat index (PARITY.md #16), so a sample with fewer than k positive scores
selects masked zero-score cells, whose dense ``sm`` entries are real IoUs.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from video_moment_localization_tpu_torch.ops.nms import soft_nms_topk
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


def proposal_scores(pm: torch.Tensor, ps: torch.Tensor, pe: torch.Tensor,
                    moment_mask: torch.Tensor) -> torch.Tensor:
    """(B, L, L) final moment scores over the dense map (reference
    utils.py:17-19)."""
    score = pm * torch.sqrt(ps)[:, :, None] * torch.sqrt(pe)[:, None, :]
    return score * moment_mask


def topk_lowest_index_first(score: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, ties to the lower index (as jax.lax.top_k):
    a stable descending sort keeps equal scores in index order."""
    vals, idxs = torch.sort(score, dim=-1, descending=True, stable=True)
    return vals[..., :k], idxs[..., :k]


def _counts_from_topk(score, sm_flat, sample_mask, n, m, L, use_nms, nms_sigma, packed):
    """Top-k -> gather GT IoU -> threshold counts, shape (len(n), len(m))."""
    k = max(n)
    if use_nms:
        _, top_idx = soft_nms_topk(score, L, k, nms_sigma, packed=packed)
    else:
        _, top_idx = topk_lowest_index_first(score, k)
    top_ious = sm_flat.gather(1, top_idx)                               # (B, k)
    if sample_mask is None:
        sample_mask = score.new_ones(score.shape[0])
    counts = [torch.stack([((top_ious[:, :n_] > m_).any(dim=1).float() * sample_mask).sum()
                           for m_ in m]) for n_ in n]
    return torch.stack(counts)


def recall_counts_packed(pm: torch.Tensor, ps: torch.Tensor, pe: torch.Tensor,
                         length_mask: torch.Tensor, sm: torch.Tensor,
                         sample_mask: Optional[torch.Tensor] = None,
                         n: Sequence[int] = METRIC_NS, m: Sequence[float] = METRIC_MS,
                         use_nms: bool = False, nms_sigma: float = 0.5) -> torch.Tensor:
    """Un-normalized hit counts (len(n), len(m)) over the packed layout:
    pm/sm are (B, N); the top-k runs over the N pairs only, so ties select
    among packed slots (the JAX package's deliberate deviation from the
    reference's dense top-k, PARITY.md #16)."""
    L = ps.shape[1]
    score = proposal_scores_packed(pm, ps, pe, length_mask, L)
    return _counts_from_topk(score, sm, sample_mask, n, m, L, use_nms, nms_sigma, True)


def recall_counts(pm: torch.Tensor, ps: torch.Tensor, pe: torch.Tensor,
                  moment_mask: torch.Tensor, sm: torch.Tensor,
                  sample_mask: Optional[torch.Tensor] = None,
                  n: Sequence[int] = METRIC_NS, m: Sequence[float] = METRIC_MS,
                  use_nms: bool = False, nms_sigma: float = 0.5) -> torch.Tensor:
    """Un-normalized hit counts (len(n), len(m)) over the dense layout: pm,
    sm and moment_mask are (B, L, L); the top-k runs over all L * L cells,
    ties to the lower flat index, reproducing the reference's tie behaviour
    bit for bit (PARITY.md #16)."""
    B, L = pm.shape[:2]
    score = proposal_scores(pm, ps, pe, moment_mask).reshape(B, -1)
    return _counts_from_topk(score, sm.reshape(B, -1), sample_mask, n, m, L, use_nms,
                             nms_sigma, False)


def counts_to_dict(counts, n=METRIC_NS, m=METRIC_MS) -> Dict[str, float]:
    out = {}
    for i, n_ in enumerate(n):
        for j, m_ in enumerate(m):
            out[f"R@{n_}, IoU={m_}"] = float(counts[i, j])
    return out

"""Scaled-IoU BCE losses in PyTorch.

Counterpart of ``video_moment_localization_tpu/train/loss.py`` (the intended
semantics of reference main.py:89-116): per element, with score weight s and
binary label y,

    loss = -[ s*y*log(p) + (1-s)*(1-y)*log(1-p) ]

and plain BCE without s. Per sample: masked mean over valid positions; per
batch: mean over the valid samples of a batch padded to a fixed size.

Total (reference main.py:110-116): L = L_m + L_s + L_e + 0.5 * L_a.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from video_moment_localization_tpu_torch.ops.packing import packed_valid_mask

_EPS = 1e-7  # probability clamp; keeps masked-out p == 0 entries finite


def scaled_bce(p: torch.Tensor, y: torch.Tensor, s: Optional[torch.Tensor],
               mask: torch.Tensor) -> torch.Tensor:
    """Per-sample masked scaled BCE: p, y, mask (B, ...), s the same or None
    -> (B,) losses, 0 for an all-masked row."""
    p = p.float().clamp(_EPS, 1.0 - _EPS)
    y = y.float()
    log_p, log_1p = torch.log(p), torch.log1p(-p)
    if s is None:
        per = -(y * log_p + (1.0 - y) * log_1p)
    else:
        s = s.float()
        per = -(s * y * log_p + (1.0 - s) * (1.0 - y) * log_1p)
    per = per * mask
    axes = tuple(range(1, per.dim()))
    denom = mask.sum(dim=axes)
    return torch.where(denom > 0, per.sum(dim=axes) / denom.clamp(min=1.0),
                       torch.zeros_like(denom))


def smin_loss(outputs: Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor],
              batch: Dict[str, torch.Tensor], denominator: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total SMIN loss, averaged over valid samples. Packed outputs (pm
    (B, N)) take the pair-validity mask from ``length_mask``; dense ones (pm
    (B, L, L): ``packed: False`` or ``compat_head``) take
    ``batch["moment_mask"]``. Returns (loss, {"per_sample": (B,),
    "num_valid": (), "loss_sum": ()}): the batch's valid samples and the sum
    of their losses. ``denominator``: what the sum is divided by in place of
    the batch's own valid count; a data-parallel rank passes the global
    batch's, so that the loss is its share of the global batch's mean."""
    pm, ps, pe, pa = outputs
    length_mask = batch["length_mask"].float()
    if pm.dim() == 2:
        mask_m = packed_valid_mask(length_mask)
    else:
        mask_m = batch["moment_mask"].float()
    per_sample = (
        scaled_bce(pm, batch["ym"], batch["sm"], mask_m)
        + scaled_bce(ps, batch["ys"], batch["ss"], length_mask)
        + scaled_bce(pe, batch["ye"], batch["se"], length_mask)
        + 0.5 * scaled_bce(pa, batch["ya"], None, length_mask)
    )
    sample_mask = batch.get("sample_mask")
    if sample_mask is None:
        sample_mask = torch.ones_like(per_sample)
    num_valid = sample_mask.sum()
    loss_sum = (per_sample * sample_mask).sum()
    denominator = num_valid if denominator is None else denominator
    loss = loss_sum / denominator.clamp(min=1.0)
    return loss, {"per_sample": per_sample, "num_valid": num_valid, "loss_sum": loss_sum}

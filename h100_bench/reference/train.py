"""Plain SMIN training: the scaled-IoU loss, its gradient and Adam.

The loss is the reference's (main.py:89-116): per element, with score s and
binary label y, -[s y log p + (1 - s)(1 - y) log(1 - p)] (plain BCE for the
snippet head), a masked mean per sample, L_m + L_s + L_e + 0.5 L_a, then
the mean over the batch's valid samples. The gradient is taken by autograd
on `smin.forward`, a block of samples at a time (the loss is a sum over
samples, so the blocks' gradients add up to the batch's); the update is Adam (betas 0.9 / 0.999, eps 1e-8, no weight
decay) written out here, in the order of operations of ``torch.optim.Adam``.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from h100_bench.reference import smin

EPS = 1e-7


def scaled_bce(p, y, s, mask):
    """(B,) masked mean of the scaled BCE (plain BCE where s is None)."""
    p = p.clamp(EPS, 1.0 - EPS)
    if s is None:
        per = -(y * torch.log(p) + (1.0 - y) * torch.log1p(-p))
    else:
        per = -(s * y * torch.log(p) + (1.0 - s) * (1.0 - y) * torch.log1p(-p))
    per = per * mask
    denom = mask.sum(1)
    return torch.where(denom > 0, per.sum(1) / denom.clamp(min=1.0), torch.zeros_like(denom))


def per_sample_loss(outputs, batch, L):
    pm, ps, pe, pa = outputs
    lm = batch["length_mask"]
    i_idx, j_idx = (torch.from_numpy(a).to(lm.device) for a in smin.pairs(L))
    vmask = lm[:, i_idx] * lm[:, j_idx]
    return (scaled_bce(pm, batch["ym"], batch["sm"], vmask)
            + scaled_bce(ps, batch["ys"], batch["ss"], lm)
            + scaled_bce(pe, batch["ye"], batch["se"], lm)
            + 0.5 * scaled_bce(pa, batch["ya"], None, lm))


FORWARD_KEYS = ("video_features", "video_mask", "query_features", "query_mask", "length_mask")


def loss_and_grad(W: Dict[str, torch.Tensor], cfg, batch: Dict[str, torch.Tensor],
                  block: int, half_batch: bool = False) -> float:
    """The batch's mean loss; W's leaves get its gradient in ``.grad``.
    ``half_batch``: the fault that leaves out the second half of the batch
    and takes the mean over the rest."""
    mask = batch["sample_mask"].clone()
    if half_batch:
        mask[mask.shape[0] // 2:] = 0.0
    n_valid = mask.sum().clamp(min=1.0)
    total = 0.0
    for s in range(0, mask.shape[0], block):
        part = {k: v[s:s + block] for k, v in batch.items()}
        outputs = smin.forward(W, cfg, *(part[k] for k in FORWARD_KEYS))
        loss = (per_sample_loss(outputs, part, cfg["L"]) * mask[s:s + block]).sum() / n_valid
        loss.backward()
        total += float(loss.detach())
    return total


def adam_update(p, g, m, v, t: int, lr: float, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8) -> None:
    """One Adam step of parameter p in place, from gradient g and moments m, v."""
    m.mul_(b1).add_(g, alpha=1 - b1)
    v.mul_(b2).addcmul_(g, g, value=1 - b2)
    denom = (v.sqrt() / math.sqrt(1 - b2 ** t)).add_(eps)
    p.addcdiv_(m, denom, value=-lr / (1 - b1 ** t))


def run_steps(W0: Dict[str, torch.Tensor], cfg, batches: List[Dict[str, torch.Tensor]], lr: float,
              block: int, half_batch: bool = False):
    """Train a copy of W0 over ``batches`` -> (losses, first gradient by
    leaf, the leaves' change after the last step)."""
    W = {k: v.detach().clone().requires_grad_(True) for k, v in W0.items()}
    m = {k: torch.zeros_like(v) for k, v in W0.items()}
    v2 = {k: torch.zeros_like(v) for k, v in W0.items()}
    losses, first_grad = [], None
    for t, batch in enumerate(batches, start=1):
        for w in W.values():
            w.grad = None
        losses.append(loss_and_grad(W, cfg, batch, block, half_batch))
        if first_grad is None:
            first_grad = {k: w.grad.detach().clone() for k, w in W.items()}
        with torch.no_grad():
            for k, w in W.items():
                adam_update(w, w.grad, m[k], v2[k], t, lr)
    change = {k: (W[k].detach() - W0[k]) for k in W}
    return losses, first_grad, change

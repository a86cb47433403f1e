"""Train and eval steps, on one device or as one rank of a data-parallel
group.

Counterpart of ``video_moment_localization_tpu/parallel/steps.py``
(`make_train_step`, `make_eval_step`) and of the optimizer of
``train/trainer.py``: forward, `smin_loss`, backward, one Adam update and
the on-device R@n,IoU=m counts. A step returns ``{"loss", "loss_sum",
"num_valid", "counts"}`` as device tensors and reads nothing back to the
host.

The training forward (`models.smin.smin_forward`) runs the plain biLSTM
under autograd and the kernels of the config's route: K1 / K2 (or K9) / K3,
K6 / K7, K6 and the packed unit loop (with K10 under ``fused_content``), or
K8 and the dense loop; at bf16 every route through the bf16 variants of
K1, K2 (or K9), K3, K6, K7, K8 and K10 (`check_dtype`); the eval forward
(`smin_forward_inference`) the fused
biLSTM and the fused SMI stack, or `smin_forward` without a graph in the
modes that the fused stack does not serve. A batch for pm (B, L, L) (the
dense layout and ``compat_head``) carries dense ``sm`` / ``ym`` and a
``moment_mask``. On a CUDA device a kernel launches or raises: there is no
fallback to the plain versions. The steps run on the card unless
``device="cpu"`` is asked for.

Data parallelism (`make_train_step(..., group=)`): the JAX SPMD step takes
the gradient of the global batch's loss, whose mean `smin_loss` takes over
the global batch's valid samples. Each rank here backpropagates its own
shard's loss sum over that global count and the ranks' gradients are summed
(`parallel.mesh.all_reduce_gradients`), which is that gradient. Averaging
each rank's own mean gradient is not: it weighs a shard by 1/world whatever
its valid samples, and a padded last batch or an empty tail shard holds
fewer. The global count comes from the host, where every rank's loader
knows the global batch it shards (`BatchLoader.global_valid`), so it costs
no collective: the batch carries it as ``global_valid``. The eval step
needs no group: it has no gradient, and its loss sum, valid count and
counts are summed across the ranks by the caller, once an epoch
(`Trainer._run_epoch`).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import torch

from video_moment_localization_tpu_torch.config import Config, ModelConfig
from video_moment_localization_tpu_torch.models.smin import (
    SMIN,
    check_dtype,
    smin_forward,
    smin_forward_inference,
)
from video_moment_localization_tpu_torch.ops.cuda_build import resolve_device
from video_moment_localization_tpu_torch.parallel.mesh import all_reduce_gradients
from video_moment_localization_tpu_torch.train.loss import smin_loss
from video_moment_localization_tpu_torch.train.metrics import recall_counts, recall_counts_packed

Batch = Dict[str, torch.Tensor]

# A packed batch has no moment_mask: the packed forward derives the pair
# validity from length_mask.
_FORWARD_KEYS = ("video_features", "video_mask", "query_features", "query_mask",
                 "length_mask", "moment_mask")


def build_optimizer(cfg: Config, model: SMIN) -> torch.optim.Adam:
    """Adam at ``cfg.lr`` with betas (0.9, 0.999), eps 1e-8 and no weight
    decay: the update of ``optax.adam(cfg.lr)`` (train/trainer.py:45)."""
    return torch.optim.Adam(model.parameters(), lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.0)


def _step_metrics(outputs, loss, aux, batch: Batch, use_nms: bool, nms_sigma: float):
    pm, ps, pe, _ = outputs
    if pm.dim() == 2:
        counts = recall_counts_packed(pm, ps, pe, batch["length_mask"], batch["sm"],
                                      batch.get("sample_mask"), use_nms=use_nms,
                                      nms_sigma=nms_sigma)
    else:
        counts = recall_counts(pm, ps, pe, batch["moment_mask"], batch["sm"],
                               batch.get("sample_mask"), use_nms=use_nms, nms_sigma=nms_sigma)
    return {"loss": loss, "loss_sum": aux["loss_sum"].detach(), "num_valid": aux["num_valid"],
            "counts": counts}


def make_train_step(cfg: ModelConfig, model: SMIN, optimizer: torch.optim.Optimizer,
                    device: Union[str, torch.device] = "cuda", group: Optional[object] = None
                    ) -> Callable[[Batch], Dict[str, torch.Tensor]]:
    """Returns batch -> metrics; each call updates ``model`` and
    ``optimizer`` in place. The model is moved to ``device`` here (its
    parameters stay the objects the optimizer holds, fp32 at either compute
    dtype: Adam updates them, as optax does the JAX package's).

    ``group``: the process group of a data-parallel run (see the module
    docstring). The batch is then this rank's shard and must carry
    ``global_valid``, the global batch's valid samples (0-dim); "loss" is
    this rank's share of the global batch's mean loss, "loss_sum" and
    "num_valid" its shard's own. The replicas must start equal
    (`parallel.mesh.put_replicated`): the summed gradient and Adam keep them
    equal bit for bit."""
    check_dtype(cfg)
    device = resolve_device(device, "make_train_step")
    model.to(device)
    named = list(model.named_parameters())

    def train_step(batch: Batch) -> Dict[str, torch.Tensor]:
        batch = {k: v.to(device) for k, v in batch.items()}
        denominator = batch.pop("global_valid", None)
        if group is not None and denominator is None:
            raise ValueError("a data-parallel train step needs batch['global_valid'], the "
                             "valid samples of the global batch")
        model.train()
        optimizer.zero_grad(set_to_none=True)
        with torch.enable_grad():
            outputs = smin_forward(model, cfg, *(batch.get(k) for k in _FORWARD_KEYS))
            loss, aux = smin_loss(outputs, batch, denominator)
            loss.backward()
        if group is not None:
            all_reduce_gradients(named, group)
        optimizer.step()
        with torch.no_grad():
            outputs = tuple(o.detach() for o in outputs)
            return _step_metrics(outputs, loss.detach(), aux, batch, False, 0.0)

    return train_step


def make_eval_step(cfg: ModelConfig, model: SMIN, use_nms: bool = False,
                   nms_sigma: float = 0.5, device: Union[str, torch.device] = "cuda"
                   ) -> Callable[[Batch], Dict[str, torch.Tensor]]:
    """Returns batch -> metrics (loss and recall counts), grad-free, through
    `smin_forward_inference`, which routes as the JAX package's does: it
    takes what the serving forward takes (`check_dtype`: every route in
    fp32 and bf16)."""
    check_dtype(cfg)
    device = resolve_device(device, "make_eval_step")
    model.to(device)

    @torch.no_grad()
    def eval_step(batch: Batch) -> Dict[str, torch.Tensor]:
        batch = {k: v.to(device) for k, v in batch.items()}
        model.eval()
        outputs = smin_forward_inference(model, cfg, *(batch.get(k) for k in _FORWARD_KEYS))
        loss, aux = smin_loss(outputs, batch)
        return _step_metrics(outputs, loss, aux, batch, use_nms, nms_sigma)

    return eval_step

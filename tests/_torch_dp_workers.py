"""Rank functions of the data-parallel tests (tests/test_torch_parallel.py on
the CPU, tests/test_torch_cuda.py on the card). Each runs in a process that
`parallel.mesh.spawn` started, imports nothing of JAX, and writes what it saw
to a file that the test reads."""

import numpy as np
import torch

from video_moment_localization_tpu_torch.config import Config, ModelConfig
from video_moment_localization_tpu_torch.models.smin import SMIN
from video_moment_localization_tpu_torch.ops import proposal_cuda, smin_train_cuda
from video_moment_localization_tpu_torch.parallel import mesh
from video_moment_localization_tpu_torch.parallel.steps import (
    build_optimizer,
    make_eval_step,
    make_train_step,
)

COUNTERS = {"K1f": proposal_cuda.proposal_rows_forward,
            "K1b": proposal_cuda.proposal_rows_backward,
            "K2": smin_train_cuda.smi_layer_forward, "K3": smin_train_cuda.smi_layer_backward}


def shard(batch, rank, world):
    """This rank's contiguous rows of a global NumPy batch as tensors, with
    the global batch's valid count as ``global_valid``."""
    b = len(batch["sample_mask"]) // world
    out = {k: torch.from_numpy(np.ascontiguousarray(v[rank * b: (rank + 1) * b]))
           for k, v in batch.items()}
    out["global_valid"] = torch.tensor(float(batch["sample_mask"].sum()))
    return out


def eval_sums(cfg, model, batch, rank, world, device, group):
    """The eval step on this rank's shard: its loss sum, valid count and
    recall counts, summed over the ranks."""
    ev = make_eval_step(cfg, model, device=device)(shard(batch, rank, world))
    sums = torch.cat([ev["loss_sum"].reshape(1), ev["num_valid"].reshape(1),
                      ev["counts"].reshape(-1)]).double()
    return mesh.all_reduce_sums(sums, group).cpu()


def run_cases(rank, cases, out_pattern, device="cpu"):
    """For each case {"name", "model": ModelConfig keywords, "state": initial
    state_dict, "batches": global NumPy batches, "lr", "eval"}: a replica of
    ``state`` on ``device`` (broadcast from rank 0), then one data-parallel
    train step per global batch on this rank's shard. Saves, per case: each
    step's global loss (the ranks' shares summed), every gradient of step 1
    after the reduction, every parameter after each step, the launch
    counters of K1 / K2 / K3 over the steps, and with "eval" the eval step's
    summed loss sum, valid count and counts before the first step."""
    group = mesh.default_group()
    world = mesh.world_size()
    results = {}
    for case in cases:
        cfg = ModelConfig(**case["model"])
        model = SMIN(cfg)
        model.load_state_dict(case["state"])
        mesh.put_replicated(model.to(device), group)
        res = {"loss": [], "params": [], "grads": None}
        if case.get("eval"):
            res["eval"] = eval_sums(cfg, model, case["batches"][0], rank, world, device, group)
        step = make_train_step(cfg, model, build_optimizer(Config(model=cfg, lr=case["lr"]),
                                                           model), device, group=group)
        for fn in COUNTERS.values():
            fn.launches = 0
        for k, batch in enumerate(case["batches"]):
            m = step(shard(batch, rank, world))
            res["loss"].append(float(mesh.all_reduce_sums(m["loss"].clone(), group)))
            if k == 0:
                res["grads"] = {n: p.grad.detach().cpu().clone()
                                for n, p in model.named_parameters()}
            res["params"].append({n: p.detach().cpu().clone()
                                  for n, p in model.named_parameters()})
        res["launches"] = {k: fn.launches for k, fn in COUNTERS.items()}
        results[case["name"]] = res
    torch.save(results, out_pattern % rank)


def fail_or_wait(rank, bad, seconds):
    """Rank ``bad`` raises at once; the others sleep ``seconds`` (a rank that
    hangs)."""
    import time

    if rank == bad:
        raise ValueError(f"rank {rank} failed on purpose")
    time.sleep(seconds)

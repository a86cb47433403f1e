"""Rank functions of the sequence-parallel tests (tests/test_torch_seq_*.py on
the CPU). Each runs in a process that `parallel.mesh.spawn` started, imports
nothing of JAX, and writes what it saw to a file that the test reads."""

import numpy as np
import torch
import torch.distributed as dist

from video_moment_localization_tpu_torch.config import Config, ModelConfig
from video_moment_localization_tpu_torch.models.smin import SMIN
from video_moment_localization_tpu_torch.parallel import mesh
from video_moment_localization_tpu_torch.parallel.collectives import group_rank, group_size
from video_moment_localization_tpu_torch.parallel.model_parallel import (
    make_eval_step_2d,
    make_train_step_2d,
    pool_packed_chunk,
    put_batch_2d,
    smin_forward_seq_sharded,
    smin_forward_seq_sharded_packed,
)
from video_moment_localization_tpu_torch.parallel.sequence import proposal_features_seq_sharded
from video_moment_localization_tpu_torch.parallel.steps import build_optimizer

FORWARD_KEYS = ("video_features", "video_mask", "query_features", "query_mask", "length_mask")


def data_shard(batch, grid):
    """The rows of a global NumPy batch that data index ``grid.data`` of
    ``grid.nd`` loads, with the global batch's valid count."""
    b = len(batch["sample_mask"]) // grid.nd
    out = {k: np.ascontiguousarray(v[grid.data * b:(grid.data + 1) * b]) for k, v in batch.items()}
    out["global_valid"] = np.asarray(batch["sample_mask"].sum(), np.float32)
    return out


def _model(case):
    cfg = ModelConfig(**case["model"])
    model = SMIN(cfg)
    model.load_state_dict(case["state"])
    return cfg, model


def _sums(m):
    return torch.cat([m["loss_sum"].reshape(1), m["num_valid"].reshape(1),
                      m["counts"].reshape(-1)]).double()


def run_case(case, grid):
    """One case on this rank of ``grid``; returns what the test reads."""
    kind, group = case["kind"], grid.seq_group
    k, n = group_rank(group), group_size(group)
    if kind in ("pool", "pool_packed"):
        f = torch.from_numpy(case["f"]).to(getattr(torch, case.get("dtype", "float32")))
        t = f.shape[1] // n
        f_loc = f[:, k * t:(k + 1) * t]
        if kind == "pool":
            rows = case["L"] // n
            mm = torch.from_numpy(case["moment_mask"][:, k * rows:(k + 1) * rows])
            return proposal_features_seq_sharded(f_loc, mm, case["L"], case["C"], group)
        vmask = torch.from_numpy(case["vmask_padded"])
        chunk = vmask.shape[1] // n
        return pool_packed_chunk(f_loc, vmask[:, k * chunk:(k + 1) * chunk], case["L"],
                                 case["C"], group)
    if kind in ("forward_packed", "forward_dense"):
        cfg, model = _model(case)
        b = put_batch_2d(case["batch"], grid, "cpu")
        with torch.no_grad():
            if kind == "forward_packed":
                return smin_forward_seq_sharded_packed(
                    model, cfg, *(b[key] for key in FORWARD_KEYS), group)
            rows = cfg.L // n
            return smin_forward_seq_sharded(model, cfg, *(b[key] for key in FORWARD_KEYS),
                                            b["moment_mask"][:, k * rows:(k + 1) * rows], group)
    if kind == "train":
        cfg, model = _model(case)
        mesh.put_replicated(model, grid.world_group)
        res = {"loss": [], "sums": [], "params": []}
        if case.get("eval"):
            ev = make_eval_step_2d(cfg, model, grid, device="cpu")(
                put_batch_2d(data_shard(case["batches"][0], grid), grid, "cpu"))
            res["eval"] = mesh.all_reduce_sums(_sums(ev), grid.data_group)
        step = make_train_step_2d(cfg, model, build_optimizer(Config(model=cfg, lr=case["lr"]),
                                                              model), grid, "cpu")
        for i, batch in enumerate(case["batches"]):
            m = step(put_batch_2d(data_shard(batch, grid), grid, "cpu"))
            res["loss"].append(float(mesh.all_reduce_sums(m["loss"].clone(), grid.data_group)))
            res["sums"].append(mesh.all_reduce_sums(_sums(m), grid.data_group))
            if i == 0:
                res["grads"] = {name: p.grad.clone() for name, p in model.named_parameters()}
            res["params"].append({name: p.detach().clone()
                                  for name, p in model.named_parameters()})
        return res
    raise ValueError(kind)


def run_cases(rank, cases, out_pattern):
    """Every case on the (data x seq) grid its "seq" names over all the
    ranks (one grid a seq width, made once); saves each case's result by
    name to ``out_pattern % rank``. A "bad_width" case runs the dense
    forward on a group of its "ranks" and saves the error it raised."""
    grids, out = {}, {}
    for case in cases:
        if case["kind"] == "bad_width":
            group = dist.new_group(case["ranks"])
            if rank in case["ranks"]:
                cfg, model = _model(case)
                b = mesh.put_batch(case["batch"], "cpu")
                try:
                    smin_forward_seq_sharded(model, cfg, *(b[key] for key in FORWARD_KEYS),
                                             b["moment_mask"], group)
                    out[case["name"]] = None
                except ValueError as e:
                    out[case["name"]] = str(e)
            continue
        seq = case["seq"]
        if seq not in grids:
            grids[seq] = mesh.make_grid_2d(seq)
        out[case["name"]] = run_case(case, grids[seq])
    torch.save(out, out_pattern % rank)


def fit_epochs(rank, cfg_path, epochs, out):
    """`Trainer.fit` for ``epochs`` epochs of the config at ``cfg_path`` on
    this rank, its loaders its data index's shards; rank 0 saves the grid,
    the stats file's epochs and train losses to ``out``."""
    import json

    from video_moment_localization_tpu_torch.config import load_config
    from video_moment_localization_tpu_torch.data.pipeline import BatchLoader
    from video_moment_localization_tpu_torch.train.trainer import Trainer, build_datasets

    cfg = load_config(cfg_path, num_epochs_override=epochs)
    trainer = Trainer(cfg, device="cpu")
    train_ds, eval_ds = build_datasets(cfg)
    shard = dict(shard_id=trainer.shard_id, num_shards=trainer.num_shards,
                 num_workers=cfg.num_workers, seed=cfg.seed)
    trainer.fit(BatchLoader(train_ds, cfg.batch_size, shuffle=True, **shard),
                BatchLoader(eval_ds, cfg.batch_size, shuffle=False, **shard))
    if rank == 0:
        with open(trainer.stats_path) as fh:
            stats = json.load(fh)
        torch.save({"grid": (trainer.grid.nd, trainer.grid.seq), "epochs": stats["epoch"],
                    "train_loss": stats["train_loss"]}, out)

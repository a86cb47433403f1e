"""Command line of the PyTorch port: train, resume and test on feature files.

    python -m video_moment_localization_tpu_torch.main \
        --config_path config/charadessta.yml [--num_epochs N] [--test [--best]] \
        [--nms] [--save_best 'R@1, IoU=0.5'] [--compat_metrics] \
        [--profile_dir DIR] [--debug_nans] [--device cuda|cuda:K|cpu] \
        [--num_devices N | --distributed] [--seq_devices S]

The flags of the JAX package's ``main.py``, with the same names and meanings
(reference main.py:13-28, 278-313), and the same stdout lines. ``--device``
picks the device (default: the card). ``--compute_dtype bfloat16`` trains
and tests on every route (the whole-layer route: Charades, TACoS; the
content-unit route: ActivityNet; the unit loop of ``--compat_metrics`` and
``fused_smi_train: False``; the dense layout of ``packed: False``).
``--debug_nans`` reads each step's loss back and checks every gradient,
failing at the first non-finite value. GloVe is found as the JAX CLI finds
it: the data directory's ``glove/glove.6B.300d.txt``, ``$GLOVE_PATH``, then
the default locations.

Data parallelism (`parallel.mesh`), one process per device, each loading its
shard of every global batch, rank 0 alone printing and writing:

* ``--distributed``: this process is one rank started by a launcher, which
  set ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
  ``MASTER_PORT`` (``torchrun --nproc_per_node N -m
  video_moment_localization_tpu_torch.main --distributed ...``); its device
  is ``cuda:LOCAL_RANK``, the backend NCCL (gloo under ``--device cpu``);
* ``--num_devices N`` (N > 1, no launcher): this process starts the N ranks
  itself, on ``cuda:0`` ... ``cuda:N-1`` with NCCL (refused past the cards
  there are), under ``--device cuda:K`` all on card K, or under ``--device
  cpu`` as N ranks on the CPU; ranks that share a device use gloo, which
  moves CUDA tensors through the host (NCCL refuses two ranks on one card;
  `parallel.mesh.spawn_backend`).

``--seq_devices S`` (S > 1) trains, resumes and tests on the 2-D (data x
seq) grid of those ranks (`parallel.model_parallel`, the JAX package's 2-D
mesh): S contiguous ranks share each data shard's video, a T / S chunk each,
so it needs ``--num_devices N`` (N a multiple of S) or ``--distributed``
with such a world; outside a group of at least S ranks it is refused with
how to start them, and bad widths with the JAX trainer's messages
(`train.trainer.check_world`).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence

import torch

from video_moment_localization_tpu_torch.config import Config, load_config
from video_moment_localization_tpu_torch.data.pipeline import BatchLoader
from video_moment_localization_tpu_torch.models.smin import check_dtype
from video_moment_localization_tpu_torch.parallel import mesh
from video_moment_localization_tpu_torch.train.trainer import (
    Trainer,
    build_datasets,
    check_world,
)


def get_parameters(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config_path", default="config/charadessta.yml",
                        help="Path to config file.")
    parser.add_argument("--num_epochs", default=0, type=int,
                        help="Number of epochs to override value in the config.")
    parser.add_argument("--test", default=False, action="store_true",
                        help="Test the saved model for this config.")
    parser.add_argument("--nms", default=False, action="store_true",
                        help="Use soft-NMS proposal selection at eval.")
    parser.add_argument("--num_devices", default=None, type=int,
                        help="Data-parallel ranks, one a device; above 1 without a launcher "
                             "this process starts them.")
    parser.add_argument("--seq_devices", default=None, type=int,
                        help="Sequence-parallel width: shard the clip axis and the proposal "
                             "map over this many ranks (a 2-D data x seq grid when > 1).")
    parser.add_argument("--compute_dtype", default=None, choices=["float32", "bfloat16"],
                        help="Activation compute dtype.")
    parser.add_argument("--profile_dir", default=None,
                        help="Write a torch.profiler Chrome trace of training to this "
                             "directory.")
    parser.add_argument("--debug_nans", default=False, action="store_true",
                        help="Fail fast on a non-finite loss or gradient.")
    parser.add_argument("--save_best", default=None,
                        help="Track the best checkpoint by this eval metric "
                             "(e.g. 'R@1, IoU=0.5'); saves {experiment}_model_best.ckpt.")
    parser.add_argument("--best", default=False, action="store_true",
                        help="With --test: load the best checkpoint instead of the last one.")
    parser.add_argument("--compat_metrics", default=False, action="store_true",
                        help="Reference-compat eval: dense (L, L) score map and labels, "
                             "bit-reproducing the reference's top-k tie quirk "
                             "(PARITY.md #16).")
    parser.add_argument("--distributed", default=False, action="store_true",
                        help="This process is one rank started by a launcher (RANK, "
                             "WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT); each rank "
                             "loads its shard of every global batch.")
    parser.add_argument("--device", default="cuda",
                        help="Device to train and test on (default: cuda); with "
                             "--num_devices, cuda:K puts every rank on card K.")
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = get_parameters(argv)
    cfg = load_config(args.config_path, num_epochs_override=args.num_epochs)
    # Flags only override when explicitly provided (YAML values otherwise).
    if args.nms:
        cfg.nms = True
    if args.num_devices is not None:
        cfg.num_devices = args.num_devices
    if args.seq_devices is not None:
        cfg.seq_devices = args.seq_devices
    if args.save_best is not None:
        cfg.save_best = args.save_best
    if args.profile_dir is not None:
        cfg.profile_dir = args.profile_dir
    if args.compute_dtype:
        cfg.model = dataclasses.replace(cfg.model, compute_dtype=args.compute_dtype)
    if args.compat_metrics:
        cfg.model = dataclasses.replace(cfg.model, compat_head=True)
    check_dtype(cfg.model)

    n = cfg.num_devices or 1
    if args.distributed:
        mesh.initialize_distributed(device=args.device)
        try:
            run(args, cfg)
        finally:
            torch.distributed.destroy_process_group()
    elif n > 1:
        check_world(cfg, n)
        device = torch.device(args.device)
        if device.type == "cuda" and device.index is None:
            if n > torch.cuda.device_count():
                raise ValueError(f"--num_devices {n}: requested {n} devices, only "
                                 f"{torch.cuda.device_count()} available")
            devices = [f"cuda:{r}" for r in range(n)]
        else:
            devices = [args.device] * n
        mesh.spawn(_rank_run, n, devices, args=(args, cfg))
    else:
        run(args, cfg)


def _rank_run(rank: int, args: argparse.Namespace, cfg: Config) -> None:
    """One rank started by `main` (`mesh.spawn`), in its process group."""
    run(args, cfg)


def run(args: argparse.Namespace, cfg: Config) -> None:
    """Train, or test, as this process's rank (the only one outside a
    process group): its loaders hold its shard of every global batch (on
    the 2-D grid, its data index's)."""
    trainer = Trainer(cfg, device=args.device, debug_nans=args.debug_nans, test_only=args.test)
    shard = dict(shard_id=trainer.shard_id, num_shards=trainer.num_shards)
    if not args.test:
        train_ds, eval_ds = build_datasets(cfg)
        train_loader = BatchLoader(train_ds, cfg.batch_size, shuffle=True,
                                   num_workers=cfg.num_workers, seed=cfg.seed, **shard)
        eval_loader = BatchLoader(eval_ds, cfg.batch_size, shuffle=False,
                                  num_workers=cfg.num_workers, seed=cfg.seed, **shard)
        trainer.fit(train_loader, eval_loader)
    else:
        test_ds = build_datasets(cfg, test_only=True)
        test_loader = BatchLoader(test_ds, cfg.batch_size, shuffle=False,
                                  num_workers=cfg.num_workers, seed=cfg.seed, **shard)
        trainer.load_for_test(use_best=args.best)
        metrics = trainer.evaluate(test_loader)
        if trainer.is_main:   # one metrics report per job
            for k, v in metrics.items():
                print(f"{k} - {v}")
            print(f"throughput - {trainer.timer.throughput:.1f} query-video pairs/s")


if __name__ == "__main__":
    main()

"""Training/eval/test orchestration, on one device or data-parallel.

Counterpart of ``video_moment_localization_tpu/train/trainer.py``, with the
public behaviour of the reference orchestration (reference
main.py:135-276): per-epoch stdout lines, a cumulative
``{experiment}_stats.json`` rewritten every epoch with
epoch/train_loss/eval_loss/train_<metric>/eval_<metric> arrays, a single
overwritten checkpoint per experiment, and resume-at-epoch+1 semantics.
Charades-STA evaluates on its test split (it has no val split, reference
main.py:45-47).

The steps are the port's own (`parallel.steps`): one train step (forward,
loss, backward, Adam) and one eval step (forward, loss, recall counts), on
the card unless the CPU is asked for. Batches come from the host loader as
NumPy arrays; the trainer copies each through pinned memory with a
non-blocking transfer on the main thread, dispatches the steps with no host
read per step, and reads the losses and counts back once per epoch.

Data parallelism, as the JAX trainer's 1-D ``data`` mesh: one process per
device in a ``torch.distributed`` group (`parallel.mesh`). Each rank's
loaders hold its shard of every global batch (``shard_id=rank``,
``num_shards=world``), the train step sums the ranks' gradients, and one
all-reduce an epoch sums the loss sums, valid counts and recall counts.
Rank 0 alone prints and writes the stats file and the checkpoints; every
rank resumes and loads for ``--test``. The JAX trainer's automatic SMI
rematerialization comes with it (`maybe_enable_remat`, against this
device's memory).

Sequence parallelism, as the JAX trainer's 2-D (data x seq) mesh
(``seq_devices`` > 1): the ranks form the grid of `mesh.make_grid_2d`, the
loaders are sharded by data index (``shard_id`` the data index,
``num_shards`` nd), each rank takes its T chunk of its data shard
(`model_parallel.put_batch_2d`), the steps are `make_train_step_2d` /
`make_eval_step_2d`, and an epoch's sums are summed over the data group.
``compat_head`` switches to the dense layout there, as in JAX. The checks
and their messages are the JAX trainer's (`check_world`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
from collections import defaultdict
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from video_moment_localization_tpu_torch.config import Config, ModelConfig
from video_moment_localization_tpu_torch.data.datasets import get_dataset_class
from video_moment_localization_tpu_torch.data.glove import WordEmbedding
from video_moment_localization_tpu_torch.data.pipeline import BatchLoader
from video_moment_localization_tpu_torch.models.smin import (
    SMIN,
    check_dtype,
)
from video_moment_localization_tpu_torch.ops.cuda_build import resolve_device
from video_moment_localization_tpu_torch.parallel import mesh
from video_moment_localization_tpu_torch.parallel.model_parallel import (
    make_eval_step_2d,
    make_train_step_2d,
    put_batch_2d,
)
from video_moment_localization_tpu_torch.parallel.steps import (
    build_optimizer,
    make_eval_step,
    make_train_step,
)
from video_moment_localization_tpu_torch.train.metrics import counts_to_dict, metric_names
from video_moment_localization_tpu_torch.utils.checkpoint import (
    checkpoint_paths,
    load_checkpoint,
    save_checkpoint,
)
from video_moment_localization_tpu_torch.utils.profiling import StepTimer, trace_context

# Steps dispatched between two waits for the device: bounds the batches in
# flight without giving up the overlap of host and device work.
DRAIN_EVERY = 16
# The share of this device's memory that the SMI residuals may take before
# the trainer turns on rematerialization (`remat_budget`): half, leaving the
# other half to the weights, Adam's moments, the kernels' workspaces and the
# allocator's slack. On an 80 GB H100 the ActivityNet B=64 step's estimate,
# 16.4e9 bytes packed and 32.2e9 dense (27.55 GiB measured peak), stays
# under it; the JAX trainer's budget is a TPU chip's 6e9.
REMAT_MEMORY_SHARE = 0.5


def check_world(cfg: Config, world: int) -> None:
    """Raise ValueError unless ``cfg`` fits a run of ``world`` ranks, one a
    device, as the JAX trainer checks its mesh: ``num_devices`` (None: the
    world) equal to it and the global batch divisible by it; with
    ``seq_devices`` S > 1 a group of at least S ranks (outside one, how to
    start them), the device count divisible by S, and the batch by the data
    shards, T and L by S (the JAX messages)."""
    seq = max(1, int(cfg.seq_devices))
    if seq > 1 and cfg.num_devices is None and world < seq:
        raise ValueError(
            f"seq_devices={seq} runs on a group of at least {seq} ranks, one a device, and this "
            f"process is one of {world}: start them with `main --num_devices N --seq_devices "
            f"{seq}` (N a multiple of {seq}) or with a launcher and `--distributed`")
    n = world if cfg.num_devices is None else cfg.num_devices
    if seq > 1:
        m = cfg.model
        if n % seq:
            raise ValueError(f"device count ({n}) must be divisible by seq_devices ({seq})")
        nd = n // seq
        if cfg.batch_size % nd or m.T % seq or m.L % seq:
            raise ValueError(f"2-D mesh needs batch_size % {nd} == 0 and T ({m.T}), L ({m.L}) "
                             f"divisible by seq_devices ({seq})")
    if n != world:
        flags = f" --seq_devices {seq}" if seq > 1 else ""
        raise ValueError(
            f"num_devices={n}, but this process is one of {world} rank(s): start {n} ranks "
            f"with `main --num_devices {n}{flags}` or with a launcher and `--distributed`")
    if seq == 1 and cfg.batch_size % world:
        raise ValueError(f"batch_size ({cfg.batch_size}) must be divisible by the number of "
                         f"devices ({world})")


def remat_budget(device) -> float:
    """Bytes the SMI residuals may take on ``device``: REMAT_MEMORY_SHARE of
    the card's memory, or on the CPU of the host's."""
    device = torch.device(device)
    if device.type == "cuda":
        total = torch.cuda.get_device_properties(device).total_memory
    else:
        total = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    return REMAT_MEMORY_SHARE * total


def maybe_enable_remat(m: ModelConfig, batch_size: int, world: int, budget: float,
                       verbose: bool = True) -> ModelConfig:
    """``m`` with ``remat_smi`` on when the JAX trainer's estimate of the
    backward's residuals for one device's batch exceeds ``budget`` bytes
    (its ``_maybe_enable_remat``: about 5 content-unit tensors of (B, N, C,
    D) a layer); ``m`` itself otherwise. Numerically invisible."""
    if m.remat_smi:
        return m
    per_dev_b = batch_size // world
    n_pairs = m.L * (m.L + 1) // 2 if m.packed else m.L * m.L
    itemsize = 2 if m.compute_dtype == "bfloat16" else 4
    est = m.num_smi_layers * 5 * per_dev_b * n_pairs * m.C * m.D * itemsize
    if est <= budget:
        return m
    if verbose:
        print(f"[trainer] enabling SMI remat: estimated residuals {est / 1e9:.1f} GB/device "
              f"exceed the budget of {budget / 1e9:.1f} GB")
    return dataclasses.replace(m, remat_smi=True)


def build_datasets(cfg: Config, embedding: Optional[WordEmbedding] = None,
                   test_only: bool = False):
    """Split factories (reference main.py:43-55)."""
    cls = get_dataset_class(cfg.dataset)
    glove = os.path.join(cfg.data_dir, "glove/glove.6B.300d.txt")
    emb = embedding or WordEmbedding.load(glove if os.path.exists(glove) else None)
    m = cfg.model
    kw = dict(data_dir=cfg.data_dir, T=m.T, L=m.L,
              max_query_length=m.max_query_length, embedding=emb)
    # Packed models consume packed (N,) sm/ym and no dense moment_mask;
    # the compat_head eval mode keeps the dense reference-quirk pipeline.
    packed_labels = m.packed and not m.compat_head
    if test_only:
        test = cls(split="test", **kw)
        test.packed_labels = packed_labels
        return test
    train = cls(split="train", **kw)
    eval_split = "test" if cfg.dataset == "charadessta" else "val"
    evald = cls(split=eval_split, **kw)
    train.packed_labels = evald.packed_labels = packed_labels
    return train, evald


def write_stats(path: str, stats: Dict[str, list]) -> None:
    """The cumulative ``{experiment}_stats.json``, rewritten."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(stats, f)


class Trainer:
    """Owns the model, the optimizer, the steps and the epoch loop.

    In a process group (`parallel.mesh.initialize_distributed`) the Trainer
    is one rank of a data-parallel run, or of the 2-D grid under
    ``seq_devices``: its device is `mesh.device_for_rank` of ``device``, its
    loaders must hold shard ``shard_id`` of ``num_shards`` (the rank and the
    world, or on the grid the data index and nd), and its replica starts
    from rank 0's weights (`mesh.put_replicated`).

    ``state_dict``: initial weights (a SMIN state_dict) in place of the
    seeded initialization, for example a JAX parameter tree carried across
    by ``models.port.state_dict_from_jax_params``. ``debug_nans``: read each
    step's loss back and check every gradient, raising at the first
    non-finite value with its epoch and step. ``test_only``: a Trainer for
    ``--test`` (`load_for_test`, `evaluate`) with no train step.
    """

    def __init__(self, cfg: Config, device="cuda",
                 state_dict: Optional[Dict[str, torch.Tensor]] = None, debug_nans: bool = False,
                 test_only: bool = False):
        check_dtype(cfg.model)
        self.world, self.rank, self.group = mesh.world_size(), mesh.rank(), mesh.default_group()
        check_world(cfg, self.world)
        self.is_main = self.rank == 0
        self.cfg = cfg
        self.debug_nans = debug_nans
        seq = max(1, int(cfg.seq_devices))
        self.grid = mesh.make_grid_2d(seq) if seq > 1 else None
        # The loaders' shard and the group an epoch's sums are summed over.
        self.shard_id, self.num_shards, self.sum_group = (
            (self.grid.data, self.grid.nd, self.grid.data_group) if self.grid is not None
            else (self.rank, self.world, self.group))
        if self.grid is not None and cfg.model.packed and cfg.model.compat_head:
            # The reference-compat eval quirk needs the dense pipeline; the
            # packed pair-chunk seq path is the default otherwise.
            cfg.model = dataclasses.replace(cfg.model, packed=False)
            self._say("[trainer] 2-D (data x seq) mesh + compat_head: dense row-sharded layout "
                      "(packed=False)")
        if self.group is not None:
            device = mesh.device_for_rank(device)
        self.device = resolve_device(device, "Trainer")
        cfg.model = maybe_enable_remat(cfg.model, cfg.batch_size, self.world,
                                       remat_budget(self.device), verbose=self.is_main)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.seed)
            self.model = SMIN(cfg.model)
        if state_dict is not None:
            self.model.load_state_dict(state_dict, strict=True)
        mesh.put_replicated(self.model.to(self.device), self.group)
        self.optimizer = build_optimizer(cfg, self.model)
        if self.grid is not None:
            self.train_step = (None if test_only else
                               make_train_step_2d(cfg.model, self.model, self.optimizer,
                                                  self.grid, self.device))
            self.eval_step = make_eval_step_2d(cfg.model, self.model, self.grid,
                                               device=self.device)
            self.test_step = make_eval_step_2d(cfg.model, self.model, self.grid, use_nms=cfg.nms,
                                               nms_sigma=cfg.nms_sigma, device=self.device)
        else:
            self.train_step = (None if test_only else
                               make_train_step(cfg.model, self.model, self.optimizer,
                                               self.device, group=self.group))
            self.eval_step = make_eval_step(cfg.model, self.model, device=self.device)
            self.test_step = make_eval_step(cfg.model, self.model, use_nms=cfg.nms,
                                            nms_sigma=cfg.nms_sigma, device=self.device)
        self.model_path, self.stats_path = checkpoint_paths(cfg.checkpoint_path,
                                                            cfg.experiment)
        self.best_model_path = self.model_path.replace("_model.ckpt", "_model_best.ckpt")
        if cfg.save_best is not None and cfg.save_best not in metric_names():
            raise ValueError(f"save_best metric {cfg.save_best!r} unknown; choose "
                             f"from {metric_names()}")
        self.timer = StepTimer()

    # ------------------------------------------------------------------ #
    def _to_device(self, batch) -> Dict[str, torch.Tensor]:
        """The batch's arrays as tensors on the device (`mesh.put_batch`:
        through pinned host memory and a non-blocking copy on the card; on
        the 2-D grid this rank's T chunk, `put_batch_2d`). Called on the main
        thread only; the loader's threads touch no device."""
        if self.grid is not None:
            return put_batch_2d(batch, self.grid, self.device)
        return mesh.put_batch(batch, self.device)

    def _check_finite(self, m, epoch: int, step: int, train: bool) -> None:
        """--debug_nans: one host read of the loss and, after a train step,
        one of a finiteness flag over every gradient."""
        loss = float(m["loss"])
        what = None if math.isfinite(loss) else f"loss {loss}"
        if what is None and train:
            flags = [torch.isfinite(p.grad).all() for p in self.model.parameters()
                     if p.grad is not None]
            if not bool(torch.stack(flags).all()):
                bad = [n for n, p in self.model.named_parameters()
                       if p.grad is not None and not bool(torch.isfinite(p.grad).all())]
                what = f"gradient of {', '.join(bad)}"
        if what is not None:
            raise FloatingPointError(f"non-finite {what} at epoch {epoch}, "
                                     f"{'train' if train else 'eval'} step {step}")

    def _run_epoch(self, loader: BatchLoader, epoch: int, train: bool,
                   step_fn=None) -> Tuple[float, Dict[str, float]]:
        """One pass over a loader; returns (avg loss, normalized metrics).

        Steps are dispatched back to back with no host read, with a wait for
        the device every DRAIN_EVERY steps. Each step's loss sum, valid
        count and recall counts stay on the device until the end: then one
        float64 sum over the steps, one all-reduce over the ranks
        (`mesh.all_reduce_sums`) and one read back. A data-parallel train
        batch carries its global batch's valid count (`parallel.steps`)."""
        if (loader.shard_id, loader.num_shards) != (self.shard_id, self.num_shards):
            raise ValueError(f"loader shard {loader.shard_id} of {loader.num_shards}, but this "
                             f"Trainer loads shard {self.shard_id} of {self.num_shards}")
        step_fn = step_fn or (self.train_step if train else self.eval_step)
        per_step = []
        self.timer.start()
        # closing(): a step that raises stops the loader's producer thread at
        # once, not when the traceback that holds the generator is freed.
        with contextlib.closing(loader.epoch(epoch)) as batches:
            for i, batch in enumerate(batches):
                if train and self.group is not None:
                    batch = dict(batch, global_valid=np.asarray(loader.global_valid(i),
                                                                np.float32))
                m = step_fn(self._to_device(batch))
                per_step.append(torch.cat([m["loss_sum"].reshape(1), m["num_valid"].reshape(1),
                                           m["counts"].reshape(-1)]).double())
                if self.debug_nans:
                    self._check_finite(m, epoch, i + 1, train)
                if (i + 1) % DRAIN_EVERY == 0 and self.device.type == "cuda":
                    torch.cuda.current_stream(self.device).synchronize()
        if not per_step:   # the same on every rank: each emits a batch per global batch
            self.timer.stop(0)
            return 0.0, {}
        sums = mesh.all_reduce_sums(torch.stack(per_step).sum(0), self.sum_group).cpu().numpy()
        num = max(float(sums[1]), 1.0)
        self.timer.stop(int(sums[1]))
        # Counts are whole numbers: float32 holds them exactly, and their
        # shares come out in float32, as the JAX trainer's do.
        counts = sums[2:].astype(np.float32).reshape(m["counts"].shape)
        return float(sums[0]) / num, counts_to_dict(counts / num)

    # ------------------------------------------------------------------ #
    def _existing_stats(self, start_epoch: int) -> Dict[str, list]:
        """Truncate a prior stats file to completed epochs on resume
        (reference main.py:220-229)."""
        stats = defaultdict(list)
        if self.cfg.resume_training and os.path.exists(self.stats_path):
            done = start_epoch - 1
            # With eval_every > 1 the eval arrays are shorter: one entry per
            # evaluated epoch (multiples of eval_every, plus the final epoch).
            evals_done = done // self.cfg.eval_every
            if done == self.cfg.num_epochs and done % self.cfg.eval_every:
                evals_done += 1
            with open(self.stats_path) as f:
                for key, val in json.load(f).items():
                    keep = evals_done if key.startswith("eval") else done
                    stats[key] = val[:keep]
        return stats

    def maybe_resume(self) -> int:
        """Load the checkpoint if resume_training is set; return the start
        epoch (the checkpoint's epoch + 1, else 1)."""
        if not self.cfg.resume_training:
            return 1
        ckpt = load_checkpoint(self.model_path)
        if ckpt is None:
            return 1
        self.model.load_state_dict(ckpt["model"], strict=True)
        self.optimizer.load_state_dict(ckpt["optimizer"])
        return ckpt["epoch"] + 1

    def load_for_test(self, use_best: bool = False) -> None:
        path = self.best_model_path if use_best else self.model_path
        ckpt = load_checkpoint(path)
        if ckpt is None:
            raise FileNotFoundError(f"No saved model at {path}!")
        self.model.load_state_dict(ckpt["model"], strict=True)

    def _say(self, line: str) -> None:
        """A stdout line, from rank 0 only."""
        if self.is_main:
            print(line)

    # ------------------------------------------------------------------ #
    def fit(self, train_loader: BatchLoader, eval_loader: BatchLoader) -> None:
        if self.train_step is None:
            raise RuntimeError("this Trainer was built with test_only=True: it evaluates only")
        start_epoch = self.maybe_resume()
        stats = self._existing_stats(start_epoch)
        best_key = f"eval_{self.cfg.save_best}" if self.cfg.save_best else None
        best = max(stats[best_key], default=-float("inf")) if best_key else None

        with trace_context(self.cfg.profile_dir):
            for epoch in range(start_epoch, self.cfg.num_epochs + 1):
                self._say(f"Training Epoch - {epoch}")
                self.timer.reset()
                train_loss, train_metrics = self._run_epoch(train_loader, epoch, True)
                train_tput = self.timer.throughput
                # eval_every=1 is the reference cadence; last epoch always evals.
                do_eval = epoch % self.cfg.eval_every == 0 or epoch == self.cfg.num_epochs
                if do_eval:
                    eval_loss, eval_metrics = self._run_epoch(eval_loader, epoch, False)
                    self._say(f"Training Loss - {train_loss:.4f}, Eval Loss - {eval_loss:.4f}")
                else:
                    eval_loss, eval_metrics = None, {}
                    self._say(f"Training Loss - {train_loss:.4f}")
                for k, v in train_metrics.items():
                    self._say(f"train_{k} - {v}")
                for k, v in eval_metrics.items():
                    self._say(f"eval_{k} - {v}")
                self._say(f"throughput - {train_tput:.1f} query-video pairs/s (train)")

                stats["epoch"].append(epoch)
                stats["train_loss"].append(train_loss)
                if do_eval:
                    stats["eval_loss"].append(eval_loss)
                    if self.cfg.eval_every != 1:
                        # extra alignment key (absent at the reference cadence,
                        # keeping the default stats schema identical)
                        stats["eval_epoch"].append(epoch)
                for k, v in train_metrics.items():
                    stats[f"train_{k}"].append(v)
                for k, v in eval_metrics.items():
                    stats[f"eval_{k}"].append(v)

                # Every rank holds the same stats and weights; rank 0 writes
                # them, as the JAX trainer's process 0 does.
                if self.is_main:
                    write_stats(self.stats_path, stats)
                    save_checkpoint(self.model_path, epoch, self.model, self.optimizer)
                if best_key is not None and self.cfg.save_best in eval_metrics:
                    current = eval_metrics[self.cfg.save_best]
                    if current > best:
                        best = current
                        if self.is_main:
                            save_checkpoint(self.best_model_path, epoch, self.model,
                                            self.optimizer)
                        self._say(f"new best {best_key} - {best} (epoch {epoch})")
        # No rank returns before rank 0's last checkpoint is whole on disk.
        mesh.barrier(self.group)

    def evaluate(self, loader: BatchLoader) -> Dict[str, float]:
        """Metrics-only pass over a test loader (reference main.py:193-211)."""
        self.timer.reset()
        _, metrics = self._run_epoch(loader, 0, False, step_fn=self.test_step)
        return metrics

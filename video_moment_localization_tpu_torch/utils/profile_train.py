"""Where a train step's device time goes, kernel by kernel, on a GPU.

    python -m video_moment_localization_tpu_torch.utils.profile_train \
        [--config config/charadessta.yml] [--batch 64] [--iters 5] [--seed 0] \
        [--packed false] [--compat] [--compute_dtype bfloat16] \
        [--layer-forward | --layer-backward | --unit-backward]

Builds the model of the config it is given (default: Charades,
config/charadessta.yml; config/activitynet.yml takes the content-unit route;
``--packed false`` the dense layout, ``--compat`` the reference-compat mode
``compat_head`` with ``fused_content``, ``--compute_dtype bfloat16`` the
bf16 step of any of these routes, and the bf16 layer kernels) with random seeded weights and a
seeded synthetic batch (`synthetic_batch`: random features, GT spans through
the label generators, ragged lengths, one padded sample), runs
`parallel.steps.make_train_step` under
``torch.profiler``, and prints the device time per step of each kernel, its
share, the device's busy share of the window (the time some kernel runs,
the union of their intervals, over wall time) and the peak device memory
of a step. ``--layer-forward`` profiles
the SMI layer forward (K2) alone instead: the three launches of one step's
forward; ``--layer-backward`` the SMI layer backward (K3) alone: the three
launches of one step's backward (the top layer without a dcu cotangent);
``--unit-backward`` the fused content unit of the compat mode (K10) alone:
its forward's three launches, then its backward's three. Each of these
three modes also prints the kernels' launches per call, the products'
share, and the part of a call queued back to back that no kernel covers.
They run on the carry that proposal pooling makes of random clip features
with ragged lengths, the backward on random cotangents. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Dict

import numpy as np
import torch

from video_moment_localization_tpu_torch.config import ModelConfig, load_config
from video_moment_localization_tpu_torch.data import labels
from video_moment_localization_tpu_torch.models.smin import SMIN
from video_moment_localization_tpu_torch.parallel.steps import build_optimizer, make_train_step
from video_moment_localization_tpu_torch.utils.profile_serving import (
    back_to_back_ms,
    profile_and_report,
)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def synthetic_batch(cfg: ModelConfig, B: int, rng: np.random.Generator) -> Dict[str, torch.Tensor]:
    """A train batch of B samples on the CPU: random clip and word features,
    ragged video and query lengths, a random ground-truth span per sample
    turned into targets by the label generators of data/labels.py (IoU map,
    boundary curves, snippet labels; binary labels at 0.5), and the last
    sample padded (``sample_mask`` 0). The IoU map and its labels are packed
    (B, N) where the forward's pm is (``packed`` and not ``compat_head``,
    the JAX trainer's ``packed_labels`` rule), else dense (B, L, L) beside
    the ``moment_mask`` of `labels.build_masks`."""
    T, L, Nq = cfg.T, cfg.L, cfg.max_query_length
    packed_labels = cfg.packed and not cfg.compat_head
    nfeats = rng.integers(T // 4, T + 1, size=B)
    nfeats[0] = T
    qlen = rng.integers(1, Nq + 1, size=B)
    keys = ("video_mask", "length_mask", "sm", "ss", "se", "ya")
    cols = {k: [] for k in keys + (() if packed_labels else ("moment_mask",))}
    for b in range(B):
        vm, lm, mm = labels.build_masks(int(nfeats[b]), T, L)
        duration = float(rng.uniform(5.0, 60.0))
        s = float(rng.uniform(0.0, 0.6 * duration))
        e = float(rng.uniform(s + 0.1 * duration, duration))
        ss, se = labels.boundary_penalties(s, e, duration, L)
        sm = labels.iou_target_map(s, e, duration, L)
        for k, v in (("video_mask", vm), ("length_mask", lm), ("ss", ss), ("se", se),
                     ("sm", labels.pack_triu(sm) if packed_labels else sm),
                     ("ya", labels.snippet_labels(s, e, duration, L))):
            cols[k].append(v)
        if not packed_labels:
            cols["moment_mask"].append(mm)
    batch = {k: np.stack(v) for k, v in cols.items()}
    for score, label in (("sm", "ym"), ("ss", "ys"), ("se", "ye")):
        batch[label] = (batch[score] > 0.5).astype(np.float32)
    qmask = (np.arange(Nq)[None, :] < qlen[:, None]).astype(np.float32)[..., None]
    batch["query_mask"] = qmask
    batch["video_features"] = (rng.standard_normal((B, T, cfg.input_video_dim))
                               .astype(np.float32) * batch["video_mask"])
    batch["query_features"] = rng.standard_normal((B, Nq, cfg.word_dim)).astype(np.float32) * qmask
    batch["sample_mask"] = np.ones(B, np.float32)
    batch["sample_mask"][-1] = 0.0
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def layer_backward_inputs(cfg: ModelConfig, B: int, rng: np.random.Generator):
    """One SMI layer's inputs on the card, (fc, fm, fb, fw, fs, query_mask,
    length_mask, vmask), and random cotangents (dcu, dmu, dbu), the
    activations and cotangents in the config's compute dtype."""
    from video_moment_localization_tpu_torch.ops.packing import packed_valid_mask
    from video_moment_localization_tpu_torch.ops.proposal import proposal_features_packed

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda()

    Nq = cfg.max_query_length
    qlen = torch.from_numpy(rng.integers(1, Nq + 1, size=B))
    nlen = torch.from_numpy(rng.integers(1, cfg.L + 1, size=B))
    nlen[0] = cfg.L
    qmask = (torch.arange(Nq)[None, :] < qlen[:, None]).float()[..., None].cuda()
    lmask = (torch.arange(cfg.L)[None, :] < nlen[:, None]).float().cuda()
    fc, fm, fb = proposal_features_packed(rand(B, cfg.T, cfg.D), lmask, cfg.L, cfg.C)
    ins = [t.contiguous() for t in (fc, fm, fb, rand(B, Nq, cfg.D) * qmask, rand(B, cfg.D),
                                     qmask, lmask, packed_valid_mask(lmask))]
    dtype = getattr(torch, cfg.compute_dtype)
    ins[:5] = [t.to(dtype) for t in ins[:5]]
    return ins, [rand(*t.shape).to(dtype) for t in ins[:3]]


def profile_layer_backward(model: SMIN, cfg: ModelConfig, B: int, iters: int,
                           rng: np.random.Generator) -> None:
    """K3 alone: one step's backward launches, one per layer, top first."""
    from video_moment_localization_tpu_torch.models.smin import block_weights
    from video_moment_localization_tpu_torch.ops.smin_train_cuda import (
        layer_weights_for,
        smi_layer_backward,
    )

    model = model.cuda()
    ins, (dcu, dmu, dbu) = layer_backward_inputs(cfg, B, rng)
    layers = [layer_weights_for([w.detach() for w in block_weights(block)],
                                getattr(torch, cfg.compute_dtype)) for block in model.smis]

    def backward():
        for k, weights in enumerate(reversed(layers)):
            smi_layer_backward(weights, *ins, cfg.L, None if k == 0 else dcu, dmu, dbu)

    report_alone(backward, f"K3 x{len(layers)} B={B}", "backward", iters)


def profile_layer_forward(model: SMIN, cfg: ModelConfig, B: int, iters: int,
                          rng: np.random.Generator) -> None:
    """K2 alone: one step's forward launches, one per layer."""
    from video_moment_localization_tpu_torch.models.smin import block_weights
    from video_moment_localization_tpu_torch.ops.smin_train_cuda import (
        layer_weights_for,
        smi_layer_forward,
    )

    model = model.cuda()
    ins, _ = layer_backward_inputs(cfg, B, rng)
    layers = [layer_weights_for([w.detach() for w in block_weights(block)],
                                getattr(torch, cfg.compute_dtype)) for block in model.smis]

    def forward():
        with torch.no_grad():
            for weights in layers:
                smi_layer_forward(weights, *ins, cfg.L)

    report_alone(forward, f"K2 x{len(layers)} B={B}", "forward", iters)


def profile_unit_backward(model: SMIN, cfg: ModelConfig, B: int, iters: int,
                          rng: np.random.Generator) -> None:
    """K10 alone: one compat step's forward launches, one per layer, then its
    backward launches, top layer first, on random cotangents dcu."""
    from video_moment_localization_tpu_torch.ops.content_cuda import (
        content_unit_backward,
        content_unit_forward,
        unit_weights,
    )
    from video_moment_localization_tpu_torch.ops.smin_train_cuda import layer_weights_for

    model = model.cuda()
    (fc, fm, _, fw, fs, qmask, _, vmask), (dcu, _, _) = layer_backward_inputs(cfg, B, rng)
    units = [layer_weights_for([w.detach() for w in unit_weights(block.content_unit)],
                               getattr(torch, cfg.compute_dtype)) for block in model.smis]

    def forward():
        for weights in units:
            content_unit_forward(weights, fc, fm, fw, fs, qmask, vmask)

    def backward():
        for weights in reversed(units):
            content_unit_backward(weights, fc, fm, fw, fs, qmask, vmask, dcu)

    report_alone(forward, f"K10 forward x{len(units)} B={B}", "forward", iters)
    report_alone(backward, f"K10 backward x{len(units)} B={B}", "backward", iters)


def report_alone(fn, label: str, unit: str, iters: int) -> None:
    """Warms ``fn`` up, times it back to back, then profiles it: every kernel
    with its launches per call, the products' sum and the uncovered time."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    b2b = back_to_back_ms(fn, max(iters, 10))
    profile_and_report(fn, label, unit, iters, top=64, b2b_ms=b2b)


def parse_args(argv=None) -> argparse.Namespace:
    """The command line; the three kernel modes exclude each other."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", default=os.path.join(REPO, "config", "charadessta.yml"))
    parser.add_argument("--batch", type=int, nargs="+", default=[64])
    parser.add_argument("--iters", type=int, default=5)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--packed", choices=("true", "false"), default="true",
                        help="false: the dense layout (packed: False)")
    parser.add_argument("--compat", action="store_true",
                        help="the reference-compat mode: compat_head and fused_content")
    parser.add_argument("--compute_dtype", default="float32", choices=["float32", "bfloat16"])
    alone = parser.add_mutually_exclusive_group()
    alone.add_argument("--layer-forward", action="store_true",
                       help="profile the SMI layer forward (K2) alone")
    alone.add_argument("--layer-backward", action="store_true",
                       help="profile the SMI layer backward (K3) alone")
    alone.add_argument("--unit-backward", action="store_true",
                       help="profile the fused content unit (K10) alone, forward and backward")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device visible", file=sys.stderr)
        return 1
    config = load_config(args.config)
    config.model = dataclasses.replace(
        config.model, packed=config.model.packed and args.packed == "true",
        compat_head=config.model.compat_head or args.compat,
        fused_content=config.model.fused_content or args.compat,
        compute_dtype=args.compute_dtype)
    rng = np.random.default_rng(args.seed)
    for B in args.batch:
        torch.manual_seed(args.seed)
        model = SMIN(config.model)
        if args.layer_forward:
            profile_layer_forward(model, config.model, B, args.iters, rng)
            continue
        if args.layer_backward:
            profile_layer_backward(model, config.model, B, args.iters, rng)
            continue
        if args.unit_backward:
            profile_unit_backward(model, config.model, B, args.iters, rng)
            continue
        step = make_train_step(config.model, model, build_optimizer(config, model))
        batch = {k: v.cuda() for k, v in synthetic_batch(config.model, B, rng).items()}
        torch.cuda.reset_peak_memory_stats()
        for _ in range(2):
            step(batch)
        torch.cuda.synchronize()
        print(f"{os.path.basename(args.config)} {args.compute_dtype} B={B}: peak device memory "
              f"of a step {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        profile_and_report(lambda: step(batch), f"B={B}", "train step", args.iters, top=24)
    return 0


if __name__ == "__main__":
    sys.exit(main())

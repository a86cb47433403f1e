"""Where the serving forward's device time goes, kernel by kernel, on a GPU.

    python -m video_moment_localization_tpu_torch.utils.profile_serving \
        [--batch 16 512] [--iters 10] [--seed 0] [--compute_dtype bfloat16]

Builds the Charades model (config/charadessta.yml) with random seeded
weights, runs the device part of `MomentLocalizer` (the serving forward,
the final scores and the top-5) on seeded random inputs under
``torch.profiler``, and prints for each batch size the device time per
forward of each kernel, its share, and the device's busy share of the
window (the time some kernel runs over wall time: the union of the
kernels' intervals, so that kernels on two streams at once count once;
the summed kernel time beside it). ``--compute_dtype bfloat16``
profiles bf16 serving (the bf16 variants of K5 and K4). Then K5 alone on
the inputs the forward gave it (`bilstm_fused`): its launches per call
split into the layer-1 input projections (the library's products and the
bias casts), the two recurrence launches and the layer-2 GEMM, their
device time, the time back to back and the part of it no kernel covers.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from video_moment_localization_tpu_torch.config import load_config
from video_moment_localization_tpu_torch.data.glove import WordEmbedding
from video_moment_localization_tpu_torch.inference import MomentLocalizer
from video_moment_localization_tpu_torch.models.smin import SMIN
from video_moment_localization_tpu_torch.ops import lstm_cuda

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def profile_forward(loc: MomentLocalizer, B: int, iters: int, rng) -> None:
    cfg, device = loc.cfg, loc.device
    Nq = cfg.max_query_length

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)

    vf, qf = rand(B, cfg.T, cfg.input_video_dim), rand(B, Nq, cfg.word_dim)
    vm = torch.ones((B, cfg.T, 1), device=device)
    qlen = torch.from_numpy(rng.integers(1, Nq + 1, size=B))
    qm = (torch.arange(Nq)[None, :] < qlen[:, None]).float()[..., None].to(device)
    lm = torch.ones((B, cfg.L), device=device)
    seen = k5_calls(lambda: loc._score(vf, vm, qf, qm, lm, None, 5))
    for _ in range(3):
        loc._score(vf, vm, qf, qm, lm, None, 5)
    torch.cuda.synchronize()
    profile_and_report(lambda: loc._score(vf, vm, qf, qm, lm, None, 5), f"B={B}", "forward", iters)
    x, mask, layers = seen[0]
    profile_k5(lambda: lstm_cuda.bilstm_fused(x, mask, layers), f"K5 B={B} {x.dtype}", iters)


def k5_calls(fn):
    """The (x, mask, layers) of every `bilstm_fused` call that ``fn`` makes."""
    seen, real = [], lstm_cuda.bilstm_fused

    def spy(x, mask, layers, *args, **kwargs):
        seen.append((x, mask, layers))
        return real(x, mask, layers, *args, **kwargs)

    # The wrapper counts its launches on the module's `bilstm_fused`: the
    # spy's counters while it stands there, handed back after.
    spy.launches, spy.launches_bf16 = real.launches, real.launches_bf16
    lstm_cuda.bilstm_fused = spy
    try:
        fn()
    finally:
        lstm_cuda.bilstm_fused = real
        real.launches, real.launches_bf16 = spy.launches, spy.launches_bf16
    return seen


def k5_part(key: str) -> str:
    """Which part of K5 a kernel row is: its recurrence (csrc/lstm.cu), the
    layer-2 GEMM (gemm.cuh, namespace vml) or the layer-1 projections (the
    library's products and the casts of b_ih around them)."""
    if "lstm_layer" in key:
        return "recurrence"
    if "vml::gemm" in key:
        return "layer-2 GEMM"
    return "layer-1 projections"


def profile_k5(fn, label: str, iters: int) -> None:
    """K5 alone: device ms and launches per call of each of its parts
    (`k5_part`), the time back to back and what no kernel covers."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    b2b = back_to_back_ms(fn, max(iters, 20))
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    parts = {}
    for key, count, ms in device_rows(prof.key_averages()):
        n, t = parts.get(k5_part(key), (0, 0.0))
        parts[k5_part(key)] = (n + count, t + ms)
    summed = sum(t for _, t in parts.values()) / iters
    busy = covered_ms(device_intervals(prof.events())) / iters
    print(f"{label}: device {busy:.4f} ms/call (kernels summed {summed:.4f}), back to back "
          f"{b2b:.4f} ms/call, no kernel {b2b - busy:.4f} ms")
    for part in ("layer-1 projections", "recurrence", "layer-2 GEMM"):
        n, t = parts.get(part, (0, 0.0))
        print(f"  {part}: {t / iters:.4f} ms, x{n // iters}")


def device_rows(events):
    """(name, count, ms) of each kind of work that ran on the device, from
    ``key_averages()``. A user annotation on the device's timeline (the
    span that ``torch.optim``'s ``Optimizer.step#...`` range covers there)
    is no work of its own: the kernels inside it have rows of their own,
    and the span also holds the gaps between them, so it is left out, as
    torch.profiler's own table leaves it out of its device total."""
    return [(e.key, e.count, e.self_device_time_total / 1e3) for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]


def device_intervals(events):
    """(start, end) in µs of each piece of work that ran on the device, from
    ``prof.events()``; user annotations left out, as in `device_rows`."""
    return [(e.time_range.start, e.time_range.end) for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.time_range.end > e.time_range.start
            and not getattr(e, "is_user_annotation", False)]


def covered_ms(intervals) -> float:
    """The time in ms that the union of ``intervals`` (µs) covers: the
    device's busy time, where work on two streams at once counts once."""
    total, end = 0.0, float("-inf")
    for start, stop in sorted(intervals):
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total / 1e3


def is_product(key: str) -> bool:
    """Whether a kernel row is one of the shared GEMM's (csrc/gemm.cuh): its
    product kernels and the fixed-order reduction of split-K partials."""
    return "gemm" in key or "reduce_partials" in key


def back_to_back_ms(fn, iters: int, reps: int = 3) -> float:
    """The device's time per call of ``iters`` calls queued back to back
    between two CUDA events, median of ``reps``."""
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / iters)
    return sorted(out)[len(out) // 2]


def profile_and_report(fn, label: str, unit: str, iters: int, top: int = 16,
                       b2b_ms: Optional[float] = None) -> float:
    """Run ``fn`` ``iters`` times under torch.profiler and print the device
    time per run of each kernel, its launches per run and share, the
    device's busy time (`covered_ms`) and share, and the GEMM's share
    (`is_product`). With
    ``b2b_ms``, the time of one run queued back to back (`back_to_back_ms`),
    also the part of it that no kernel covers (the gaps between dependent
    launches). Returns the busy share."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof.key_averages())
    total = sum(r[2] for r in rows)
    busy = covered_ms(device_intervals(prof.events()))
    print(f"{label}: {iters} {unit}s, wall {wall_ms / iters:.4f} ms/{unit}, device "
          f"{busy / iters:.4f} ms/{unit} (kernels summed {total / iters:.4f}), busy share "
          f"{busy / wall_ms:.3f}")
    for key, count, ms in sorted(rows, key=lambda r: -r[2])[:top]:
        print(f"  {ms / iters:9.4f} ms  {ms / total:6.1%}  x{count // iters:<4d} {key[:90]}")
    products = [r for r in rows if is_product(r[0])]
    prod_ms = sum(r[2] for r in products) / iters
    launches = sum(r[1] for r in rows) // iters
    line = (f"  split: {launches} launches/{unit}, products {prod_ms:.4f} ms "
            f"({sum(r[1] for r in products) // iters} launches), others "
            f"{total / iters - prod_ms:.4f} ms")
    if b2b_ms is not None:
        line += (f"; back to back {b2b_ms:.4f} ms/{unit}, no kernel "
                 f"{b2b_ms - busy / iters:.4f} ms")
    print(line)
    return busy / wall_ms


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, nargs="+", default=[16, 512])
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--compute_dtype", default="float32", choices=["float32", "bfloat16"])
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_serving: no CUDA device visible", file=sys.stderr)
        return 1
    cfg = load_config(os.path.join(REPO, "config", "charadessta.yml")).model
    cfg = dataclasses.replace(cfg, compute_dtype=args.compute_dtype)
    torch.manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)
    emb = WordEmbedding.synthetic(["unused"], dim=cfg.word_dim, seed=args.seed)
    for B in args.batch:
        loc = MomentLocalizer(cfg, SMIN(cfg), emb, serve_batch=B)
        profile_forward(loc, B, args.iters, rng)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where the serving forward's device time goes, kernel by kernel, on a GPU.

    python -m video_moment_localization_tpu_torch.utils.profile_serving \
        [--batch 16 512] [--iters 10] [--seed 0]

Builds the Charades model (config/charadessta.yml) with random seeded
weights, runs the device part of `MomentLocalizer` (the serving forward,
the final scores and the top-5) on seeded random inputs under
``torch.profiler``, and prints for each batch size the device time per
forward of each kernel, its share, and the device's busy share of the
window (summed kernel time over wall time). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from video_moment_localization_tpu_torch.config import load_config
from video_moment_localization_tpu_torch.data.glove import WordEmbedding
from video_moment_localization_tpu_torch.inference import MomentLocalizer
from video_moment_localization_tpu_torch.models.smin import SMIN

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
    for _ in range(3):
        loc._score(vf, vm, qf, qm, lm, 5)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            loc._score(vf, vm, qf, qm, lm, 5)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    total = sum(r[2] for r in rows)
    print(f"B={B}: {iters} forwards, wall {wall_ms / iters:.4f} ms/forward, device "
          f"{total / iters:.4f} ms/forward, busy share {total / wall_ms:.3f}")
    for key, count, ms in sorted(rows, key=lambda r: -r[2])[:16]:
        print(f"  {ms / iters:9.4f} ms  {ms / total:6.1%}  x{count // iters:<3d} {key[:90]}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, nargs="+", default=[16, 512])
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_serving: no CUDA device visible", file=sys.stderr)
        return 1
    cfg = load_config(os.path.join(REPO, "config", "charadessta.yml")).model
    torch.manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)
    emb = WordEmbedding.synthetic(["unused"], dim=cfg.word_dim, seed=args.seed)
    for B in args.batch:
        loc = MomentLocalizer(cfg, SMIN(cfg), emb, serve_batch=B)
        profile_forward(loc, B, args.iters, rng)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Times of the content-attention pair's backward on a GPU, fp32 and bf16,
back to back, each checked once against its plain version.

    python -m video_moment_localization_tpu_torch.utils.bench_pair \
        [--cells charadessta:64,activitynet:64] [--seed 0] [--launches 20]

The pair (csrc/content_attn.cuh, alone through csrc/content_attn.cu) is the
content unit between its projections; K3, K7 and K10 run its backward at
both types. Each cell is a shipped config at a batch; its inputs are the
projections of a seeded model's content unit on random carries with ragged
videos and queries (`tests`' and chip_smoke.py's recipe, fp32, then cast to
bf16 for the bf16 backward). Each backward is checked against its plain
version (fp32: rtol 5e-4 of the largest gradient; bf16: the bulk criterion
of chip_smoke.py, mean 2e-3 and p98 1e-2 of the mean magnitude) and twice
bit for bit, then timed: ``--launches`` calls between two CUDA events, the
median of 5. The bound: the bytes it must move at 3.35 TB/s (h, q, dfcc in,
dh, dq out at their types; the element's khat, fwh, fsh, masks and sums)
against its fp32 operations at 67 TFLOP/s. Prints the card's name and power
limit, the plan of each backward (pairs per pass, passes, tiles, shared
memory), one line a cell and, as the last line, one JSON object. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

import numpy as np
import torch

from video_moment_localization_tpu_torch.config import load_config
from video_moment_localization_tpu_torch.models.smin import SMIN
from video_moment_localization_tpu_torch.ops import content_attn_cuda as ca
from video_moment_localization_tpu_torch.ops.packing import packed_valid_mask
from video_moment_localization_tpu_torch.ops.proposal import proposal_features_packed
from video_moment_localization_tpu_torch.utils.bench_gemm_bf16 import card_line

PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BULK = dict(mean=2e-3, p98=1e-2, max=0.5)


def pair_inputs(cfg, B: int, seed: int):
    """(h, q, khat, fwh, fsh, query_mask, vmask) on the card, fp32."""
    rng = np.random.default_rng(seed)
    torch.manual_seed(seed)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda()

    Nq = cfg.max_query_length
    qlen = torch.from_numpy(rng.integers(1, Nq + 1, size=B))
    nlen = torch.from_numpy(rng.integers(1, cfg.L + 1, size=B))
    nlen[0] = cfg.L
    qmask = (torch.arange(Nq)[None, :] < qlen[:, None]).float()[..., None].cuda()
    lmask = (torch.arange(cfg.L)[None, :] < nlen[:, None]).float().cuda()
    fc, _, _ = proposal_features_packed(rand(B, cfg.T, cfg.D), lmask, cfg.L, cfg.C)
    vmask = packed_valid_mask(lmask).contiguous()
    unit = SMIN(cfg).cuda().smis[1].content_unit
    with torch.no_grad():
        proj = ca.unit_projections(unit, fc.contiguous(), rand(B, Nq, cfg.D) * qmask,
                                   rand(B, cfg.D), qmask, vmask)
    return [*proj, qmask, vmask]


def back_to_back_ms(fn, launches: int, reps: int = 5) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / launches)
    return statistics.median(out)


def bound_ms(cfg, B: int, bf16: bool) -> float:
    N, C, Nq, dl = cfg.L * (cfg.L + 1) // 2, cfg.C, cfg.max_query_length, cfg.dl
    rows = B * N * C
    row_bytes = (2 * 3 + 4 + 2) if bf16 else 4 * 5   # h, q, dfcc in, dh (fp32), dq out
    nbytes = row_bytes * rows * dl + 2 * 4 * B * (2 * Nq * dl + dl + Nq + N)
    flops = rows * (12 * Nq * dl + 8 * C * dl)
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS) * 1e3


def check(got, again, want, bf16: bool, name: str) -> None:
    for g, a, w, out in zip(got, again, want, ("dh", "dq", "dfwh", "dkhat", "dfsh")):
        if not torch.equal(g, a) or g.dtype != w.dtype or not bool(torch.isfinite(g).all()):
            raise SystemExit(f"bench_pair: {name} {out} differs between two launches, is not "
                             f"finite or is {g.dtype}")
        d = (g.float() - w.float()).abs().flatten()
        if bf16:
            scale = float(w.float().abs().mean()) or 1.0
            p98 = float(torch.quantile(d[:: max(1, d.numel() // 1_000_000)], 0.98))
            bad = (float(d.mean()) > BULK["mean"] * scale or p98 > BULK["p98"] * scale
                   or float(d.max()) > BULK["max"] * scale)
        else:
            bad = bool((d > 5e-4 * w.abs().flatten() + 5e-5 * float(w.abs().max())).any())
        if bad:
            raise SystemExit(f"bench_pair: {name} {out} disagrees with its plain version "
                             f"(max {float(d.max()):.3e})")


def run(cells, seed: int, launches: int):
    rows = []
    for name, B in cells:
        cfg = load_config(os.path.join(REPO, "config", f"{name}.yml")).model
        N = cfg.L * (cfg.L + 1) // 2
        ins32 = pair_inputs(cfg, B, seed)
        dfcc32 = torch.randn(ins32[0].shape, device="cuda",
                             generator=torch.Generator(device="cuda").manual_seed(seed))
        row = dict(config=name, batch=B)
        for bf16 in (False, True):
            ins = [t.to(torch.bfloat16) for t in ins32[:4]] + ins32[4:] if bf16 else ins32
            dfcc = dfcc32.to(torch.bfloat16) if bf16 else dfcc32
            got = ca.content_attn_backward(*ins, dfcc)
            again = ca.content_attn_backward(*ins, dfcc)
            check(got, again, ca.content_attn_backward_plain(*ins, dfcc), bf16,
                  f"{name} B={B} {'bf16' if bf16 else 'fp32'}")
            del got, again
            key = "bf16" if bf16 else "fp32"
            row[key] = dict(
                ms=back_to_back_ms(lambda: ca.content_attn_backward(*ins, dfcc), launches),
                bound_ms=bound_ms(cfg, B, bf16),
                plan=ca.plan(B, N, cfg.C, cfg.max_query_length, cfg.dl, True, bf16))
            row[key]["bound_share"] = row[key]["bound_ms"] / row[key]["ms"]
        rows.append(row)
        print(f"pair backward {name} B={B}: fp32 {row['fp32']['ms']:.4f} ms back to back "
              f"({row['fp32']['bound_share'] * 100:.1f} % of its bound {row['fp32']['bound_ms']:.4f};"
              f" plan {row['fp32']['plan']}), bf16 {row['bf16']['ms']:.4f} ms "
              f"({row['bf16']['bound_share'] * 100:.1f} % of its bound "
              f"{row['bf16']['bound_ms']:.4f}; plan {row['bf16']['plan']})", flush=True)
        del ins32, dfcc32
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cells", default="charadessta:64,activitynet:64")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--launches", type=int, default=20)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_pair: no CUDA device visible", file=sys.stderr)
        return 1
    cells = [(c.split(":")[0], int(c.split(":")[1])) for c in args.cells.split(",") if c]
    card = card_line()
    print(card)
    print(json.dumps({"card": card, "cells": run(cells, args.seed, args.launches)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Times of the bf16 proposal kernels on a GPU, back to back, beside one bf16
matmul with the averaging matrix.

    python -m video_moment_localization_tpu_torch.utils.bench_proposal \
        [--config config/activitynet.yml] [--batch 64] [--seed 0] [--launches 20]

At the config's map (default ActivityNet: T=128, L=64, C=4, D=512) with the
masks of a seeded synthetic batch (`profile_train.synthetic_batch`: ragged
lengths), random bf16 f and cotangents: the packed forward and backward
(K1-bf16's C entries, which K6-bf16 runs) and the dense ones (K8-bf16). Each
is checked once against its plain version, within one bf16 rounding of the
plain fp32 value on top of the fp32 tolerances of chip_smoke.py, and each
backward twice bit for bit; then each is timed back to back (``--launches``
calls between two CUDA events, the median of 5), as is the bf16
``torch.matmul`` of the dense averaging matrix Wc (forward) or its transpose
(backward) on the same data. Bounds: the bytes each must move at 3.35 TB/s
(the backward: every cotangent row of the N cells i <= j, as chip_smoke.py
counts it, and ``read_bound_ms``: only the rows of the unmasked moments,
which are all it reads). Prints the card's name and power limit and, as the
last line, one JSON object of the times (ms). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

from video_moment_localization_tpu_torch.config import load_config
from video_moment_localization_tpu_torch.ops import proposal_cuda
from video_moment_localization_tpu_torch.ops.content_matrix import content_segments
from video_moment_localization_tpu_torch.ops.packing import packed_valid_mask
from video_moment_localization_tpu_torch.utils.profile_train import synthetic_batch

PEAK_BYTES_PER_S = 3.35e12
BF16_REL = 2.0 ** -8
K1_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_RTOL, GRAD_ATOL_REL = 5e-4, 5e-5


def averaging_matrix(cfg, dense: bool) -> torch.Tensor:
    """Wc (P*C, T) on the card: the dense averaging matrix of the packed
    pairs (P = N) or of all L * L cells (zero rows below the diagonal),
    n-major."""
    seg = content_segments(cfg.T, cfg.L, cfg.C)
    cells = ([(i, j) for i in range(cfg.L) for j in range(cfg.L)] if dense
             else list(zip(*np.triu_indices(cfg.L))))
    wc = np.zeros((len(cells), cfg.C, cfg.T), np.float32)
    for n, (i, j) in enumerate(cells):
        for c in range(cfg.C):
            s0, size = seg.starts[i, j, c], seg.sizes[i, j, c]
            wc[n, c, s0:s0 + size] = seg.weights[i, j, c]
    return torch.from_numpy(wc.reshape(len(cells) * cfg.C, cfg.T)).cuda()


def back_to_back_ms(fn, launches: int, reps: int = 5) -> float:
    """Median ms per call of ``launches`` calls queued between two events."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def check_one_rounding(got, ref, name: str, tol) -> float:
    """Raise unless |got - ref| <= (2^-8 + rtol) |ref| + atol; the max error."""
    d = (got.float() - ref).abs()
    if not torch.isfinite(got.float()).all() or bool((d > (BF16_REL + tol["rtol"]) * ref.abs()
                                                      + tol["atol"]).any()):
        raise SystemExit(f"{name}: farther than one bf16 rounding from the plain version "
                         f"(max abs err {float(d.max()):.3e})")
    return float(d.max())


def bench_layout(cfg, B: int, dense: bool, lmask, mm, gen, launches: int) -> dict:
    """Check and time one layout's bf16 forward and backward."""
    T, L, C, D = cfg.T, cfg.L, cfg.C, cfg.D
    N = L * (L + 1) // 2
    bf = torch.bfloat16
    mask = mm if dense else lmask
    fwd = proposal_cuda.proposal_dense_forward if dense else proposal_cuda.proposal_rows_forward
    bwd = proposal_cuda.proposal_dense_backward if dense else proposal_cuda.proposal_rows_backward
    f = torch.randn((B, T, D), generator=gen, device="cuda").to(bf)
    got = fwd(f, mask, L, C)
    ref = (proposal_cuda.proposal_features if dense
           else proposal_cuda.proposal_features_packed)(f.float(), mask, L, C)
    err_f = max(check_one_rounding(g, r, "forward", K1_TOL) for g, r in zip(got, ref))
    cots = [torch.randn(r.shape, generator=gen, device="cuda").to(bf) for r in ref]
    del got, ref
    dgot = bwd(mask, T, L, C, *cots)
    dref = proposal_cuda.proposal_backward_plain(mask, T, L, C, *(c.float() for c in cots))
    err_b = check_one_rounding(dgot, dref, "backward", dict(
        rtol=GRAD_RTOL, atol=GRAD_ATOL_REL * float(dref.abs().max())))
    if not torch.equal(dgot, bwd(mask, T, L, C, *cots)):
        raise SystemExit("backward: two launches differ")
    del dgot, dref
    torch.cuda.empty_cache()
    P = L * L if dense else N
    unmasked = int((packed_valid_mask(lmask) != 0).sum())
    fwd_bytes = 2 * (f.numel() + B * P * (C + 1) * D + B * L * D) + 4 * mask.numel()
    bwd_bytes = 2 * (f.numel() + B * (N * C + N + L) * D) + 4 * B * N
    read_bytes = 2 * (f.numel() + unmasked * (C + 1) * D + B * L * D) + 4 * B * N
    wc = averaging_matrix(cfg, dense).to(bf)
    wct = wc.t().contiguous()
    g = cots[0].reshape(B, P * C, D)
    out = dict(
        fwd_ms=back_to_back_ms(lambda: fwd(f, mask, L, C), launches),
        fwd_matmul_ms=back_to_back_ms(lambda: torch.matmul(wc, f), launches),
        fwd_bound_ms=fwd_bytes / PEAK_BYTES_PER_S * 1e3,
        bwd_ms=back_to_back_ms(lambda: bwd(mask, T, L, C, *cots), launches),
        bwd_matmul_ms=back_to_back_ms(lambda: torch.matmul(wct, g), launches),
        bwd_bound_ms=bwd_bytes / PEAK_BYTES_PER_S * 1e3,
        read_bound_ms=read_bytes / PEAK_BYTES_PER_S * 1e3,
        unmasked=unmasked, fwd_err=err_f, bwd_err=err_b)
    del wc, wct, g, cots, f
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "config", "activitynet.yml"))
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--launches", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_proposal: no CUDA device", file=sys.stderr)
        return 1
    cfg = load_config(args.config).model
    B = args.batch
    batch = synthetic_batch(cfg, B, np.random.default_rng(args.seed))
    lmask = batch["length_mask"].float().cuda().contiguous()
    mm = packed_valid_mask(lmask)
    L = cfg.L
    i, j = np.triu_indices(L)
    dense_mm = torch.zeros((B, L, L), device="cuda")
    dense_mm[:, i, j] = mm
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0] if card.strip() else torch.cuda.get_device_name(0))
    res = {"config": os.path.basename(args.config), "batch": B,
           "device": torch.cuda.get_device_name(0)}
    for name, dense in (("packed", False), ("dense", True)):
        res[name] = bench_layout(cfg, B, dense, lmask, dense_mm.contiguous(), gen, args.launches)
        r = res[name]
        print(f"{name}: forward {r['fwd_ms']:.4f} ms (bf16 matmul {r['fwd_matmul_ms']:.4f}, "
              f"bound {r['fwd_bound_ms']:.4f}), backward {r['bwd_ms']:.4f} ms (bf16 matmul "
              f"{r['bwd_matmul_ms']:.4f}, bound {r['bwd_bound_ms']:.4f}, of the unmasked rows "
              f"{r['read_bound_ms']:.4f}); errors {r['fwd_err']:.3e} / {r['bwd_err']:.3e}")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Times of every bf16 product of K7-bf16, K4-bf16, K3-bf16 and K10-bf16 on a
GPU, on both of the bf16 GEMM's kernels, back to back, beside one bf16
``torch.matmul`` on the same operands.

    python -m video_moment_localization_tpu_torch.utils.bench_gemm_bf16 \
        [--launches 10] [--seed 0] [--quick] [--products c_hat,c_out] \
        [--kernels K3-bf16,K10b-bf16]

The products (`ops/gemm_cuda.py::model_gemm_shapes_bf16`) of K7-bf16 at the
ActivityNet config, B=64 (forward and backward, conv_fc included), of
K4-bf16 at the Charades config, B=512 and B=16, and of K3-bf16 and K10-bf16
(forward and backward) at the Charades config, B=64, each on its real epilogue
(`gemm_cuda.epilogue_bf16`: bias, row mask with its divisor, pre, post,
post32, post2, ``round_each``; bf16 or fp32 output; gemm_tn's row scale
and column sums), with random bf16 operands from ``--seed``. Each product
runs through `gemm_cuda.gemm_bf16_general` on the wgmma kernel (BF16_WG)
and the mma.sync kernel (BF16), ``--launches`` calls between two CUDA
events, the median of 3, and once more as a single call timed on the host
(the wrapper's Python and, on the wgmma kernel, the tensor maps' encoding);
the wgmma kernel's device time a call from torch.profiler beside them (at
small shapes the host's time per call, not the device's, sets the pace of
calls back to back);
``torch.matmul`` of the same bf16 operands (one call, no epilogue) is the
library yardstick. The bound: the larger of the bytes (operands read once,
output and residuals moved once, at 3.35 TB/s) and the operations (at 989
TFLOP/s). Before timing, the wgmma kernel's result is held to the mma.sync
kernel's (within one bf16 rounding, or fp32 rounding of the magnitudes).
Prints one line a product and, as the last line, one JSON object
{"card": ..., "products": [...]}. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

from video_moment_localization_tpu_torch.config import load_config
from video_moment_localization_tpu_torch.ops import gemm_cuda

PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELLS = (("K7f-bf16", "activitynet", 64), ("K7b-bf16", "activitynet", 64),
         ("K4-bf16", "charadessta", 512), ("K4-bf16", "charadessta", 16),
         ("K3-bf16", "charadessta", 64), ("K10f-bf16", "charadessta", 64),
         ("K10b-bf16", "charadessta", 64))


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi unavailable ({e})"
    return out or torch.cuda.get_device_name(0)


def product_inputs(kernel, product, layout, M, N, K, groups, gen, device):
    """(args, kwargs, bytes) of one `gemm_bf16_general` call of a product on
    its epilogue, and the bytes it must move."""
    terms, out = gemm_cuda.epilogue_bf16(kernel, product)
    bf = torch.bfloat16

    def rnd(*shape, dtype=bf):
        return torch.randn(*shape, device=device, generator=gen).to(dtype)

    C = 4   # the clip rows' divisor ("/C"): both configs have C = 4
    A = rnd(K, M) if layout == "tn" else rnd(M, K)
    W = rnd(N, K) if layout == "nt" else rnd(K, N)
    kw = {}
    nbytes = 2 * (A.numel() + groups * W.numel())
    if groups == 2:
        kw["W1"] = rnd(*W.shape)
        kw["bias1"] = rnd(N, dtype=torch.float32)
    if layout == "tn":
        if any(t.startswith("ascale") for t in terms):
            div = C if "ascale/C" in terms else 1
            kw["ascale"] = (torch.rand(-(-K // div), device=device, generator=gen) > 0.3).float()
            kw["adiv"] = div
            nbytes += 4 * kw["ascale"].numel()
        kw["bias_sums"] = "colsum" in terms
        return (layout, A, W), kw, nbytes + 4 * (M * N + (M if kw["bias_sums"] else 0))
    for t in terms:
        name, _, div = t.partition("/")
        d = C if div else 1
        if name == "bias":
            kw["bias"] = rnd(N, dtype=torch.float32)
            nbytes += 4 * N * groups
        elif name == "rmask":
            kw["rmask"] = (torch.rand(-(-M // d), device=device, generator=gen) > 0.2).float()
            kw["mask_div"] = d
            nbytes += 4 * kw["rmask"].numel()
        elif name == "pre":
            kw["pre"] = rnd(M, N, dtype=torch.float32)
            nbytes += 4 * M * N
        elif name == "post":
            kw["post"] = rnd(M, N)
            nbytes += 2 * M * N
        elif name == "post32":
            kw["post32"] = rnd(M, N, dtype=torch.float32)
            nbytes += 4 * M * N
        elif name == "post2":
            kw["post2"] = rnd(-(-M // d), N)
            kw["post2_div"] = d
            nbytes += 2 * kw["post2"].numel()
        elif name == "round_each":
            kw["round_each"] = True
    kw["out_dtype"] = torch.float32 if out == "fp32" else bf
    nbytes += groups * M * N * (4 if out == "fp32" else 2)
    return (layout, A, W), kw, nbytes


def back_to_back_ms(fn, launches: int, reps: int = 3) -> float:
    """The device's time per call of ``launches`` calls queued back to back,
    median of ``reps``."""
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


def device_ms(fn, launches: int) -> float:
    """The device time of one call, summed over every kernel it launches
    (the product and, for tn, its reduction), from torch.profiler over
    ``launches`` calls: at small shapes the host's time per call hides it
    from `back_to_back_ms`."""
    from video_moment_localization_tpu_torch.utils.profile_serving import device_rows

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    return sum(ms for _, _, ms in device_rows(prof.key_averages())) / launches


def host_us(fn, reps: int = 20) -> float:
    """Median host time of one call (its launch queued, not waited for)."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(out)


def hold(got, want, name):
    """The wgmma kernel's result against the mma.sync kernel's on the same
    inputs: bf16 outputs within one bf16 rounding (two for round_each) of
    the larger, fp32 within fp32 rounding of the magnitudes."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        d = (g - w).abs()
        tol = (2.0 ** -7 if g.dtype == torch.bfloat16 else 1e-5) * torch.maximum(g.abs(),
                                                                                   w.abs())
        tol = tol + 1e-3 * float(w.abs().mean())
        if not bool(torch.isfinite(g).all()) or not bool((d <= tol).all()):
            raise SystemExit(f"bench_gemm_bf16: {name}: the wgmma kernel differs from the "
                             f"mma.sync kernel by up to {float(d.max()):.4e}")


def library_call(layout, A, W, kw):
    """One torch.matmul of the same bf16 operands (both problems' weights
    side by side where there are two)."""
    if layout == "tn":
        At = A.t()
        return lambda: torch.matmul(At, W)
    if "W1" in kw:
        W = torch.cat([W, kw["W1"]], dim=0 if layout == "nt" else 1)
    Wt = W.t() if layout == "nt" else W
    return lambda: torch.matmul(A, Wt)


def run(launches: int, seed: int, quick: bool, products=None, kernels=None):
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(seed)
    rows, seen = [], set()
    for kernel, config, B in CELLS:
        if kernels and kernel not in kernels:
            continue
        cfg = load_config(os.path.join(REPO, "config", f"{config}.yml")).model
        for k, prod, layout, M, N, K, groups in gemm_cuda.model_gemm_shapes_bf16(cfg, B):
            if k != kernel or (quick and M * N * K < 1e9) or (products and prod not in products):
                continue
            key = (kernel[:2], prod, layout, M, N, K, groups)
            if key in seen:
                continue
            seen.add(key)
            args, kw, nbytes = product_inputs(kernel, prod, layout, M, N, K, groups, gen, device)
            calls = {path: (lambda path=path: gemm_cuda.gemm_bf16_general(*args, **kw,
                                                                           path=path))
                     for path in (gemm_cuda.BF16_WG, gemm_cuda.BF16)}
            hold(calls[gemm_cuda.BF16_WG](), calls[gemm_cuda.BF16](), f"{kernel} {prod}")
            n = max(2, min(launches, int(2e11 // max(1, M * N * K)) + 2))
            ms = {p: back_to_back_ms(fn, n) for p, fn in calls.items()}
            lib = library_call(*args, kw)
            lib_ms = back_to_back_ms(lib, n)
            host = {p: host_us(fn) for p, fn in calls.items()}
            dev = device_ms(calls[gemm_cuda.BF16_WG], n)
            flops = 2.0 * M * N * K * groups
            by_bytes, by_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_BF16_FLOPS * 1e3
            bound = max(by_bytes, by_ops)
            wg, mma = ms[gemm_cuda.BF16_WG], ms[gemm_cuda.BF16]
            row = dict(kernel=kernel, config=config, batch=B, product=prod, layout=layout, M=M,
                       N=N, K=K, groups=groups,
                       epilogue=list(gemm_cuda.epilogue_bf16(kernel, prod)[0]),
                       out=gemm_cuda.epilogue_bf16(kernel, prod)[1],
                       path=gemm_cuda.path_for(layout, M, N, K, groups, torch.bfloat16),
                       wgmma_ms=wg, mma_sync_ms=mma, matmul_ms=lib_ms, bound_ms=bound,
                       wgmma_device_ms=dev,
                       bound_by="bytes" if by_bytes >= by_ops else "operations",
                       bytes=nbytes, wgmma_share=bound / wg, mma_sync_share=bound / mma,
                       host_us_wgmma=host[gemm_cuda.BF16_WG],
                       host_us_mma_sync=host[gemm_cuda.BF16])
            rows.append(row)
            print(f"gemm bf16 {kernel} {prod} {layout} {M}x{N}x{K}x{groups} "
                  f"({config} B={B}; {'+'.join(row['epilogue']) or 'no epilogue'} -> "
                  f"{row['out']}): wgmma {wg:.4f} ms ({row['wgmma_share'] * 100:.1f} % of the "
                  f"bound), mma.sync {mma:.4f} ({row['mma_sync_share'] * 100:.1f} %), "
                  f"torch.matmul {lib_ms:.4f}, bound {bound:.4f} ({row['bound_by']}); wgmma's "
                  f"kernels {dev:.4f} ms of device time a call; host "
                  f"{row['host_us_wgmma']:.1f} / {row['host_us_mma_sync']:.1f} us a call",
                  flush=True)
            del args, kw, calls, lib
            torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--launches", type=int, default=10)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--quick", action="store_true",
                        help="only the products of at least 10^9 multiply-adds")
    parser.add_argument("--products", default="",
                        help="comma-separated product names to time (default: all)")
    parser.add_argument("--kernels", default="",
                        help="comma-separated cells of CELLS to time, by kernel (default: all)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_gemm_bf16: no CUDA device visible", file=sys.stderr)
        return 1
    card = card_line()
    print(card)
    rows = run(args.launches, args.seed, args.quick,
               [p for p in args.products.split(",") if p] or None,
               [k for k in args.kernels.split(",") if k] or None)
    print(json.dumps({"card": card, "products": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

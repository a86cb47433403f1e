#!/usr/bin/env python3
"""Run the PyTorch port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed 0]

Phases (any failed check exits non-zero; no phase's failure is caught):

1. the card's name and power limit; build every kernel of the path from
   ``video_moment_localization_tpu_torch/csrc`` with nvcc (one process per
   source, started together) and print the build time;
2. kernel parity at the full Charades width (config/charadessta.yml), at
   B=64 and at the serving run's buckets B=16 and B=8: K5 (fused biLSTM)
   and K4 (fused SMI stack) against their plain PyTorch versions on the
   card, from seeded numpy inputs;
3. the serving path: random seeded weights written as a reference-format
   checkpoint, a synthetic GloVe table, ``MomentLocalizer.from_checkpoint``
   on the card serving 24 requests (a repeated video for the grouped path,
   an out-of-vocabulary word, videos shorter and longer than T); both launch
   counters must rise, and the top-k must equal that of the same localizer
   on the CPU;
4. times from CUDA events (median after warm-up) at B=16 and B=512 for each
   kernel, its plain version, its bound and the one PyTorch call that
   computes the same function where there is one; end-to-end pairs/s.

Prints a ``{"kernels": [...]}`` line, then as the last line
``{"ok": true, "device": {...}}``. Exits non-zero without a result when no
CUDA device is visible or the package is not beside this script.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PEAK_FP32_FLOPS = 67e12      # H100 SXM, fp32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3

LSTM_SRC = "video_moment_localization_tpu_torch/csrc/lstm.cu"
STACK_SRC = "video_moment_localization_tpu_torch/csrc/smin_stack.cu"
LSTM_REPLACES = "video_moment_localization_tpu/ops/lstm_pallas.py:159"
STACK_REPLACES = "video_moment_localization_tpu/ops/smin_pallas.py:682"
K5_TOL = dict(rtol=1e-4, atol=2e-5)
K4_TOL = dict(rtol=2e-4, atol=2e-5)
SCORE_TOL = 1e-4
QUERIES = ["person opens the door", "a person sits on the couch",
           "someone takes a xylophone from the shelf", "the person closes a laptop",
           "person pours water into a cup", "a person laughs",
           "someone is eating a sandwich in the kitchen near the window", "person runs"]


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup: int = 3, iters: int = 15) -> float:
    """Median milliseconds of fn() on the card, from CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(flops: float, nbytes: float):
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ------------------------------------------------------------------------- #
def lstm_inputs(cfg, B, rng, device):
    import torch

    x = torch.from_numpy(rng.standard_normal((B, cfg.max_query_length, cfg.word_dim))
                         .astype("float32")).to(device)
    lengths = rng.integers(1, cfg.max_query_length + 1, size=B)
    lengths[0] = 1
    lengths[-1] = cfg.max_query_length
    mask = (torch.arange(cfg.max_query_length)[None, :] < torch.from_numpy(lengths)[:, None])
    return x, mask.float().to(device), lengths


def stack_inputs(cfg, B, rng, device):
    import torch

    from video_moment_localization_tpu_torch.ops.packing import packed_valid_mask

    def t(a):
        return torch.from_numpy(a.astype("float32")).to(device)

    Nq = cfg.max_query_length
    f = t(rng.standard_normal((B, cfg.T, cfg.D)))
    fw = t(rng.standard_normal((B, Nq, cfg.D)))
    fs = t(rng.standard_normal((B, cfg.D)))
    qlen = rng.integers(1, Nq + 1, size=B)
    qmask = (torch.arange(Nq)[None, :] < torch.from_numpy(qlen)[:, None]).float()[..., None]
    nlen = rng.integers(1, cfg.L + 1, size=B)
    nlen[0] = cfg.L
    lmask = (torch.arange(cfg.L)[None, :] < torch.from_numpy(nlen)[:, None]).float()
    qmask, lmask = qmask.to(device), lmask.to(device)
    return f, fw, fs, qmask, lmask, packed_valid_mask(lmask).contiguous()


def max_err(got, want, tol, name):
    import torch

    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    for g, w in zip(got, want):
        if not torch.isfinite(g).all():
            fail(f"{name}: non-finite output")
        if not torch.allclose(g, w, **tol):
            fail(f"{name}: kernel disagrees with its plain version: max abs err {err:.3e} "
                 f"(tolerance {tol})")
    return err


def stack_flops(cfg, Nq):
    """ops/smin_pallas.py:720-724 of the JAX package, per element."""
    L, C, D, dl, T = cfg.L, cfg.C, cfg.D, cfg.dl, cfg.T
    N = L * (L + 1) // 2
    NC = N * C
    return cfg.num_smi_layers * 2 * (
        NC * (2 * D * dl + dl * dl + Nq * dl * 2 + 2 * C * dl)
        + N * (2 * D * D)
        + L * (D * D + Nq * D * 2 + L * D * 2) + N * L * D * 3
    ) + 2 * NC * T * D + 2 * L * T * D


def lstm_flops(cfg):
    """ops/lstm_pallas.py:196 of the JAX package, per element, plus the
    layer-1 input projection that the wrapper computes."""
    S, H, W = cfg.max_query_length, cfg.lstm_hidden_size, cfg.word_dim
    return S * 2 * 2 * (H * 4 * H) * 2 + S * 2 * (2 * H) * 4 * H * 2 + S * 2 * W * 4 * H * 2


def param_bytes(module):
    return sum(p.numel() * 4 for p in module.parameters())


# ------------------------------------------------------------------------- #
def phase_parity(cfg, model, rng, device):
    """K5 and K4 against their plain versions at B=64 and at the serving
    run's buckets (16, and 8: below K5's 16-row cluster block). Returns the
    largest max abs error of each kernel over the sizes."""
    import torch

    from video_moment_localization_tpu_torch.models.lstm import lstm_layers
    from video_moment_localization_tpu_torch.ops import lstm_cuda, smin_cuda

    layers = lstm_layers(model.backbone.queryencoder.lstm)
    k5_err = k4_err = 0.0
    for B in (64, 16, 8):
        x, mask, _ = lstm_inputs(cfg, B, rng, device)
        got = lstm_cuda.bilstm_fused(x, mask, layers)
        want = lstm_cuda.bilstm_plain(x, mask, layers)
        torch.cuda.synchronize()
        if tuple(got.shape) != (B, cfg.max_query_length, cfg.D):
            fail(f"K5 output shape {tuple(got.shape)}")
        if bool((got[mask == 0] != 0).any()):
            fail("K5: output at a padded step is not 0")
        err = max_err([got], [want], K5_TOL, f"K5 bilstm_fused B={B}")
        print(f"parity K5 bilstm_fused B={B}: max abs err {err:.3e} (tolerance {K5_TOL})")
        k5_err = max(k5_err, err)

        ins = stack_inputs(cfg, B, rng, device)
        got = smin_cuda.smin_stack_fused(model, cfg, *ins)
        want = smin_cuda.smin_stack_plain(model, cfg, *ins)
        torch.cuda.synchronize()
        err = max_err(got, want, K4_TOL, f"K4 smin_stack_fused B={B}")
        print(f"parity K4 smin_stack_fused B={B}: max abs err {err:.3e} (tolerance {K4_TOL})")
        k4_err = max(k4_err, err)
    return k5_err, k4_err


def write_glove(path, words, dim, seed):
    from video_moment_localization_tpu_torch.data.glove import WordEmbedding

    emb = WordEmbedding.synthetic(words, dim=dim, seed=seed)
    with open(path, "w") as fh:
        for w, i in emb.stoi.items():
            fh.write(w + " " + " ".join(repr(float(v)) for v in emb.vectors[i]) + "\n")


def requests(cfg, rng):
    """24 requests: 16 on 3 videos (grouped path), 8 on distinct videos."""
    def video(n):
        return rng.standard_normal((n, cfg.input_video_dim)).astype("float32")

    shared = [video(n) for n in (20, 64, 150)]   # shorter than, equal to, longer than T
    reqs = [(shared[k % 3], QUERIES[k % len(QUERIES)], 30.0 + k) for k in range(16)]
    reqs += [(video(int(n)), QUERIES[k % len(QUERIES)], float(n) / 2.0)
             for k, n in enumerate((9, 33, 47, 64, 80, 128, 200, 17))]
    return reqs


def phase_serving(cfg, seed, rng, tmp):
    import torch

    from video_moment_localization_tpu_torch.inference import MomentLocalizer
    from video_moment_localization_tpu_torch.models.smin import SMIN
    from video_moment_localization_tpu_torch.ops import lstm_cuda, smin_cuda

    torch.manual_seed(seed)
    model = SMIN(cfg)
    ckpt_dir = os.path.join(tmp, "checkpoints")
    os.makedirs(ckpt_dir)
    torch.save({"epoch": 0, "model": model.state_dict(), "optimizer": {}},
               os.path.join(ckpt_dir, "charadessta_model.ckpt"))
    with open(os.path.join(REPO, "config", "charadessta.yml")) as fh:
        text = fh.read()
    cfg_path = os.path.join(tmp, "charadessta.yml")
    with open(cfg_path, "w") as fh:
        fh.write(text.replace('"checkpoints/"', json.dumps(ckpt_dir + "/")))
    words = sorted({w for q in QUERIES for w in q.split()} - {"xylophone"})
    glove = os.path.join(tmp, "glove.txt")
    write_glove(glove, words, cfg.word_dim, seed)

    gpu = MomentLocalizer.from_checkpoint(cfg_path, glove_path=glove, serve_batch=16)
    cpu = MomentLocalizer.from_checkpoint(cfg_path, glove_path=glove, serve_batch=16,
                                          device="cpu")
    reqs = requests(cfg, rng)
    lstm_cuda.bilstm_fused.launches = 0
    smin_cuda.smin_stack_fused.launches = 0
    out = gpu.localize_batch(reqs, top_k=5)
    torch.cuda.synchronize()
    launches = {"K5": lstm_cuda.bilstm_fused.launches,
                "K4": smin_cuda.smin_stack_fused.launches}
    print(f"serving: {len(reqs)} requests, launches {launches}")
    if min(launches.values()) < 1:
        fail(f"a kernel of the path was not launched: {launches}")
    ref = cpu.localize_batch(reqs, top_k=5)
    worst = 0.0
    for k, (g, c) in enumerate(zip(out, ref)):
        if [(m.start, m.end) for m in g] != [(m.start, m.end) for m in c]:
            fail(f"request {k}: top-k {[(m.start, m.end) for m in g]} on the card, "
                 f"{[(m.start, m.end) for m in c]} on the CPU")
        for mg, mc in zip(g, c):
            if not (0.0 <= mg.score <= 1.0):
                fail(f"request {k}: score {mg.score} outside [0, 1]")
            worst = max(worst, abs(mg.score - mc.score))
    if worst > SCORE_TOL:
        fail(f"scores differ from the CPU's by {worst:.3e} > {SCORE_TOL}")
    print(f"serving: top-k equal to the CPU localizer's; max score diff {worst:.3e} "
          f"(tolerance {SCORE_TOL})")
    return gpu, launches


def phase_times(cfg, gpu, rng):
    import torch
    from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

    from video_moment_localization_tpu_torch.models.lstm import lstm_layers
    from video_moment_localization_tpu_torch.ops import lstm_cuda, smin_cuda

    model = gpu.model
    device = gpu.device
    layers = lstm_layers(model.backbone.queryencoder.lstm)
    ref_lstm = torch.nn.LSTM(cfg.word_dim, cfg.lstm_hidden_size, num_layers=2,
                             bidirectional=True, batch_first=True)
    ref_lstm.load_state_dict(model.backbone.queryencoder.lstm.state_dict())
    ref_lstm = ref_lstm.to(device)
    stack_w = param_bytes(model.smis) + param_bytes(model.localization)
    lstm_w = param_bytes(model.backbone.queryencoder.lstm)
    Nq = cfg.max_query_length
    N = cfg.L * (cfg.L + 1) // 2
    res = {}
    for B in (16, 512):
        x, mask, lengths = lstm_inputs(cfg, B, rng, device)

        def library_lstm():
            packed = pack_padded_sequence(x, torch.from_numpy(lengths), batch_first=True,
                                          enforce_sorted=False)
            return pad_packed_sequence(ref_lstm(packed)[0], batch_first=True,
                                       total_length=Nq)[0]

        nbytes = 4 * (x.numel() + mask.numel() + B * Nq * cfg.D) + lstm_w
        b_ms, b_by = bound(B * lstm_flops(cfg), nbytes)
        res[("K5", B)] = dict(
            ms=cuda_ms(lambda: lstm_cuda.bilstm_fused(x, mask, layers)),
            plain_ms=cuda_ms(lambda: lstm_cuda.bilstm_plain(x, mask, layers)),
            library_ms=cuda_ms(library_lstm), bound_ms=b_ms, bound_by=b_by)

        ins = stack_inputs(cfg, B, rng, device)
        nbytes = 4 * sum(t.numel() for t in ins) + stack_w + 4 * B * (N + 3 * cfg.L)
        b_ms, b_by = bound(B * stack_flops(cfg, Nq), nbytes)
        res[("K4", B)] = dict(
            ms=cuda_ms(lambda: smin_cuda.smin_stack_fused(model, cfg, *ins)),
            plain_ms=cuda_ms(lambda: smin_cuda.smin_stack_plain(model, cfg, *ins)),
            library_ms=None, bound_ms=b_ms, bound_by=b_by)
        for k in ("K5", "K4"):
            r = res[(k, B)]
            print(f"time {k} B={B}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                  f"library {r['library_ms']} ms, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']})")

        # End to end on the device: the serving forward, scores and top-k.
        vf = torch.from_numpy(rng.standard_normal((B, cfg.T, cfg.input_video_dim))
                              .astype("float32")).to(device)
        vm = torch.ones((B, cfg.T, 1), device=device)
        qf = torch.from_numpy(rng.standard_normal((B, Nq, cfg.word_dim))
                              .astype("float32")).to(device)
        qm = mask[..., None].contiguous()
        lm = torch.ones((B, cfg.L), device=device)
        fwd_ms = cuda_ms(lambda: gpu._score(vf, vm, qf, qm, lm, 5))
        print(f"time serving forward + top-5 B={B}: {fwd_ms:.4f} ms, "
              f"{B / fwd_ms * 1e3:.1f} pairs/s on the device")
        res[("e2e", B)] = fwd_ms

    reqs = [(rng.standard_normal((int(n), cfg.input_video_dim)).astype("float32"),
             QUERIES[k % len(QUERIES)], 30.0) for k, n in
            enumerate(rng.integers(20, 200, size=512))]
    gpu.localize_batch(reqs[:32], top_k=5)
    t0 = time.perf_counter()
    gpu.localize_batch(reqs, top_k=5)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"time localize_batch 512 requests, serve_batch 16: {wall:.4f} s, "
          f"{len(reqs) / wall:.1f} pairs/s with host featurization")
    return res


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        from video_moment_localization_tpu_torch.config import load_config
        from video_moment_localization_tpu_torch.models.smin import SMIN
        from video_moment_localization_tpu_torch.ops.cuda_build import BUILD_DIR, build
    except ImportError as e:
        print(f"chip_smoke: the port package is not beside this script ({e})",
              file=sys.stderr)
        return 1
    import numpy as np

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)   # serving: the plain versions time without autograd
    device = torch.device("cuda")
    print(card_line())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    build(["lstm", "smin_stack"])
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc, sm_90a, both sources in parallel)")
    for name in ("lstm", "smin_stack"):
        with open(os.path.join(BUILD_DIR, f"{name}.log")) as fh:
            for line in fh:
                if "Used" in line or "spill" in line:
                    print(f"ptxas {name}: {line.strip()}")

    cfg = load_config(os.path.join(REPO, "config", "charadessta.yml")).model
    rng = np.random.default_rng(args.seed)
    torch.manual_seed(args.seed)
    model = SMIN(cfg).to(device).eval()
    k5_err, k4_err = phase_parity(cfg, model, rng, device)

    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as tmp:
        gpu, launches = phase_serving(cfg, args.seed, rng, tmp)
    times = phase_times(cfg, gpu, rng)

    kernels = []
    for key, name, src, rep, err in (
            ("K5", "bilstm_fused", LSTM_SRC, LSTM_REPLACES, k5_err),
            ("K4", "smin_stack_fused", STACK_SRC, STACK_REPLACES, k4_err)):
        r16, r512 = times[(key, 16)], times[(key, 512)]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[key], "max_abs_err": err,
            "ms": r16["ms"], "plain_ms": r16["plain_ms"], "bound_ms": r16["bound_ms"],
            "bound_by": r16["bound_by"], "library_ms": r16["library_ms"],
            "batch": 16,
            "ms_b512": r512["ms"], "plain_ms_b512": r512["plain_ms"],
            "bound_ms_b512": r512["bound_ms"], "bound_by_b512": r512["bound_by"],
            "library_ms_b512": r512["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"serving_pairs_per_s_device": {
        str(B): B / times[("e2e", B)] * 1e3 for B in (16, 512)}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

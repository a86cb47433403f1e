"""Times of the SMI layer and content-unit training kernels and of the
serving stack on a GPU, back to back, at the cells a training step or a
serving batch gives them.

    python -m video_moment_localization_tpu_torch.utils.bench_kernels \
        [--only K3-bf16,K10b-bf16] [--seed 0] [--launches 10]

Each row is one kernel at one cell, with random seeded weights and inputs
(`profile_train.layer_backward_inputs`: the carry that proposal pooling
makes of random clip features with ragged lengths, random cotangents; fbar
the moment gate of the carry's fm), timed as ``--launches`` calls queued
between two CUDA events, the median of 5, on a workspace kept across calls
where the wrapper takes one:

* K2, K3 (with a dcu cotangent) and K9 (three layers) at both types, K10
  and K10-bf16 forward and backward: the Charades config at B=64;
* K7 and K7-bf16 forward and backward: the ActivityNet config at B=64;
* K4 and K4-bf16: the Charades config at B=512 (bf16 serving's batch), and
  K4-bf16 at B=16 (row K4-bf16-B16);
* K5-bf16 and K5 (`bilstm_fused`, the layer-1 projections included) at the
  Charades config, B=16 and B=512 (rows K5-bf16-B16, ..., K5-B512): half-scale
  word features, ragged query lengths, as the serving forward calls it.

It only calls the kernels' public wrappers, so one copy of it times two
trees of the port alike. Prints the card's name and power limit, one line
a kernel and, as the last line, one JSON object {"card": ..., "ms":
{kernel: ms}}. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys

import numpy as np
import torch

from video_moment_localization_tpu_torch.config import load_config
from video_moment_localization_tpu_torch.models.smin import SMIN, block_weights
from video_moment_localization_tpu_torch.utils.bench_gemm_bf16 import card_line
from video_moment_localization_tpu_torch.utils.profile_train import layer_backward_inputs

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
KERNELS = ("K2-bf16", "K3-bf16", "K9-bf16", "K2", "K3", "K9", "K10f", "K10b", "K10f-bf16",
           "K10b-bf16", "K7f", "K7b", "K7f-bf16", "K7b-bf16", "K4-bf16", "K4", "K4-bf16-B16",
           "K5-bf16-B16", "K5-bf16-B512", "K5-B16", "K5-B512")


def back_to_back_ms(fn, launches: int, reps: int = 5) -> float:
    for _ in range(2):
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


def _config(name: str, dtype: str):
    cfg = load_config(os.path.join(REPO, "config", f"{name}.yml")).model
    return dataclasses.replace(cfg, compute_dtype=dtype)


def layer_calls(dtype: str, seed: int):
    """{kernel: fn} of K2, K3, K9 and K10 at the Charades config, B=64."""
    from video_moment_localization_tpu_torch.ops import content_cuda, smin_train_cuda
    from video_moment_localization_tpu_torch.ops.content_train_cuda import Workspace

    cfg = _config("charadessta", dtype)
    dt = getattr(torch, dtype)
    torch.manual_seed(seed)
    model = SMIN(cfg).cuda()
    ins, (dcu, dmu, dbu) = layer_backward_inputs(cfg, 64, np.random.default_rng(seed))
    weights = smin_train_cuda.layer_weights_for([w.detach() for w in block_weights(model.smis[1])],
                                                dt)
    stack = []
    for block in model.smis:
        stack += smin_train_cuda.layer_weights_for([w.detach() for w in block_weights(block)], dt)
    uw = smin_train_cuda.layer_weights_for(
        [w.detach() for w in content_cuda.unit_weights(model.smis[1].content_unit)], dt)
    fc, fm, _, fw, fs, qmask, _, vmask = ins
    uins = (fc, fm, fw, fs, qmask, vmask)
    ws = Workspace()
    sfx = "-bf16" if dtype == "bfloat16" else ""
    L = cfg.L
    calls = {
        f"K2{sfx}": lambda: smin_train_cuda.smi_layer_forward(weights, *ins, L),
        f"K3{sfx}": lambda: smin_train_cuda.smi_layer_backward(weights, *ins, L, dcu, dmu, dbu),
        f"K9{sfx}": lambda: smin_train_cuda.smi_stack_forward(stack, *ins, L),
        f"K10f{sfx}": lambda: content_cuda.content_unit_forward(uw, *uins, ws),
        f"K10b{sfx}": lambda: content_cuda.content_unit_backward(uw, *uins, dcu, ws),
    }
    return calls


def rows_calls(dtype: str, seed: int):
    """{kernel: fn} of K7's forward and backward at the ActivityNet config,
    B=64."""
    from video_moment_localization_tpu_torch.models.smin import moment_gate
    from video_moment_localization_tpu_torch.ops import content_train_cuda
    from video_moment_localization_tpu_torch.ops.smin_train_cuda import layer_weights_for

    cfg = _config("activitynet", dtype)
    dt = getattr(torch, dtype)
    torch.manual_seed(seed)
    model = SMIN(cfg).cuda()
    ins, (dcu, _, _) = layer_backward_inputs(cfg, 64, np.random.default_rng(seed))
    fc, fm, _, fw, fs, qmask, _, vmask = ins
    with torch.no_grad():
        fbar = moment_gate(fm.float(), fs.float()).to(dt).contiguous()
    weights = layer_weights_for(
        [w.detach() for w in content_train_cuda.content_weights(model.smis[1])], dt)
    rins = (fc, fbar, fw, fs, qmask, vmask)
    dconv = torch.randn(fbar.shape, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(seed)).to(dt)
    ws = content_train_cuda.Workspace()
    sfx = "-bf16" if dtype == "bfloat16" else ""
    return {
        f"K7f{sfx}": lambda: content_train_cuda.content_rows_forward(weights, *rins, ws),
        f"K7b{sfx}": lambda: content_train_cuda.content_rows_backward(weights, *rins, dcu, dconv,
                                                                       ws),
    }


def serving_call(seed: int, dtype: str = "bfloat16", B: int = 512):
    """K4 or K4-bf16 at the Charades config, B=512 (or B)."""
    from video_moment_localization_tpu_torch.ops import smin_cuda
    from video_moment_localization_tpu_torch.ops.packing import packed_valid_mask

    cfg = _config("charadessta", dtype)
    dt = getattr(torch, dtype)
    torch.manual_seed(seed)
    model = SMIN(cfg).cuda().eval()
    g = torch.Generator(device="cuda").manual_seed(seed)
    Nq = cfg.max_query_length
    qlen = torch.randint(1, Nq + 1, (B,), device="cuda", generator=g)
    qmask = (torch.arange(Nq, device="cuda")[None, :] < qlen[:, None]).float()[..., None]
    lmask = torch.ones(B, cfg.L, device="cuda")
    f = torch.randn(B, cfg.T, cfg.D, device="cuda", generator=g).to(dt)
    fw = (torch.randn(B, Nq, cfg.D, device="cuda", generator=g) * qmask).to(dt)
    fs = torch.randn(B, cfg.D, device="cuda", generator=g).to(dt)
    ins = (f, fw, fs, qmask, lmask, packed_valid_mask(lmask).contiguous())

    def call():
        with torch.no_grad():
            smin_cuda.smin_stack_fused(model, cfg, *ins)

    name = "K4-bf16" if dtype == "bfloat16" else "K4"
    return {name if B == 512 else f"{name}-B{B}": call}


def lstm_calls(seed: int):
    """{kernel: fn} of K5 and K5-bf16 at the Charades config, B=16 and 512."""
    from video_moment_localization_tpu_torch.models.lstm import lstm_layers
    from video_moment_localization_tpu_torch.models.smin import cast_weights
    from video_moment_localization_tpu_torch.ops import lstm_cuda

    cfg = _config("charadessta", "float32")
    torch.manual_seed(seed)
    lstm = SMIN(cfg).cuda().eval().backbone.queryencoder.lstm
    g = torch.Generator(device="cuda").manual_seed(seed)
    calls = {}
    for dtype, sfx in ((torch.bfloat16, "-bf16"), (torch.float32, "")):
        layers = lstm_layers(lstm, cast_weights(lstm, dtype) if dtype != torch.float32 else None)
        for B in (16, 512):
            Nq = cfg.max_query_length
            x = (torch.randn(B, Nq, cfg.word_dim, device="cuda", generator=g) * 0.5).to(dtype)
            qlen = torch.randint(1, Nq + 1, (B,), device="cuda", generator=g)
            mask = (torch.arange(Nq, device="cuda")[None, :] < qlen[:, None]).float()
            def call(x=x, mask=mask, layers=layers):
                with torch.no_grad():
                    lstm_cuda.bilstm_fused(x, mask, layers)

            calls[f"K5{sfx}-B{B}"] = call
    return calls


def run(only, seed: int, launches: int):
    ms = {}
    groups = (lambda: layer_calls("bfloat16", seed), lambda: layer_calls("float32", seed),
              lambda: rows_calls("bfloat16", seed), lambda: rows_calls("float32", seed),
              lambda: serving_call(seed), lambda: serving_call(seed, "float32"),
              lambda: serving_call(seed, B=16),
              lambda: lstm_calls(seed))
    for make in groups:
        calls = {k: fn for k, fn in make().items() if k in KERNELS and (not only or k in only)}
        for k, fn in calls.items():
            ms[k] = back_to_back_ms(fn, launches)
            print(f"kernel {k}: {ms[k]:.4f} ms back to back", flush=True)
        del calls
        torch.cuda.empty_cache()
    return ms


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", default="", help="comma-separated kernels of KERNELS")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--launches", type=int, default=10)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_kernels: no CUDA device visible", file=sys.stderr)
        return 1
    only = {k for k in args.only.split(",") if k}
    card = card_line()
    print(card)
    print(json.dumps({"card": card, "ms": run(only, args.seed, args.launches)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

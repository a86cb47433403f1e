"""Training: the program's ``make_train_step`` over a pool of batches on the card.

Set-up builds one train step (model, Adam at the configuration's ``lr``)
from the seed's weights and drives it through its first three steps on
three distinct batches of the pool: those are the steps the reference
follows (each loss, the first gradient as Adam's state holds it after one
step, the parameters' change after three). The window goes on with the
same object over the pool's batches in turn and ends in
``torch.cuda.synchronize()``; ``samples_per_s`` is the valid samples of
the steps completed over the window.
"""

from __future__ import annotations

import time

import torch

from h100_bench.counts import flops as counts
from h100_bench.lib import checks, program, traffic
from h100_bench.lib.harness import Record
from h100_bench.reference import train as ref_train

from video_moment_localization_tpu_torch.parallel.steps import build_optimizer, make_train_step

CHECKED_STEPS = 3
BETA1 = 0.9


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def setup(ctx):
    conf = program.config(ctx.cfg)
    program.build_kernels(ctx.device)
    batches = traffic.train_batches(ctx.workload["traffic"], ctx.cfg, ctx.seed, ctx.device)
    if len(batches) <= CHECKED_STEPS:
        raise ValueError(f"the pool needs more than {CHECKED_STEPS} batches")
    model = program.model(conf, ctx.weights, ctx.device)
    opt = build_optimizer(conf, model)
    step = make_train_step(conf.model, model, opt, device=ctx.device)
    name_of = {id(p): n for n, p in model.named_parameters()}
    losses, first_grad = [], None
    for k in range(CHECKED_STEPS):
        losses.append(float(step(batches[k])["loss"]))
        if first_grad is None:
            first_grad = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
            for p, st in opt.state.items():
                if "exp_avg" in st:
                    first_grad[name_of[id(p)]] = st["exp_avg"].detach() / (1 - BETA1)
    params = dict(model.named_parameters())
    change = {n: params[n].detach() - ctx.weights[n] for n in params}
    _sync(ctx.device)
    valid = [float(b["sample_mask"].sum()) for b in batches]
    return {"step": step, "model": model, "opt": opt, "batches": batches, "valid": valid,
            "program": (losses, first_grad, change), "lr": conf.lr}


def window(ctx, state, seconds, tracer) -> Record:
    step, batches, valid = state["step"], state["batches"], state["valid"]
    k, steps, samples = CHECKED_STEPS, 0, 0.0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        with tracer.span("step"):
            step(batches[k % len(batches)])
        samples += valid[k % len(batches)]
        k += 1
        steps += 1
    with tracer.span("synchronize"):
        _sync(ctx.device)
    window_s = time.perf_counter() - t0
    return Record(e2e={"samples_per_s": samples / window_s}, attempted=steps, failed=0,
                  units=int(samples), flops=counts.train_step_flops(ctx.cfg, int(samples)),
                  nbytes=counts.train_bytes(ctx.cfg, int(samples), steps), steps=steps,
                  window_s=window_s)


def reference(ctx, state, half_batch: bool = False, tf32: bool = False):
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        return ref_train.run_steps(ctx.weights, ctx.cfg, state["batches"][:CHECKED_STEPS],
                                   state["lr"], ctx.workload["check"]["block"], half_batch)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def check(ctx, state, record):
    program.free(state, "step", "model", "opt")
    state["reference"] = reference(ctx, state)
    return checks.training_gaps(state["program"], state["reference"])


def control(ctx, state, record):
    """The control (the reference in TF32) and the half-batch fault planted
    in the reference, each held to the reference."""
    return {"tf32": checks.training_gaps(reference(ctx, state, tf32=True), state["reference"]),
            "half_batch": checks.training_gaps(reference(ctx, state, half_batch=True),
                                               state["reference"])}

"""Closed loop over a backlog: ``MomentLocalizer.localize_batch`` on chunks.

The cell's traffic is a cycle of ``cycle_chunks`` chunks of
``chunk.videos`` distinct videos with ``chunk.queries_per_video`` queries
each (with ``chunk.video_key`` the rows of a video share a key, so that
``dispatch`` featurizes and encodes each video once). The window hands the
whole cycle to ``localize_batch`` (``max_in_flight`` chunks on the device
while the host featurizes the next) again and again, and ends when the
answers of the pass running at ``--seconds`` are collected. ``pairs_per_s``
is every pair answered over the whole window.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from h100_bench.counts import flops as counts
from h100_bench.lib import program, serving, traffic
from h100_bench.lib.harness import Record

WARM_CHUNKS = 4


def setup(ctx):
    pool = serving.pool(ctx)
    requests = [r for chunk in traffic.chunks(ctx.workload["traffic"], pool) for r in chunk]
    loc = serving.localizer(ctx, pool)
    lc, chunk = ctx.workload["localizer"], ctx.workload["traffic"]["chunk"]
    if chunk["videos"] * chunk["queries_per_video"] != lc["serve_batch"]:
        raise ValueError("a chunk's rows must fill serve_batch, so that each of "
                         "localize_batch's chunks is one of the mix's")
    # The cycle's one shape (a full chunk), with as many chunks in flight as
    # the window keeps, so that the allocators hold their blocks.
    warm = requests[: WARM_CHUNKS * lc["serve_batch"]]
    loc.localize_batch(warm, top_k=lc["top_k"], max_in_flight=lc["max_in_flight"])
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    keep = serving.sample(requests, ctx.workload["check"]["sample"], pool["rng"])
    return {"loc": loc, "requests": requests, "keep": keep, "pool": pool}


def window(ctx, state, seconds, tracer) -> Record:
    loc, requests, keep = state["loc"], state["requests"], state["keep"]
    lc = ctx.workload["localizer"]
    dispatch, collect = loc.dispatch, loc.collect

    def traced_dispatch(chunk, top_k=5):
        with tracer.span("dispatch"):
            return dispatch(chunk, top_k)

    def traced_collect(handle):
        with tracer.span("collect"):
            return collect(handle)

    loc.dispatch, loc.collect = traced_dispatch, traced_collect
    kept, passes, marks = [], 0, []
    t0 = time.perf_counter()
    try:
        while True:
            answers = loc.localize_batch(requests, top_k=lc["top_k"],
                                         max_in_flight=lc["max_in_flight"])
            passes += 1
            kept.append([answers[k] for k in keep])
            marks.append(time.perf_counter())
            if marks[-1] - t0 >= seconds:
                break
    finally:
        loc.dispatch, loc.collect = dispatch, collect
    window_s = time.perf_counter() - t0
    laps = np.diff([t0] + marks)
    print(f"passes of {len(requests)} pairs: {passes}, s each: min {laps.min():.4f} median "
          f"{np.median(laps):.4f} max {laps.max():.4f}", file=sys.stderr)
    state["kept"] = kept
    pairs = passes * len(requests)
    chunk = ctx.workload["traffic"]["chunk"]
    per_chunk = chunk["videos"] * chunk["queries_per_video"]
    chunks = pairs // per_chunk
    videos = chunks * chunk["videos"]
    return Record(e2e={"pairs_per_s": pairs / window_s}, attempted=pairs, failed=0, units=pairs,
                  flops=counts.forward_flops(ctx.cfg, pairs, videos),
                  nbytes=counts.serve_bytes(ctx.cfg, pairs, videos, chunks, lc["top_k"]),
                  steps=chunks, window_s=window_s)


def check(ctx, state, record):
    program.free(state, "loc")
    pool = state["pool"]
    requests = [state["requests"][k] for k in state["keep"]]
    return serving.gaps(ctx, requests, state["kept"], pool["words"], pool["vectors"])


def control(ctx, state, record):
    pool = state["pool"]
    requests = [state["requests"][k] for k in state["keep"]]
    return {"tf32": serving.control(ctx, requests, pool["words"], pool["vectors"])}

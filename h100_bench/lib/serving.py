"""What the serving drivers share: the localizer, the sample, the reference check."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from h100_bench.lib import checks, program, traffic
from h100_bench.reference import featurize, smin as ref_smin

from video_moment_localization_tpu_torch.inference import MomentLocalizer


def localizer(ctx, pool) -> MomentLocalizer:
    """The program's localizer over the seed's weights and word table."""
    conf = program.config(ctx.cfg)
    program.build_kernels(ctx.device)
    loc_cfg = ctx.workload["localizer"]
    return MomentLocalizer(conf.model, program.model(conf, ctx.weights, ctx.device),
                           program.embedding(pool["words"], pool["vectors"]),
                           serve_batch=loc_cfg["serve_batch"], use_nms=False,
                           device=ctx.device)


def pool(ctx) -> Dict:
    tr = dict(ctx.workload["traffic"], vocab=ctx.cfg["vocab_size"])
    return traffic.serving_pool(tr, ctx.cfg, ctx.seed, ctx.device)


def sample(requests: Sequence[tuple], n: int, rng: np.random.Generator) -> List[int]:
    """``n`` request positions drawn from ``rng``, with the longest video
    and the longest query among them."""
    longest = {int(np.argmax([r[0].shape[0] for r in requests])),
               int(np.argmax([len(r[1].split()) for r in requests]))}
    rest = rng.choice(len(requests), size=min(n, len(requests)), replace=False)
    return sorted(longest | {int(k) for k in rest[: max(0, n - len(longest))]})


def reference_scores(ctx, requests: Sequence[tuple], words, vectors, tf32: bool = False
                     ) -> np.ndarray:
    """(R, N) reference scores of ``requests``, worked out from the raw
    features, query strings and word table; products in fp32 (or TF32 for
    the control)."""
    cfg = ctx.cfg
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        inputs = featurize.featurize(requests, {w: i for i, w in enumerate(words)}, vectors,
                                     cfg["T"], cfg["L"], cfg["max_query_length"])
        return ref_smin.score_requests(ctx.weights, cfg, inputs, ctx.device,
                                       ctx.workload["check"]["block"]).numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def gaps(ctx, requests, answers: List[List], words, vectors) -> Dict[str, float]:
    """The served answers to ``requests`` (one list of answers per window
    pass over them) held to the reference."""
    L, k = ctx.cfg["L"], ctx.workload["localizer"]["top_k"]
    ref = reference_scores(ctx, requests, words, vectors)
    durations = [r[2] for r in requests]
    worst = {"rank_gap": 0.0, "score_gap": 0.0}
    for passed in answers:
        idx, val = checks.answers_to_arrays(passed, durations, L, k)
        for name, v in checks.serving_gaps(ref, idx, val).items():
            worst[name] = max(worst[name], v)
    return worst


def control(ctx, requests, words, vectors) -> Dict[str, float]:
    """The control's readings: the reference in TF32 put in the program's
    place, its top-k held to the fp32 reference."""
    ref = reference_scores(ctx, requests, words, vectors)
    low = reference_scores(ctx, requests, words, vectors, tf32=True)
    k = ctx.workload["localizer"]["top_k"]
    t = torch.from_numpy(low).sort(dim=1, descending=True, stable=True)
    idx, val = t.indices[:, :k].numpy(), t.values[:, :k].numpy().astype(np.float64)
    return checks.serving_gaps(ref, idx, val)

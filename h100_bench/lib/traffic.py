"""The one general generator of the benchmark's traffic, from a mix's parameters.

Every seed gets the same multiset of sizes (clip counts, query lengths,
durations), each drawn as an evenly spaced set and put in an order drawn
from the seed, so that seeds change which request carries which size and
what the data holds, never how much work there is. Feature
values are made on the device in one call per pool and copied to the host
in bulk, since the program's serving entry takes host arrays.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from h100_bench.reference import labels


def streams(seed: int, device) -> Tuple[np.random.Generator, torch.Generator]:
    """The seed's host and device random streams."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (2 ** 63))
    return np.random.default_rng(seed % (2 ** 64)), gen


def spread(lo: float, hi: float, n: int, rng: np.random.Generator, integer: bool = True):
    """n values evenly spaced over [lo, hi], in an order drawn from ``rng``."""
    vals = np.linspace(lo, hi, n)
    vals = np.round(vals).astype(np.int64) if integer else vals
    return vals[rng.permutation(n)]


def vocabulary(size: int, dim: int, gen: torch.Generator, device) -> Tuple[List[str], np.ndarray]:
    """``size`` distinct words and a (size, dim) table of word vectors."""
    words = [f"w{k}x" for k in range(size)]
    vectors = torch.randn(size, dim, generator=gen, device=device).cpu().numpy()
    return words, vectors


def video_pool(n: int, clips: Tuple[int, int], dv: int, rng, gen, device) -> List[np.ndarray]:
    """n arrays of clip features (nfeats, dv), nfeats spread over ``clips``;
    one device call for all of them, views of one host buffer."""
    sizes = spread(clips[0], clips[1], n, rng)
    flat = torch.rand(int(sizes.sum()), dv, generator=gen, device=device).cpu().numpy()
    ends = np.cumsum(sizes)
    return [flat[e - s:e] for s, e in zip(sizes, ends)]


def queries(n: int, words: Tuple[int, int], vocab: List[str], rng) -> List[str]:
    """n queries of a length spread over ``words``, each word from ``vocab``."""
    lengths = spread(words[0], words[1], n, rng)
    picks = rng.integers(0, len(vocab), size=int(lengths.sum()))
    out, k = [], 0
    for m in lengths:
        out.append(" ".join(vocab[i] for i in picks[k:k + m]))
        k += m
    return out


def serving_pool(traffic: Dict, cfg: Dict, seed: int, device) -> Dict:
    """The videos, their durations and the vocabulary of a serving mix."""
    rng, gen = streams(seed, device)
    words, vectors = vocabulary(traffic["vocab"], cfg["word_dim"], gen, device)
    v = traffic["videos"]
    videos = video_pool(v["pool"], tuple(v["clips"]), cfg["input_video_dim"], rng, gen, device)
    durations = spread(*traffic["duration_s"], v["pool"], rng, integer=False)
    return {"rng": rng, "words": words, "vectors": vectors, "videos": videos,
            "durations": durations}


def chunks(traffic: Dict, pool: Dict) -> List[List[tuple]]:
    """The closed loop's backlog: ``cycle_chunks`` chunks of ``videos``
    distinct videos with ``queries_per_video`` queries each, a video's rows
    sharing a ``video_key`` where the mix asks for one."""
    rng, videos = pool["rng"], pool["videos"]
    c = traffic["chunk"]
    nv, nq, n_chunks = c["videos"], c["queries_per_video"], traffic["cycle_chunks"]
    if nv > len(videos):
        raise ValueError(f"a chunk of {nv} distinct videos needs a pool of at least {nv}")
    qs = queries(n_chunks * nv * nq, tuple(traffic["query_words"]), pool["words"], rng)
    order = rng.permutation(len(videos))
    out, k = [], 0
    for ch in range(n_chunks):
        start = (ch * nv) % len(videos)
        pick = np.take(order, np.arange(start, start + nv), mode="wrap")
        rows = []
        for v in pick:
            for _ in range(nq):
                row = (videos[v], qs[k], float(pool["durations"][v]))
                rows.append(row + (int(v),) if c.get("video_key") else row)
                k += 1
        out.append(rows)
    return out


def train_batches(traffic: Dict, cfg: Dict, seed: int, device) -> List[Dict[str, torch.Tensor]]:
    """``pool`` batches of ``batch`` samples on the device: random clip and
    word features, video lengths spread over [T/4, T] (each batch's first at
    T), query lengths over [1, Nq], a ground-truth span per sample turned
    into packed targets, and the last ``padded`` samples of each batch
    padded (``sample_mask`` 0)."""
    rng, gen = streams(seed, device)
    T, L, Nq = cfg["T"], cfg["L"], cfg["max_query_length"]
    n_b, B = traffic["pool"], traffic["batch"]
    nfeats = spread(T // 4, T, n_b * B, rng).reshape(n_b, B)
    nfeats[:, 0] = T
    qlen = spread(1, Nq, n_b * B, rng).reshape(n_b, B)
    vfeat = torch.randn(n_b, B, T, cfg["input_video_dim"], generator=gen, device=device)
    qfeat = torch.randn(n_b, B, Nq, cfg["word_dim"], generator=gen, device=device)
    out = []
    for k in range(n_b):
        cols = {c: [] for c in ("video_mask", "length_mask", "sm", "ss", "se", "ya")}
        for b in range(B):
            vm, lm = labels.masks(int(nfeats[k, b]), T, L)
            dur = float(rng.uniform(*traffic["duration_s"]))
            s = float(rng.uniform(0.0, 0.6 * dur))
            e = float(rng.uniform(s + 0.1 * dur, dur))
            ss, se = labels.boundary_curves(s, e, dur, L)
            for c, v in (("video_mask", vm), ("length_mask", lm), ("ss", ss), ("se", se),
                         ("sm", labels.upper(labels.iou_map(s, e, dur, L))),
                         ("ya", labels.snippet_inside(s, e, dur, L))):
                cols[c].append(v)
        batch = {c: np.stack(v) for c, v in cols.items()}
        for score, label in (("sm", "ym"), ("ss", "ys"), ("se", "ye")):
            batch[label] = (batch[score] > 0.5).astype(np.float32)
        batch["query_mask"] = (np.arange(Nq)[None, :] < qlen[k][:, None]).astype(np.float32)[..., None]
        batch["sample_mask"] = np.ones(B, np.float32)
        batch["sample_mask"][B - traffic["padded"]:] = 0.0
        t = {c: torch.from_numpy(v).to(device) for c, v in batch.items()}
        t["video_features"] = vfeat[k] * t["video_mask"]
        t["query_features"] = qfeat[k] * t["query_mask"]
        out.append(t)
    return out

"""The comparisons that decide ``correct``: the program's outputs against the reference's.

Serving: each served top-k answer is read back as the pairs it names (from
each Moment's start and end) and its scores, and held to the reference's
scores of that request. ``rank_gap``: the widest by which a served pair's
reference score lies below the reference's own score at that rank (0 when
the program ranks as the reference does, small on near ties).
``score_gap``: the widest difference between a served score and the
reference's score of the same pair. Both in score units (scores lie in
[0, 1]); an answer that names no valid pair reads the full reference score.

Training: the three checked steps' losses, the first gradient and the
parameters' change after three steps, each as the worst leaf's gap of
norms (|norm(program) - norm(reference)|) over the larger of the
reference's norm of that leaf and of the median leaf. Leaves whose
reference gradient is under a thousandth of the median leaf's move under
Adam by rounding alone and are left out of the change.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def pair_of(start: float, end: float, duration: float, L: int) -> int:
    """The packed (row-major upper-triangle) index of the pair that a
    moment [start, end] of a ``duration`` video names, or -1."""
    i = int(round(start * L / duration))
    j = int(round(end * L / duration)) - 1
    if not (0 <= i <= j < L):
        return -1
    return i * L - i * (i - 1) // 2 + (j - i)


def answers_to_arrays(answers: Sequence[Sequence], durations: Sequence[float], L: int, k: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Served Moment lists -> (pairs (R, k), scores (R, k)); a missing
    answer is pair -1 with score nan."""
    idx = np.full((len(answers), k), -1, np.int64)
    val = np.full((len(answers), k), np.nan, np.float64)
    for r, (moments, dur) in enumerate(zip(answers, durations)):
        for c, m in enumerate(list(moments)[:k]):
            idx[r, c] = pair_of(m.start, m.end, dur, L)
            val[r, c] = m.score
    return idx, val


def serving_gaps(ref: np.ndarray, idx: np.ndarray, val: np.ndarray) -> Dict[str, float]:
    """``rank_gap`` and ``score_gap`` of answers (idx, val) against the
    reference scores ``ref`` (R, N)."""
    ref = ref.astype(np.float64)
    top = -np.sort(-ref, axis=1)[:, : idx.shape[1]]
    at = np.where(idx >= 0, np.take_along_axis(ref, np.maximum(idx, 0), axis=1), 0.0)
    rank = top - at
    score = np.abs(np.where(np.isnan(val), np.inf, val) - at)
    score = np.where(idx >= 0, score, np.maximum(top, 1.0))
    return {"rank_gap": float(rank.max()), "score_gap": float(score.max())}


def _norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in leaves.items()}


def worst_leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                   names: Sequence[str]) -> float:
    p, r = _norms({k: prog[k] for k in names}), _norms({k: ref[k] for k in names})
    med = float(np.median([r[k] for k in names]))
    return max(abs(p[k] - r[k]) / max(r[k], med) for k in names)


def moved_leaves(ref_grad: Dict[str, torch.Tensor]) -> List[str]:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's: the others move under Adam by rounding alone."""
    norms = _norms(ref_grad)
    med = float(np.median(list(norms.values())))
    return [k for k, v in norms.items() if v >= 1e-3 * med]


def training_gaps(prog: Tuple, ref: Tuple) -> Dict[str, float]:
    """prog, ref: (losses, first gradient by leaf, change by leaf)."""
    (pl, pg, pc), (rl, rg, rc) = prog, ref
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(pl, rl))
    names, moved = sorted(rg), moved_leaves(rg)
    return {"loss_gap": float(loss_gap),
            "grad_gap": worst_leaf_gap(pg, rg, names),
            "change_gap": worst_leaf_gap(pc, rc, moved),
            "leaves_left_out": float(len(names) - len(moved))}


def judge(readings: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """Each compared number beside its limit (a missing limit is an error)."""
    return {k: {"value": readings[k], "limit": float(limits[k])} for k in limits}


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    return all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())

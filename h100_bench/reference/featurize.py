"""Plain host featurization of a serving request: the reference's side.

Frozen copies of the semantics the program's serving path implements
(SMIN reference dataset.py:16-24, 40-74, 145-149, utils.py:6-7): evaluation
sampling of raw clip features to T rows (offset 0, stride nfeats / T,
numpy's round-half-to-even), the length mask over L snippets, and the
lowercase / no-punctuation / whitespace tokenizer with the word table's
``<unk>`` and ``<pad>`` rows. NumPy only.
"""

from __future__ import annotations

import math
import string
from typing import Dict, Tuple

import numpy as np

_PUNCT = str.maketrans("", "", string.punctuation)


def sample_eval(feat: np.ndarray, T: int) -> Tuple[np.ndarray, int]:
    """(T, dv) float32 rows of ``feat`` (nfeats, dv) and the valid count."""
    nfeats = feat.shape[0]
    stride = 1.0 if nfeats <= T else nfeats / T
    idx = np.round(np.arange(0.0, nfeats - 0.5, stride)).astype(np.int64)[:T]
    out = np.zeros((T, feat.shape[1]), np.float32)
    out[: len(idx)] = feat[idx]
    return out, min(nfeats, T)


def length_mask(nvalid: int, T: int, L: int) -> np.ndarray:
    """(L,) 1 for the snippets that hold a valid clip."""
    m = np.zeros(L, np.float32)
    m[: math.ceil(nvalid / (T / L))] = 1.0
    return m


def tokens(query: str) -> list:
    return str(query).lower().translate(_PUNCT).strip().split()


def encode_query(query: str, stoi: Dict[str, int], vectors: np.ndarray,
                 Nq: int) -> Tuple[np.ndarray, np.ndarray]:
    """(Nq, dim) word vectors (zero for <unk> and <pad>) and the (Nq,) mask:
    1 for words and <unk>, 0 for padding; truncated to Nq words."""
    words = tokens(query)[:Nq]
    feats = np.zeros((Nq, vectors.shape[1]), np.float32)
    mask = np.zeros(Nq, np.float32)
    for t, w in enumerate(words):
        k = stoi.get(w)
        if k is not None:
            feats[t] = vectors[k]
        mask[t] = 1.0
    return feats, mask


def featurize(requests, stoi, vectors, T: int, L: int, Nq: int) -> Dict[str, np.ndarray]:
    """Stacked model inputs of (clip_features, query, duration, ...) rows."""
    vf, vm, lm, qf, qm = [], [], [], [], []
    for row in requests:
        f, n = sample_eval(np.asarray(row[0], np.float32), T)
        mask = np.zeros((T, 1), np.float32)
        mask[:n] = 1.0
        q, m = encode_query(row[1], stoi, vectors, Nq)
        vf.append(f), vm.append(mask), lm.append(length_mask(n, T, L)), qf.append(q)
        qm.append(m[:, None])
    return {"video_features": np.stack(vf), "video_mask": np.stack(vm),
            "length_mask": np.stack(lm), "query_features": np.stack(qf),
            "query_mask": np.stack(qm)}

"""GloVe word embeddings without torchtext.

Counterpart of ``video_moment_localization_tpu/data/glove.py`` with the same
vocabulary semantics as the reference (dataset.py:16-24):

* out-of-vocabulary tokens map to ``<unk>`` (id = V, zero vector);
* queries are right-padded with ``<pad>`` (id = V + 1, zero vector);
* the query mask is ``token_id < pad_id`` — so ``<unk>`` tokens count as
  valid words, exactly as in the reference (dataset.py:173).

Lookup happens on the host; the model consumes (Nq, 300) float arrays.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# Candidate locations for the raw GloVe text file / cached npz.
_DEFAULT_GLOVE_CANDIDATES = (
    "data/glove/glove.6B.300d.txt",
    os.path.expanduser("~/.vector_cache/glove.6B.300d.txt"),
)


class WordEmbedding:
    """Frozen word-embedding table with <unk>/<pad> handling.

    vectors : (V, dim) float32 array of word vectors (without unk/pad).
    stoi    : token -> id mapping for the V real words.
    """

    def __init__(self, vectors: np.ndarray, stoi: Dict[str, int]):
        vocab_size, dim = vectors.shape
        self.dim = int(dim)
        self.unk_id = vocab_size
        self.pad_id = vocab_size + 1
        self.stoi = stoi
        self.vectors = np.concatenate(
            [np.asarray(vectors, np.float32), np.zeros((2, dim), np.float32)], axis=0
        )

    def encode(self, tokens: Sequence[str], max_length: int) -> Tuple[np.ndarray, np.ndarray]:
        """tokens -> (token_ids (max_length,), features (max_length, dim)).

        OOV -> unk; right-pad with pad; truncates to max_length.
        """
        ids = [self.stoi.get(t, self.unk_id) for t in tokens[:max_length]]
        ids = ids + [self.pad_id] * (max_length - len(ids))
        token_ids = np.asarray(ids, dtype=np.int64)
        return token_ids, self.vectors[token_ids]

    def query_mask(self, token_ids: np.ndarray) -> np.ndarray:
        """(Nq,) validity mask: 1 for real words and <unk>, 0 for <pad>."""
        return (token_ids < self.pad_id).astype(np.float32)

    @classmethod
    def from_text(cls, path: str, cache: bool = True) -> "WordEmbedding":
        """Parse a GloVe ``.txt`` file ('word v1 v2 ...' per line)."""
        npz_path = path + ".npz"
        if os.path.exists(npz_path):
            return cls.from_npz(npz_path)
        words: List[str] = []
        rows: List[np.ndarray] = []
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip("\n").split(" ")
                if len(parts) < 2:
                    continue
                words.append(parts[0])
                rows.append(np.asarray(parts[1:], dtype=np.float32))
        vectors = np.stack(rows, axis=0)
        emb = cls(vectors, {w: i for i, w in enumerate(words)})
        if cache:
            try:
                np.savez_compressed(npz_path, vectors=vectors,
                                    words=np.asarray(words, dtype=object))
            except OSError:
                pass  # the cache is best-effort
        return emb

    @classmethod
    def from_npz(cls, path: str) -> "WordEmbedding":
        data = np.load(path, allow_pickle=True)
        words = [str(w) for w in data["words"]]
        return cls(np.asarray(data["vectors"], np.float32), {w: i for i, w in enumerate(words)})

    @classmethod
    def load(cls, path: Optional[str] = None) -> "WordEmbedding":
        """Locate and load GloVe from `path`, $GLOVE_PATH, or default dirs."""
        candidates = [c for c in (path, os.environ.get("GLOVE_PATH")) if c]
        candidates.extend(_DEFAULT_GLOVE_CANDIDATES)
        for cand in candidates:
            if os.path.exists(cand):
                if cand.endswith(".npz"):
                    return cls.from_npz(cand)
                return cls.from_text(cand)
        raise FileNotFoundError(
            "GloVe embeddings not found. Place glove.6B.300d.txt under "
            "data/glove/ or set GLOVE_PATH to the .txt or cached .npz file. "
            f"Searched: {candidates}"
        )

    @classmethod
    def synthetic(cls, words: Sequence[str], dim: int = 300, seed: int = 0) -> "WordEmbedding":
        """Deterministic random table for hermetic tests (no downloads)."""
        rng = np.random.default_rng(seed)
        vectors = rng.standard_normal((len(words), dim)).astype(np.float32)
        return cls(vectors, {w: i for i, w in enumerate(words)})

"""Synthetic dataset fixtures for hermetic tests and benchmarks.

Counterpart of ``video_moment_localization_tpu/data/synthetic.py``: for the
same arguments every file it writes is byte-identical to the JAX writer's.
The reference repo has no hermetic tests (its smoke script needs downloaded
Charades features + GloVe). This module generates:

* an in-memory `SyntheticDataset` with random features and hand-checkable
  annotations, and
* on-disk miniatures of the three datasets' real layouts
  (`write_charades_style_dir`: npy features + txt/csv annotations;
  `write_activitynet_style_dir` / `write_tacos_style_dir`: one HDF5 file +
  JSON annotations; each with a tiny GloVe txt) to exercise the full
  file-reading path and the CLI end-to-end without downloads.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from video_moment_localization_tpu_torch.data.datasets import MomentDataset
from video_moment_localization_tpu_torch.data.glove import WordEmbedding

_WORDS = [
    "person", "opens", "door", "a", "the", "closes", "window", "picks",
    "up", "cup", "puts", "down", "book", "walks", "into", "room", "sits",
    "on", "chair", "stands",
]


def synthetic_embedding(dim: int = 300, seed: int = 0) -> WordEmbedding:
    return WordEmbedding.synthetic(_WORDS, dim=dim, seed=seed)


class SyntheticDataset(MomentDataset):
    """In-memory dataset with random features and random-but-valid spans."""

    def __init__(
        self,
        num_videos: int = 8,
        queries_per_video: int = 2,
        T: int = 16,
        L: int = 8,
        max_query_length: int = 6,
        input_video_dim: int = 32,
        split: str = "train",
        seed: int = 0,
        min_clips: int = 4,
        max_clips: int = 40,
        embedding: Optional[WordEmbedding] = None,
    ):
        emb = embedding or synthetic_embedding(seed=seed)
        super().__init__("<memory>", T, L, max_query_length, split, emb)
        rng = np.random.default_rng(seed + (0 if split == "train" else 1))
        self._features = {}
        self.annotations = []
        for v in range(num_videos):
            vid = f"synth{split}{v:03d}"
            nfeats = int(rng.integers(min_clips, max_clips + 1))
            self._features[vid] = rng.standard_normal(
                (nfeats, input_video_dim)
            ).astype(np.float32)
            duration = float(nfeats) * 0.5  # pretend 0.5s per clip
            for _ in range(queries_per_video):
                spos = float(rng.uniform(0, duration * 0.8))
                epos = float(rng.uniform(spos + duration * 0.05, duration))
                nwords = int(rng.integers(2, max_query_length + 1))
                query = " ".join(rng.choice(_WORDS, size=nwords))
                token_ids, feats = self._encode_query(query)
                self.annotations.append(
                    {
                        "video_id": vid,
                        "times": [spos, epos],
                        "duration": duration,
                        "query": query,
                        "token_ids": token_ids,
                        "query_features": feats,
                    }
                )

    def _load_video_features(self, vid: str) -> np.ndarray:
        return self._features[vid]


def write_glove_txt(path: str, dim: int = 300, seed: int = 0) -> None:
    """Write a tiny GloVe-format text file covering the synthetic vocab."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for w in _WORDS:
            vec = rng.standard_normal(dim)
            f.write(w + " " + " ".join(f"{x:.5f}" for x in vec) + "\n")


def write_activitynet_style_dir(
    root: str,
    num_videos: int = 5,
    queries_per_video: int = 2,
    input_video_dim: int = 24,
    splits: List[str] = ("train", "val", "test"),
    seed: int = 0,
) -> str:
    """Miniature ActivityNet-Captions layout: one HDF5 of C3D features under
    key [vid]['c3d_features'] + {split}.json annotation files."""
    import h5py

    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    with h5py.File(os.path.join(root, "sub_activitynet_v1-3.c3d.hdf5"), "w") as h5:
        all_vids = {}
        for split in splits:
            for v in range(num_videos):
                vid = f"v_{split}{v:03d}"
                nfeats = int(rng.integers(10, 120))
                h5.create_group(vid).create_dataset(
                    "c3d_features",
                    data=rng.standard_normal((nfeats, input_video_dim)).astype(np.float32),
                )
                all_vids[vid] = nfeats
    for split in splits:
        anns = {}
        for v in range(num_videos):
            vid = f"v_{split}{v:03d}"
            duration = round(all_vids[vid] * 0.8, 2)
            ts, sents = [], []
            for _ in range(queries_per_video):
                s = round(float(rng.uniform(0, duration * 0.7)), 2)
                e = round(float(rng.uniform(s + 0.2, duration)), 2)
                ts.append([s, e])
                sents.append(" ".join(rng.choice(_WORDS, size=int(rng.integers(2, 6)))))
            anns[vid] = {"duration": duration, "timestamps": ts, "sentences": sents}
        with open(os.path.join(root, f"{split}.json"), "w") as f:
            import json

            json.dump(anns, f)
    write_glove_txt(os.path.join(root, "glove/glove.6B.300d.txt"), seed=seed)
    return root


def write_tacos_style_dir(
    root: str,
    num_videos: int = 5,
    queries_per_video: int = 2,
    input_video_dim: int = 24,
    splits: List[str] = ("train", "val", "test"),
    seed: int = 0,
) -> str:
    """Miniature TACoS layout: one HDF5 keyed by [vid] + frame-time JSONs
    (timestamps in frames, duration = num_frames / fps)."""
    import h5py

    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    nframes = {}
    with h5py.File(os.path.join(root, "tall_c3d_features.hdf5"), "w") as h5:
        for split in splits:
            for v in range(num_videos):
                vid = f"s{split}{v:02d}-d21"
                nfeats = int(rng.integers(10, 150))
                h5.create_dataset(
                    vid,
                    data=rng.standard_normal((nfeats, input_video_dim)).astype(np.float32),
                )
                nframes[vid] = nfeats * 16  # pretend 16 frames per clip feature
    fps = 29.4
    for split in splits:
        anns = {}
        for v in range(num_videos):
            vid = f"s{split}{v:02d}-d21"
            nf = nframes[vid]
            ts, sents = [], []
            for _ in range(queries_per_video):
                s = int(rng.integers(0, int(nf * 0.7)))
                e = int(rng.integers(s + 10, nf))
                ts.append([s, e])
                sents.append(" ".join(rng.choice(_WORDS, size=int(rng.integers(2, 6)))))
            anns[vid] = {"num_frames": nf, "fps": fps, "timestamps": ts,
                         "sentences": sents}
        with open(os.path.join(root, f"{split}.json"), "w") as f:
            import json

            json.dump(anns, f)
    write_glove_txt(os.path.join(root, "glove/glove.6B.300d.txt"), seed=seed)
    return root


def write_charades_style_dir(
    root: str,
    num_videos: int = 6,
    queries_per_video: int = 2,
    input_video_dim: int = 32,
    splits: List[str] = ("train", "test"),
    seed: int = 0,
    signal_strength: float = 0.0,
    videos_per_split: Optional[dict] = None,
) -> str:
    """Create a miniature on-disk Charades-STA data directory.

    Layout matches what the CharadesSTA reader expects:
    features/i3d_finetuned/{vid}.npy, annotations/charades_sta_{split}.txt,
    annotations/Charades_v1_{split}.csv.

    ``signal_strength > 0`` makes the fixture *learnable*: each annotation's
    ground-truth span gets a query-dependent additive pattern in the video
    features (the mean GloVe vector of the query words, pushed through a
    fixed random 300->input_video_dim projection). A model that learns the
    cross-modal correlation can localize well above chance, so parity runs
    compare real training dynamics rather than noise-fitting. The rng draw
    sequence is identical to ``signal_strength == 0``, so existing fixtures
    are byte-identical when the signal is off.

    ``videos_per_split`` optionally overrides ``num_videos`` per split, e.g.
    ``{"train": 250, "test": 50}``.
    """
    rng = np.random.default_rng(seed)
    feat_dir = os.path.join(root, "features/i3d_finetuned")
    ann_dir = os.path.join(root, "annotations")
    os.makedirs(feat_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)

    if signal_strength > 0.0:
        # Same vector sequence as write_glove_txt(seed=seed) below.
        glove_rng = np.random.default_rng(seed)
        word_vecs = {w: glove_rng.standard_normal(300) for w in _WORDS}
        proj = np.random.default_rng(seed + 77).standard_normal(
            (300, input_video_dim)
        ) / np.sqrt(300.0)

    for split in splits:
        lines, csv_rows = [], []
        n_vids = (videos_per_split or {}).get(split, num_videos)
        for v in range(n_vids):
            vid = f"{split.upper()}{v:03d}"
            nfeats = int(rng.integers(8, 90))
            feats = rng.standard_normal((nfeats, 1, input_video_dim)).astype(
                np.float32
            )
            duration = round(float(nfeats) * 0.33, 2)
            csv_rows.append((vid, duration))
            for _ in range(queries_per_video):
                spos = round(float(rng.uniform(0, duration * 0.7)), 2)
                epos = round(float(rng.uniform(spos + 0.1, duration)), 2)
                nwords = int(rng.integers(2, 6))
                words = rng.choice(_WORDS, size=nwords)
                query = " ".join(words)
                lines.append(f"{vid} {spos} {epos}##{query}")
                if signal_strength > 0.0:
                    u = np.mean([word_vecs[w] for w in words], axis=0) @ proj
                    u = u / max(np.linalg.norm(u), 1e-6)
                    lo = int(spos / duration * nfeats)
                    hi = max(lo + 1, int(np.ceil(epos / duration * nfeats)))
                    feats[lo:hi, 0, :] += (signal_strength * u).astype(np.float32)
            np.save(os.path.join(feat_dir, f"{vid}.npy"), feats)
        with open(os.path.join(ann_dir, f"charades_sta_{split}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
        with open(os.path.join(ann_dir, f"Charades_v1_{split}.csv"), "w") as f:
            f.write("id,length\n")
            for vid, dur in csv_rows:
                f.write(f"{vid},{dur}\n")

    write_glove_txt(os.path.join(root, "glove/glove.6B.300d.txt"), seed=seed)
    return root

"""Dataset readers: Charades-STA, ActivityNet-Captions, TACoS.

Counterpart of ``video_moment_localization_tpu/data/datasets.py``, with the
same annotation formats and cleaning rules as the reference
(reference dataset.py:189-315):

* Charades-STA: ``charades_sta_{split}.txt`` lines ``"<vid> <s> <e>##<query>"``
  plus durations from ``Charades_v1_{split}.csv``; clamp s >= 0, e <= duration,
  drop s >= e; per-video ``.npy`` I3D features (squeezed).
* ActivityNet: ``{split}.json`` mapping vid -> {duration, timestamps,
  sentences}; features from one HDF5 file under key ``[vid]['c3d_features']``.
* TACoS: same JSON schema with frame-denominated times (divided by fps,
  duration = num_frames / fps); features HDF5 key ``[vid]``.

Differences from the reference (deliberate, performance/correctness):

* HDF5 handles are opened once per thread (the reference reopened the file on
  every __getitem__ call, dataset.py:274-275), and ``h5py`` is imported only
  by the HDF5 readers, so the Charades path does not need it;
* only the <= T sampled feature rows are read from disk (mmap'd npy, h5py
  fancy selection);
* the word-embedding table is injected rather than downloaded at import time;
* samples are flat float32 NumPy arrays, with the training-jitter RNG passed
  in explicitly for reproducible resume. Moving them to the device is the
  trainer's job.
"""

from __future__ import annotations

import csv
import json
import os
import threading
from typing import Any, Dict, List, Optional

import numpy as np

from video_moment_localization_tpu_torch.data import native
from video_moment_localization_tpu_torch.data.glove import WordEmbedding
from video_moment_localization_tpu_torch.data.sampler import sample_frame_indices
from video_moment_localization_tpu_torch.data.tokenizer import get_tokens

# Keys of the fixed-shape tensor fields in a sample/batch (the reference's
# collate list, dataset.py:77, minus torch-specific layout).
TENSOR_KEYS = (
    "video_features",
    "video_mask",
    "query_features",
    "query_mask",
    "length_mask",
    "moment_mask",
    "start_pos",
    "end_pos",
    "sm",
    "ym",
    "ss",
    "ys",
    "se",
    "ye",
    "ya",
)


class MomentDataset:
    """Base dataset: annotations + per-sample feature/label assembly.

    ``packed_labels`` (set by the trainer when the model runs the packed
    layout) emits `sm`/`ym` as packed (N = L(L+1)/2,) vectors and omits the
    dense `moment_mask` entirely — the device derives pair validity from
    `length_mask`, and no (L, L) array is ever built host- or device-side.
    """

    packed_labels: bool = False

    def __init__(
        self,
        data_dir: str,
        T: int,
        L: int,
        max_query_length: int,
        split: str,
        embedding: WordEmbedding,
    ):
        self.data_dir = data_dir
        self.T = T
        self.L = L
        self.max_query_length = max_query_length
        self.split = split
        self.embedding = embedding
        self.annotations: List[Dict[str, Any]] = []
        self._local = threading.local()

    def __len__(self) -> int:
        return len(self.annotations)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        """Map-style access (reference dataset.py:129 compatibility).

        Equivalent to ``sample(index)`` with the process-global RNG for
        training jitter; prefer ``sample(index, rng)`` in pipelines that
        need reproducibility (data/pipeline.py threads explicit streams).
        """
        return self.sample(index)

    # ------------------------------------------------------------------ #
    def _encode_query(self, query: str):
        tokens = get_tokens(query)
        token_ids, feats = self.embedding.encode(tokens, self.max_query_length)
        return token_ids, feats

    def _load_video_features(self, vid: str) -> np.ndarray:
        raise NotImplementedError("subclasses must load raw clip features")

    def _video_source(self, vid: str):
        """(nfeats, dv, fetch) where fetch(frame_idx) returns those rows.

        Default: full in-memory load. Readers override this to fetch ONLY
        the <= T sampled rows from disk (h5py fancy selection, mmap'd npy) —
        long videos otherwise read 10-20x more bytes than the model uses
        (the reference always loads whole videos, dataset.py:234,275,315).
        """
        feat = self._load_video_features(vid)
        return feat.shape[0], feat.shape[1], lambda idx: feat[idx]

    # ------------------------------------------------------------------ #
    def sample_core(self, index: int, rng: Optional[np.random.Generator] = None,
                    out: Optional[np.ndarray] = None) -> Dict[str, Any]:
        """Feature/query part of a sample (no labels or masks).

        The batched-labelgen pipeline path (data/pipeline.py) assembles all
        label arrays for a whole batch in one native call; this returns
        everything else plus the scalars that call needs (spos/epos/
        duration/nfeats).

        ``out``: optional zeroed (T, dv) row of a preallocated batch array —
        features are written in place (skipping the per-sample allocation
        AND the collate stack copy) and the returned dict omits
        ``video_features``.
        """
        ann = self.annotations[index]
        vid = ann["video_id"]
        spos, epos = ann["times"]
        duration = ann["duration"]
        spos_n = spos / duration
        epos_n = epos / duration

        nfeats_raw, dv, fetch = self._video_source(vid)
        frame_idx, nfeats, start_index, end_index = sample_frame_indices(
            nfeats_raw, self.T, spos_n, epos_n,
            train=(self.split == "train"), rng=rng,
        )
        if out is not None:
            out[:nfeats] = fetch(frame_idx)
            vf_entry = {}
        else:
            video_features = np.zeros((self.T, dv), dtype=np.float32)
            video_features[:nfeats] = fetch(frame_idx)
            vf_entry = {"video_features": video_features}           # (T, dv)
        return {
            "video_id": vid,
            "times": ann["times"],
            "duration": duration,
            "start_index": start_index,
            "end_index": end_index,
            **vf_entry,
            "start_pos": np.float32(spos_n),
            "end_pos": np.float32(epos_n),
            "query_features": ann["query_features"],                # (Nq, 300)
            "query_mask": self.embedding.query_mask(ann["token_ids"])[:, None],
            "_spos": spos,
            "_epos": epos,
            "_nfeats": nfeats,
        }

    def sample(self, index: int, rng: Optional[np.random.Generator] = None) -> Dict[str, Any]:
        """Assemble one training/eval sample as a dict of float32 arrays.

        Mirrors the reference __getitem__ (dataset.py:129-187) but without
        the leading singleton batch dim (batching stacks along a new axis).
        """
        core = self.sample_core(index, rng)
        spos, epos = core.pop("_spos"), core.pop("_epos")
        nfeats = core.pop("_nfeats")
        duration = core["duration"]
        # Native C kernels when built (csrc/vml_native.cpp); NumPy otherwise.
        if self.packed_labels:
            video_mask, length_mask = native.build_masks_packed(
                nfeats, self.T, self.L
            )
            ious, ym, s_s, ys, s_e, ye, y_a = native.generate_labels_packed(
                spos, epos, duration, self.L
            )
            moment_mask = None
        else:
            video_mask, length_mask, moment_mask = native.build_masks(
                nfeats, self.T, self.L
            )
            ious, ym, s_s, ys, s_e, ye, y_a = native.generate_labels(
                spos, epos, duration, self.L
            )

        core.update({
            "video_mask": video_mask,                               # (T, 1)
            "length_mask": length_mask,                             # (L,)
            # moment_mask (L, L) only in dense-label mode
            **({} if moment_mask is None else {"moment_mask": moment_mask}),
            "sm": ious,                                             # (L, L) or packed (N,)
            "ym": ym,
            "ss": s_s,                                              # (L,)
            "ys": ys,
            "se": s_e,
            "ye": ye,
            "ya": y_a,
        })
        return core

    # JSON-schema annotation loader shared by ActivityNet/TACoS.
    def _load_json_annotations(self, ann_path: str, frame_times: bool) -> List[Dict[str, Any]]:
        with open(ann_path, "r") as f:
            anns = json.load(f)
        annotations = []
        for vid, ann in anns.items():
            if frame_times:
                fps = ann["fps"]
                duration = ann["num_frames"] / fps
            else:
                duration = ann["duration"]
            for (spos, epos), query in zip(ann["timestamps"], ann["sentences"]):
                if frame_times:
                    spos, epos = spos / fps, epos / fps
                spos = max(spos, 0)
                epos = min(epos, duration)
                if spos < epos:
                    token_ids, feats = self._encode_query(query)
                    annotations.append(
                        {
                            "video_id": vid,
                            "times": [spos, epos],
                            "duration": duration,
                            "query": query,
                            "token_ids": token_ids,
                            "query_features": feats,
                        }
                    )
        return annotations


class CharadesSTA(MomentDataset):
    """Charades-STA: per-video .npy I3D features + txt/csv annotations."""

    DEFAULTS = dict(T=64, L=16, max_query_length=13)

    def __init__(self, data_dir="data/charades", T=64, L=16, max_query_length=13,
                 split="train", embedding: Optional[WordEmbedding] = None):
        super().__init__(data_dir, T, L, max_query_length, split,
                         embedding or WordEmbedding.load())
        self.feature_path = os.path.join(data_dir, "features/i3d_finetuned/{}.npy")
        ann_path = os.path.join(data_dir, f"annotations/charades_sta_{split}.txt")
        aux_path = os.path.join(data_dir, f"annotations/Charades_v1_{split}.csv")
        self.annotations = self._load_annotations(ann_path, aux_path)

    def _load_annotations(self, ann_path: str, aux_path: str) -> List[Dict[str, Any]]:
        with open(ann_path, "r") as f:
            lines = f.read().strip().split("\n")
        with open(aux_path) as f:
            durations = {row["id"]: float(row["length"]) for row in csv.DictReader(f)}
        annotations = []
        for line in lines:
            info, query = line.split("##")
            vid, spos, epos = info.split(" ")
            duration = durations[vid]
            spos = max(float(spos), 0)
            epos = min(float(epos), duration)  # some GT ends exceed duration
            if spos < epos:  # a handful of inverted spans exist upstream
                token_ids, feats = self._encode_query(query)
                annotations.append(
                    {
                        "video_id": vid,
                        "times": [spos, epos],
                        "duration": duration,
                        "query": query,
                        "token_ids": token_ids,
                        "query_features": feats,
                    }
                )
        return annotations

    def _load_video_features(self, vid: str) -> np.ndarray:
        return np.load(self.feature_path.format(vid)).squeeze()

    # Open-mmap cap per worker thread, as in the JAX reader. Charades train
    # touches ~5.3k videos per epoch in shuffled order, so an undersized
    # cache re-opens files (np.load's header parse) over and over. Each open
    # map holds a file descriptor: set VML_MMAP_CACHE lower where the
    # descriptor limit (ulimit -n) is small.
    _MMAP_CACHE_SIZE = int(os.environ.get("VML_MMAP_CACHE", 4096))

    def _video_source(self, vid: str):
        # mmap: only the <= T sampled rows are paged in from disk. Handles
        # are LRU-cached per thread — most videos carry several queries, and
        # the np.load open cost (~0.2 ms) otherwise dominates the sample.
        cache = getattr(self._local, "mmap_cache", None)
        if cache is None:
            from collections import OrderedDict

            cache = self._local.mmap_cache = OrderedDict()
        arr = cache.get(vid)
        if arr is None:
            arr = np.load(self.feature_path.format(vid), mmap_mode="r").squeeze()
            cache[vid] = arr
            if len(cache) > self._MMAP_CACHE_SIZE:
                cache.popitem(last=False)
        else:
            cache.move_to_end(vid)
        return arr.shape[0], arr.shape[1], (
            lambda idx: np.asarray(arr[idx], dtype=np.float32)
        )


class _Hdf5Dataset(MomentDataset):
    """Shared HDF5 feature reading with one handle per thread."""

    feature_file: str

    def _h5(self):
        import h5py  # local import: keep h5py optional for npy-only datasets

        handle = getattr(self._local, "h5", None)
        if handle is None:
            handle = h5py.File(self.feature_file, "r")
            self._local.h5 = handle
        return handle

    def _dset(self, vid: str):
        raise NotImplementedError

    def _video_source(self, vid: str):
        # h5py fancy selection reads only the sampled rows (frame indices
        # are strictly increasing by construction — sampler stride >= 1).
        d = self._dset(vid)
        return d.shape[0], d.shape[1], (
            lambda idx: np.asarray(d[idx], dtype=np.float32)
        )


class ActivityNet(_Hdf5Dataset):
    """ActivityNet-Captions: C3D features in one HDF5, JSON annotations."""

    DEFAULTS = dict(T=128, L=64, max_query_length=20)

    def __init__(self, data_dir="data/activitynet", T=128, L=64, max_query_length=20,
                 split="train", embedding: Optional[WordEmbedding] = None):
        super().__init__(data_dir, T, L, max_query_length, split,
                         embedding or WordEmbedding.load())
        self.feature_file = os.path.join(data_dir, "sub_activitynet_v1-3.c3d.hdf5")
        self.annotations = self._load_json_annotations(
            os.path.join(data_dir, f"{split}.json"), frame_times=False
        )

    def _dset(self, vid: str):
        return self._h5()[vid]["c3d_features"]

    def _load_video_features(self, vid: str) -> np.ndarray:
        return np.asarray(self._dset(vid)[:])


class TACoS(_Hdf5Dataset):
    """TACoS: C3D features in one HDF5, frame-time JSON annotations."""

    DEFAULTS = dict(T=128, L=32, max_query_length=14)

    def __init__(self, data_dir="data/tacos", T=128, L=32, max_query_length=14,
                 split="train", embedding: Optional[WordEmbedding] = None):
        super().__init__(data_dir, T, L, max_query_length, split,
                         embedding or WordEmbedding.load())
        self.feature_file = os.path.join(data_dir, "tall_c3d_features.hdf5")
        self.annotations = self._load_json_annotations(
            os.path.join(data_dir, f"{split}.json"), frame_times=True
        )

    def _dset(self, vid: str):
        return self._h5()[vid]

    def _load_video_features(self, vid: str) -> np.ndarray:
        return np.asarray(self._dset(vid)[:])


_DATASETS = {
    "charadessta": CharadesSTA,
    "activitynet": ActivityNet,
    "tacos": TACoS,
}


def get_dataset_class(name: str):
    """Dataset-name -> class factory (reference main.py:30-41 semantics)."""
    try:
        return _DATASETS[name]
    except KeyError:
        raise ValueError(f"Dataset {name!r} is not a valid dataset! "
                         f"Choose from {sorted(_DATASETS)}")

"""Host-side input pipeline: threaded sample assembly + batch prefetching.

Counterpart of ``video_moment_localization_tpu/data/pipeline.py``. It
replaces the reference's torch DataLoader worker processes (reference
main.py:57-66) with a thread pool (NumPy and h5py release the GIL for the
heavy ops) and a background prefetch queue, producing **fixed-shape**
float32 batches as dicts of NumPy arrays:

* every batch has exactly ``batch_size`` rows: the final partial batch is
  zero-padded and carries ``sample_mask`` (1 for real rows), which the
  losses and metrics honour;
* shuffling and the training sampler's temporal jitter are driven by
  per-(seed, epoch, index) Philox streams, making every sample bit-exactly
  reproducible regardless of thread scheduling, and therefore resumable
  (the reference's jitter used the unseeded global RNG; PARITY.md #13).

The loader's threads touch no device: moving a batch to the card is the
trainer's job, on the main thread.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List

import numpy as np

from video_moment_localization_tpu_torch.data.datasets import TENSOR_KEYS, MomentDataset

_META_KEYS = ("video_id", "times", "duration", "start_index", "end_index")


def collate(samples: List[Dict[str, Any]], batch_size: int) -> Dict[str, Any]:
    """Stack sample dicts into one fixed-shape batch, padding to batch_size."""
    n = len(samples)
    batch: Dict[str, Any] = {}
    # TENSOR_KEYS is the superset; packed-label samples omit moment_mask.
    for k in (k for k in TENSOR_KEYS if k in samples[0]):
        rows = np.stack([s[k] for s in samples], axis=0)
        if n < batch_size:
            pad = np.zeros((batch_size - n,) + rows.shape[1:], dtype=rows.dtype)
            rows = np.concatenate([rows, pad], axis=0)
        batch[k] = rows
    for k in _META_KEYS:
        batch[k] = [s[k] for s in samples]
    mask = np.zeros(batch_size, dtype=np.float32)
    mask[:n] = 1.0
    batch["sample_mask"] = mask
    return batch


class BatchLoader:
    """Deterministic, prefetching batch loader over a MomentDataset."""

    def __init__(
        self,
        dataset: MomentDataset,
        batch_size: int,
        shuffle: bool = False,
        num_workers: int = 4,
        seed: int = 0,
        prefetch: int = 2,
        shard_id: int = 0,
        num_shards: int = 1,
    ):
        """``batch_size`` is the GLOBAL batch. A data-parallel job passes
        each process's rank and the world size as ``shard_id`` and
        ``num_shards``: every process computes the identical (seed, epoch)
        global order and assembles only its contiguous
        ``batch_size/num_shards``-row slice of each global batch, as the JAX
        package's multi-host feeding does."""
        if batch_size % num_shards != 0:
            raise ValueError(
                f"batch_size ({batch_size}) must be divisible by num_shards "
                f"({num_shards})")
        if not 0 <= shard_id < num_shards:
            raise ValueError(f"shard_id {shard_id} outside [0, {num_shards})")
        self.dataset = dataset
        self.batch_size = batch_size
        self.local_batch = batch_size // num_shards
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.prefetch = prefetch
        self._dv: int | None = None  # feature width, learned from batch 1

    def __len__(self) -> int:
        n = len(self.dataset)
        return (n + self.batch_size - 1) // self.batch_size

    @property
    def num_samples(self) -> int:
        return len(self.dataset)

    def global_valid(self, index: int) -> int:
        """The real samples of the epoch's global batch ``index``, of which
        each shard holds its slice: the same on every rank, known without a
        collective (a data-parallel step's loss denominator)."""
        return max(0, min(self.batch_size, len(self.dataset) - index * self.batch_size))

    def _stream(self, epoch: int, counter: int) -> np.random.Generator:
        # Philox 2x64 key: (seed, epoch) in word 0, stream counter in word 1.
        key = [((self.seed & 0xFFFFFFFF) << 32) | (epoch & 0xFFFFFFFF), counter]
        return np.random.Generator(np.random.Philox(key=key))

    def _sample_rng(self, epoch: int, index: int) -> np.random.Generator:
        return self._stream(epoch, 2 * index)

    def _order(self, epoch: int) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._stream(epoch, 1).shuffle(order)
        return order

    def _assemble_batch(self, samples: List[Dict[str, Any]]) -> Dict[str, Any]:
        """Collate + whole-batch native labelgen (packed mode).

        Workers produced label-free ``sample_core`` dicts; ONE native call
        (csrc/vml_native.cpp::vml_assemble_batch_packed) fills every mask/
        label array for the batch — the per-sample path paid ~11 ctypes
        crossings per sample, ~25% of assembly time at Charades dims.
        """
        from video_moment_localization_tpu_torch.data import native

        n = len(samples)
        pad = self.local_batch - n
        batch = collate(samples, self.local_batch)
        labels = native.assemble_batch_packed(
            np.asarray([s.pop("_spos") for s in samples] + [0.0] * pad),
            np.asarray([s.pop("_epos") for s in samples] + [1.0] * pad),
            np.asarray([s["duration"] for s in samples] + [1.0] * pad),
            np.asarray([s.pop("_nfeats") for s in samples] + [-1] * pad,
                       dtype=np.int32),
            self.dataset.T, self.dataset.L,
        )
        batch.update(labels)
        return batch

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, Any]]:
        """Iterate batches for one epoch, prefetching in the background."""
        from video_moment_localization_tpu_torch.data import native

        # Batched-labelgen fast path: packed labels + native library built.
        batched_labels = (getattr(self.dataset, "packed_labels", False)
                          and native.available())
        sample_fn = (self.dataset.sample_core if batched_labels
                     else self.dataset.sample)
        make_batch = (self._assemble_batch if batched_labels
                      else (lambda s: collate(s, self.local_batch)))
        order = self._order(epoch)
        T = self.dataset.T
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_checked(item) -> bool:
            """Enqueue, re-checking `stop` so an abandoned consumer (e.g. a
            training step raised mid-epoch) never leaves this thread parked
            forever on a full queue."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    # Submit per-batch chunks; keep ordering deterministic.
                    for start in range(0, len(order), self.batch_size):
                        if stop.is_set():
                            return
                        chunk = order[start : start + self.batch_size]
                        lo = self.shard_id * self.local_batch
                        idxs = chunk[lo : lo + self.local_batch]
                        empty_shard = len(idxs) == 0
                        if empty_shard:
                            # Final partial global batch may leave later
                            # shards empty; every process must still emit a
                            # batch (collective step). Assemble one dummy row
                            # and mask it out below.
                            idxs = order[:1]
                        # Preallocated feature buffer (batched path, feature
                        # width known after the first batch): workers write
                        # rows in place — no per-sample buffer + stack copy.
                        vf = None
                        if batched_labels and self._dv is not None:
                            vf = np.zeros((self.local_batch, T, self._dv),
                                          np.float32)
                        # One future per worker, not per sample: future
                        # submit/result overhead (~50 us each under the GIL)
                        # adds up at per-sample granularity.
                        splits = [c for c in np.array_split(
                            np.arange(len(idxs)), self.num_workers) if len(c)]

                        def run_chunk(rows):
                            out = []
                            for r in rows:
                                rng = self._sample_rng(epoch, int(idxs[r]))
                                if vf is None:
                                    out.append(sample_fn(int(idxs[r]), rng))
                                else:
                                    out.append(sample_fn(int(idxs[r]), rng,
                                                         out=vf[r]))
                            return out

                        futures = [pool.submit(run_chunk, c) for c in splits]
                        samples = [s for f in futures for s in f.result()]
                        batch = make_batch(samples)
                        if vf is not None:
                            batch["video_features"] = vf
                        elif batched_labels:
                            self._dv = batch["video_features"].shape[-1]
                        if empty_shard:
                            # All rows are padding: zero them (matching the
                            # zero-pad convention of partial batches) and
                            # mask everything out.
                            batch = {
                                k: (np.zeros_like(v)
                                    if isinstance(v, np.ndarray) else v)
                                for k, v in batch.items()
                            }
                        if not put_checked(batch):
                            return
                put_checked(None)
            except BaseException as exc:  # surface worker errors to consumer
                put_checked(exc)

        producer = threading.Thread(target=produce, daemon=True)
        producer.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()

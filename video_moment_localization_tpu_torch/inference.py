"""Serving API: localize language-queried moments in new videos.

Counterpart of ``video_moment_localization_tpu/inference.py``
(`Moment`, `MomentLocalizer`):

    localizer = MomentLocalizer.from_checkpoint("config/charadessta.yml")
    moments = localizer.localize(clip_features, "person opens the door",
                                 duration=31.2, top_k=5)
    # -> [Moment(start=12.1, end=18.4, score=0.83), ...]

Host side: fixed-length eval sampling and GloVe query encoding. Device
side: the serving forward (models/smin.py `smin_forward_inference`, which
runs the fused biLSTM and SMI-stack kernels on the card, or the forward of
the config's mode without a graph), the final proposal scores and the top-k
(optionally soft-NMS) selection, over the N packed pairs or, in the dense
and reference-compat modes (``packed: False``, ``compat_head``), over all
L * L cells with the reference's tie order. Requests are
padded to a power-of-two ladder of batch buckets (1, 2, 4, ..., serve_batch).
Repeated videos in a chunk are featurized and encoded once (the grouped
path). Entry points run on the card unless the caller passes
``device="cpu"``.

Replicated serving (``devices=[...]``, `MomentLocalizer.from_checkpoint(...,
num_devices=N)`), the counterpart of the JAX localizer's ``mesh``: one
replica of the model a device, every bucket a multiple of the device count,
each chunk split into contiguous slices, one a replica, gathered back in
order. The grouped path is single-device only, as in the JAX package.

``compute_dtype: bfloat16`` serves every route with bf16 activations: the
default route (packed, ``fused_smi``, not ``compat_head``) through the bf16
variants of the biLSTM and SMI-stack kernels, ``compat_head``, ``fused_smi:
False`` and ``packed: False`` through `smin_forward` without a graph (the
bf16 variants of K6 and K10, of the training route's forward kernels, or of
K8 with the dense blocks in bf16, ranked by dense soft-NMS or top-k); scores
stay fp32 (models/smin.py `check_dtype`).

`AsyncLocalizer` wraps a localizer with a dynamic micro-batching queue:
`submit()` returns a future at once; a batcher thread coalesces whatever
requests arrive within ``max_wait_ms`` (up to ``serve_batch``) into one
device call, and a completer thread resolves the futures.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from video_moment_localization_tpu_torch.config import Config, ModelConfig, load_config
from video_moment_localization_tpu_torch.data.glove import WordEmbedding
from video_moment_localization_tpu_torch.data.labels import build_masks
from video_moment_localization_tpu_torch.data.sampler import sample_fixed_length_features
from video_moment_localization_tpu_torch.data.tokenizer import get_tokens
from video_moment_localization_tpu_torch.models.smin import (
    SMIN,
    check_dtype,
    smin_forward_inference,
)
from video_moment_localization_tpu_torch.ops.cuda_build import resolve_device
from video_moment_localization_tpu_torch.ops.nms import soft_nms_topk
from video_moment_localization_tpu_torch.ops.packing import triu_packing
from video_moment_localization_tpu_torch.train.metrics import (
    proposal_scores,
    proposal_scores_packed,
    topk_lowest_index_first,
)
from video_moment_localization_tpu_torch.utils.checkpoint import checkpoint_paths, load_checkpoint

Request = Tuple[Any, ...]   # (clip_features (nfeats, dv), query, duration_s[, video_key])


@dataclasses.dataclass(frozen=True)
class Moment:
    start: float   # seconds
    end: float     # seconds
    score: float


def bucket_sizes(serve_batch: int, smallest: int = 1) -> List[int]:
    """The batch ladder smallest, 2 * smallest, 4 * smallest, ... below
    serve_batch, then serve_batch: with ``smallest`` the device count of a
    replicated localizer, every bucket splits evenly over its replicas."""
    sizes, b = [], smallest
    while b < serve_batch:
        sizes.append(b)
        b *= 2
    return sizes + [serve_batch]


class MomentLocalizer:
    """Batched moment-localization scorer around a SMIN model.

    On a CUDA device the constructor turns TF32 off for the process
    (`ops.cuda_build.resolve_device`): the fp32 serving path is fp32
    throughout, and bf16 (``compute_dtype``) runs its products as bf16
    products with fp32 sums in its own kernels.

    On a CUDA device `dispatch` stages each chunk's inputs in pinned host
    memory and copies them without blocking, and enqueues the copy of its
    top-k back to pinned host memory behind an event that `collect` waits
    on: neither waits for the whole stream, so chunks dispatched by one
    thread overlap the answers collected by another (`AsyncLocalizer`).

    ``devices``: serve replicated, one replica of the model on each device of
    the list (``device`` is then unused); ``serve_batch`` must be a multiple
    of their count. A device may be named twice: its replicas share one
    copy of the weights and run one after the other on its stream. Each
    replica's slice has its own copies and event, on its own device."""

    def __init__(self, model_cfg: ModelConfig, model: SMIN, embedding: WordEmbedding,
                 serve_batch: int = 16, use_nms: bool = False, nms_sigma: float = 0.5,
                 device: str = "cuda", devices: Optional[Sequence[str]] = None):
        self.cfg = model_cfg
        self.devices = [resolve_device(d, "MomentLocalizer")
                        for d in ([device] if devices is None else devices)]
        if not self.devices or serve_batch % len(self.devices):
            raise ValueError(f"serve_batch ({serve_batch}) must be a multiple of the device "
                             f"count ({len(self.devices)})")
        self.device = self.devices[0]
        self.model = model.to(self.device).eval()
        copies = {self.device: self.model}
        for d in self.devices:
            if d not in copies:
                copies[d] = copy.deepcopy(self.model).to(d)
        self._replicas = [copies[d] for d in self.devices]
        self.embedding = embedding
        self.use_nms = use_nms
        self.nms_sigma = nms_sigma
        self.serve_batch = serve_batch
        self.bucket_sizes = bucket_sizes(serve_batch, len(self.devices))
        self.packed = model_cfg.packed and not model_cfg.compat_head   # pm (B, N)
        check_dtype(model_cfg)

    def _bucket_for(self, n: int) -> int:
        for b in self.bucket_sizes:
            if b >= n:
                return b
        return self.serve_batch

    # ------------------------------------------------------------------ #
    @classmethod
    def from_checkpoint(cls, config_path: str, glove_path: Optional[str] = None,
                        serve_batch: int = 16, use_nms: Optional[bool] = None,
                        device: str = "cuda", num_devices: Optional[int] = None
                        ) -> "MomentLocalizer":
        """Load the experiment's reference-format checkpoint. use_nms=None
        inherits the config's ``nms`` eval setting. ``num_devices``: serve
        replicated over the first N cards (refused past the cards there
        are), or N replicas on the CPU under ``device="cpu"``; None or 1:
        one device."""
        cfg: Config = load_config(config_path)
        embedding = WordEmbedding.load(glove_path)
        model_path, _ = checkpoint_paths(cfg.checkpoint_path, cfg.experiment)
        ckpt = load_checkpoint(model_path)
        if ckpt is None:
            raise FileNotFoundError(f"No saved model at {model_path}!")
        model = SMIN(cfg.model)
        model.load_state_dict(ckpt["model"], strict=True)
        devices = None
        if num_devices is not None and num_devices > 1:
            if torch.device(device).type == "cuda":
                if num_devices > torch.cuda.device_count():
                    raise ValueError(f"requested {num_devices} devices, only "
                                     f"{torch.cuda.device_count()} available")
                devices = [f"cuda:{i}" for i in range(num_devices)]
            else:
                devices = [device] * num_devices
        return cls(cfg.model, model, embedding, serve_batch=serve_batch,
                   use_nms=cfg.nms if use_nms is None else use_nms,
                   nms_sigma=cfg.nms_sigma, device=device, devices=devices)

    # ------------------------------------------------------------------ #
    def check_request(self, row: Request) -> None:
        """Raise ValueError for a malformed request: clip features that are
        not a (nfeats >= 1, input_video_dim) array of finite numbers, a
        query that is not a string, a duration that is not a number."""
        f = np.asarray(row[0])
        dv = self.cfg.input_video_dim
        if f.ndim != 2 or f.shape[0] < 1 or f.shape[1] != dv:
            raise ValueError(f"clip features must be (nfeats >= 1, {dv}), got {f.shape}")
        if not np.issubdtype(f.dtype, np.number) or not np.isfinite(f).all():
            raise ValueError("clip features must be finite numbers")
        if not isinstance(row[1], str):
            raise ValueError(f"query must be a string, got {type(row[1]).__name__}")
        float(row[2])

    def _prepare_video(self, clip_features: np.ndarray):
        cfg = self.cfg
        vf, nfeats, _, _ = sample_fixed_length_features(
            np.asarray(clip_features, np.float32), cfg.T, 0.0, 1.0)
        video_mask, length_mask, moment_mask = build_masks(nfeats, cfg.T, cfg.L)
        return vf, video_mask, length_mask, moment_mask

    def _prepare_query(self, query: str):
        token_ids, qf = self.embedding.encode(get_tokens(query), self.cfg.max_query_length)
        qm = self.embedding.query_mask(token_ids)[:, None]
        return qf, qm

    @torch.no_grad()
    def _score(self, vf, vm, qf, qm, lm, mm, k: int, vidx=None, model=None):
        """(values, indices) (B, k) of the top-k proposals: packed pair
        indices, or flat indices i * L + j of the dense map. ``model``: the
        replica (default: the first)."""
        video_group = None if vidx is None else (vf, vm, vidx)
        pm, ps, pe, _ = smin_forward_inference(
            self.model if model is None else model, self.cfg,
            None if vidx is not None else vf,
            None if vidx is not None else vm, qf, qm, lm, mm, video_group=video_group)
        if self.packed:
            score = proposal_scores_packed(pm, ps, pe, lm, self.cfg.L)
        else:
            score = proposal_scores(pm, ps, pe, mm).reshape(pm.shape[0], -1)
        if self.use_nms:
            return soft_nms_topk(score, self.cfg.L, k, self.nms_sigma, packed=self.packed)
        return topk_lowest_index_first(score, k)

    def dispatch(self, chunk: Sequence[Request], top_k: int = 5):
        """Prepare and enqueue ONE chunk (<= serve_batch) on the device.

        Returns a handle for :meth:`collect`. Kernels run asynchronously:
        this blocks only for host featurization (on a CUDA device the
        copies from pinned memory do not block, and the top-k comes back
        through a pinned copy behind an event that `collect` waits on).
        Rows that carry a 4th element ``video_key`` share one
        featurization and one device encode per key; without it the key is
        the array's identity. When the unique videos fit a bucket at most
        half the pair bucket, the chunk takes the grouped-video path (on a
        single device). A replicated localizer splits the padded chunk into
        one contiguous slice a replica (`_score_slice`)."""
        vid_rows: dict = {}     # video key -> (g, prepared video)
        q_cache: dict = {}      # query string -> (qf, qm)
        vidx, vkeys = [], []
        for row in chunk:
            f, q = row[0], row[1]
            key = row[3] if len(row) > 3 else id(f)
            vkeys.append(key)
            if key not in vid_rows:
                vid_rows[key] = (len(vid_rows), self._prepare_video(f))
            if q not in q_cache:
                q_cache[q] = self._prepare_query(q)
            vidx.append(vid_rows[key][0])
        uniq = [v for _, v in sorted(vid_rows.values(), key=lambda t: t[0])]
        n = len(chunk)
        bucket = self._bucket_for(n)
        pad = bucket - n

        def stack(rows, npad):
            arr = np.stack(rows)
            if npad:
                arr = np.concatenate([arr, np.zeros((npad,) + arr.shape[1:], arr.dtype)])
            return arr

        per_row_v = [vid_rows[k][1] for k in vkeys]
        qf = stack([q_cache[row[1]][0] for row in chunk], pad)
        qm = stack([q_cache[row[1]][1] for row in chunk], pad)
        lm = stack([v[2] for v in per_row_v], pad)
        mm = None if self.packed else stack([v[3] for v in per_row_v], pad)
        if len(self.devices) == 1 and self._bucket_for(len(uniq)) * 2 <= bucket:
            gpad = self._bucket_for(len(uniq)) - len(uniq)
            arrays = (stack([v[0] for v in uniq], gpad), stack([v[1] for v in uniq], gpad),
                      qf, qm, lm, mm, np.asarray(vidx + [0] * pad, np.int64))
            return chunk, top_k, [self._score_slice(0, arrays, top_k)]
        arrays = (stack([v[0] for v in per_row_v], pad), stack([v[1] for v in per_row_v], pad),
                  qf, qm, lm, mm, None)
        rows = bucket // len(self.devices)
        return chunk, top_k, [
            self._score_slice(r, [None if a is None else a[r * rows: (r + 1) * rows]
                                  for a in arrays], top_k)
            for r in range(len(self.devices))]

    def _score_slice(self, r: int, arrays, top_k: int):
        """Replica ``r`` scores its rows (vf, vm, qf, qm, lm, mm, vidx as
        host arrays, None where absent) on its device; returns (values,
        indices, event): on a CUDA device the top-k in pinned host memory
        behind the event, else on the CPU and no event."""
        device = self.devices[r]
        cuda = device.type == "cuda"
        with torch.cuda.device(device) if cuda else contextlib.nullcontext():
            vf, vm, qf, qm, lm, mm, vidx = [
                None if a is None else self._to_device(torch.from_numpy(a), device)
                for a in arrays]
            vals, idxs = self._score(vf, vm, qf, qm, lm, mm, top_k, vidx,
                                     model=self._replicas[r])
            if not cuda:
                return vals, idxs, None
            vals, idxs = self._to_host(vals), self._to_host(idxs)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(device))
        return vals, idxs, done

    @staticmethod
    def _to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
        """A host tensor on ``device``; on a CUDA device through pinned
        memory without blocking (the caching host allocator keeps the pinned
        block until the copy has ended)."""
        if device.type != "cuda":
            return t.to(device)
        return t.pin_memory().to(device, non_blocking=True)

    @staticmethod
    def _to_host(t: torch.Tensor) -> torch.Tensor:
        """An enqueued, non-blocking copy of a device tensor into pinned
        host memory; valid once the handle's event has completed."""
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        return host

    def collect(self, handle) -> List[List[Moment]]:
        """Wait for a :meth:`dispatch` handle and build the Moment lists: on
        a CUDA device it waits on the handle's own events, one a replica,
        not on the streams, so chunks dispatched after this one keep
        running; the replicas' slices are gathered in order."""
        chunk, top_k, parts = handle
        for _, _, done in parts:
            if done is not None:
                done.synchronize()
        vals = np.concatenate([p[0].numpy() for p in parts])
        idxs = np.concatenate([p[1].numpy() for p in parts])
        L = self.cfg.L
        pk = triu_packing(L)
        results: List[List[Moment]] = []
        for b, row in enumerate(chunk):
            duration = row[2]
            moments = []
            for k in range(top_k):
                flat = int(idxs[b, k])
                if self.packed:
                    i, j = int(pk.i_idx[flat]), int(pk.j_idx[flat])
                else:
                    i, j = divmod(flat, L)
                moments.append(Moment(start=i * duration / L, end=(j + 1) * duration / L,
                                      score=float(vals[b, k])))
            results.append(moments)
        return results

    def localize_batch(self, requests: Sequence[Request], top_k: int = 5,
                       max_in_flight: int = 2) -> List[List[Moment]]:
        """Score (clip_features (nfeats, dv), query, duration_s) requests.

        Returns, per request, the top_k moments in descending score order.
        Up to ``max_in_flight`` chunks stay queued on the device while the
        host featurizes the next one."""
        results: List[List[Moment]] = []
        pending: List[Any] = []
        limit = max(1, max_in_flight)
        for chunk_start in range(0, len(requests), self.serve_batch):
            chunk = requests[chunk_start: chunk_start + self.serve_batch]
            while len(pending) >= limit:
                results.extend(self.collect(pending.pop(0)))
            pending.append(self.dispatch(chunk, top_k))
        for handle in pending:
            results.extend(self.collect(handle))
        return results

    def localize(self, clip_features: np.ndarray, query: str, duration: float,
                 top_k: int = 5) -> List[Moment]:
        """Single-request convenience wrapper."""
        return self.localize_batch([(clip_features, query, duration)], top_k)[0]


@dataclasses.dataclass
class _Pending:
    request: Request
    future: "Future[List[Moment]]"
    t_submit: float = 0.0


class ServingStats:
    """Lock-guarded latency and queue observability of the async path.

    Latencies are submit-to-result wall times over a sliding window of the
    most recent ``window`` requests; percentiles are computed on demand."""

    def __init__(self, window: int = 8192):
        self._lock = threading.Lock()
        self._window = window
        self._latencies: List[float] = []
        self._count = 0
        self._errors = 0
        self._batches = 0
        self._batch_sizes = 0
        self._max_queue_depth = 0
        self._t0 = time.monotonic()

    def record_queue_depth(self, depth: int) -> None:
        with self._lock:
            if depth > self._max_queue_depth:
                self._max_queue_depth = depth

    def record_batch(self, size: int) -> None:
        with self._lock:
            self._batches += 1
            self._batch_sizes += size

    def record_done(self, latency_s: float, error: bool = False) -> None:
        with self._lock:
            self._count += 1
            if error:
                self._errors += 1
            self._latencies.append(latency_s)
            if len(self._latencies) > self._window:
                del self._latencies[: -self._window]

    def snapshot(self) -> Dict[str, float]:
        """{count, errors, throughput_rps, mean_batch, max_queue_depth} over
        the server's lifetime, and {p50_ms, p99_ms, mean_ms, max_ms} over
        the sliding window once a request has completed."""
        with self._lock:
            lat = np.asarray(self._latencies, np.float64)
            count, errors = self._count, self._errors
            batches, sizes = self._batches, self._batch_sizes
            depth = self._max_queue_depth
            elapsed = max(time.monotonic() - self._t0, 1e-9)
        out = {
            "count": float(count),
            "errors": float(errors),
            "throughput_rps": count / elapsed,
            "mean_batch": sizes / batches if batches else 0.0,
            "max_queue_depth": float(depth),
        }
        if lat.size:
            out.update(
                p50_ms=float(np.percentile(lat, 50) * 1e3),
                p99_ms=float(np.percentile(lat, 99) * 1e3),
                mean_ms=float(lat.mean() * 1e3),
                max_ms=float(lat.max() * 1e3),
            )
        return out


class AsyncLocalizer:
    """Dynamic micro-batching front end for a MomentLocalizer.

    `submit()` enqueues one request and returns a Future. Two threads drain
    the queue:

    * the **batcher** coalesces whatever requests arrive within
      ``max_wait_ms`` (up to the localizer's serve_batch) into one group,
      featurizes it and dispatches its device call
      (`MomentLocalizer.dispatch`, which launches every kernel on this
      thread's current stream and returns at once), then starts on the next
      group;
    * the **completer** waits on the dispatched handles in FIFO order
      (`MomentLocalizer.collect`: the handle's own event) and resolves the
      futures.

    Up to ``max_in_flight`` groups sit on the device while the batcher
    featurizes the next one. A malformed request
    (`MomentLocalizer.check_request`) fails its own future and is left out
    of its group. A group whose dispatch or collect fails (a kernel fault
    surfaces at the event) sets that exception on each of its futures; each
    failed future counts as an error. The server keeps serving, and nothing
    is retried on another device or path. ``top_k`` is
    fixed per server. ``stats.snapshot()`` gives p50 / p99 / mean latency,
    throughput, mean batch size and the high-water queue depth.

    Use as a context manager, or call `close()` to drain and stop.
    """

    def __init__(self, localizer: MomentLocalizer, top_k: int = 5,
                 max_wait_ms: float = 2.0, max_in_flight: int = 2):
        self.localizer = localizer
        self.top_k = top_k
        self.max_wait_s = max_wait_ms / 1e3
        self.stats = ServingStats()
        self._queue: "queue.Queue[Optional[_Pending]]" = queue.Queue()
        # Dispatched, uncollected groups; bounded, so the batcher waits when
        # the device falls behind.
        self._inflight: "queue.Queue[Optional[Tuple[List[_Pending], Any]]]" = (
            queue.Queue(maxsize=max(1, max_in_flight)))
        self._closed = False
        # Guards the closed check and the enqueue, so a submit racing close()
        # cannot land behind the shutdown sentinel (its future would never
        # resolve).
        self._lock = threading.Lock()
        self._batcher = threading.Thread(target=self._run_batcher, daemon=True)
        self._completer = threading.Thread(target=self._run_completer, daemon=True)
        self._batcher.start()
        self._completer.start()

    def submit(self, clip_features: np.ndarray, query: str, duration: float,
               video_key: Any = None) -> "Future[List[Moment]]":
        """Enqueue one request. Requests that carry the same ``video_key``
        share one featurization and encode within a group (the grouped
        path of `MomentLocalizer.dispatch`)."""
        request = (clip_features, query, duration)
        if video_key is not None:
            request += (video_key,)
        p = _Pending(request, Future(), time.monotonic())
        with self._lock:
            if self._closed:
                raise RuntimeError("AsyncLocalizer is closed")
            self._queue.put(p)
            self.stats.record_queue_depth(self._queue.qsize())
        return p.future

    def localize(self, clip_features: np.ndarray, query: str,
                 duration: float) -> List[Moment]:
        """Synchronous convenience wrapper around submit()."""
        return self.submit(clip_features, query, duration).result()

    def close(self) -> None:
        """Drain outstanding requests and stop both threads."""
        with self._lock:
            already = self._closed
            if not already:
                self._closed = True
                self._queue.put(None)
        if not already:
            self._batcher.join()
            self._completer.join()

    def __enter__(self) -> "AsyncLocalizer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _fail(self, group: List[_Pending], exc: BaseException) -> None:
        now = time.monotonic()
        for p in group:
            if not p.future.done():
                p.future.set_exception(exc)
                self.stats.record_done(now - p.t_submit, error=True)

    def _well_formed(self, group: List[_Pending]) -> List[_Pending]:
        """The group without its malformed requests, whose futures fail."""
        kept = []
        for p in group:
            try:
                self.localizer.check_request(p.request)
            except (ValueError, TypeError, IndexError) as e:
                self._fail([p], e)
                continue
            kept.append(p)
        return kept

    def _run_batcher(self) -> None:
        done = False
        while not done:
            head = self._queue.get()
            if head is None:
                break
            group = [head]
            deadline = time.monotonic() + self.max_wait_s
            while len(group) < self.localizer.serve_batch:
                timeout = deadline - time.monotonic()
                try:
                    nxt = (self._queue.get_nowait() if timeout <= 0
                           else self._queue.get(timeout=timeout))
                except queue.Empty:
                    break
                if nxt is None:
                    done = True
                    break
                group.append(nxt)
            group = self._well_formed(group)
            if not group:
                continue
            self.stats.record_batch(len(group))
            try:
                handle = self.localizer.dispatch([p.request for p in group], self.top_k)
            except Exception as e:   # featurization or launch error: this group only
                self._fail(group, e)
                continue
            self._inflight.put((group, handle))   # blocks at max_in_flight
        self._inflight.put(None)                  # completer shutdown sentinel

    def _run_completer(self) -> None:
        while True:
            item = self._inflight.get()
            if item is None:
                return
            group, handle = item
            try:
                results = self.localizer.collect(handle)
            except Exception as e:   # a device fault reaches every caller of the group
                self._fail(group, e)
                continue
            now = time.monotonic()
            for p, r in zip(group, results):
                p.future.set_result(r)
                self.stats.record_done(now - p.t_submit)

"""Serving API: localize language-queried moments in new videos.

Counterpart of ``video_moment_localization_tpu/inference.py``
(`Moment`, `MomentLocalizer`):

    localizer = MomentLocalizer.from_checkpoint("config/charadessta.yml")
    moments = localizer.localize(clip_features, "person opens the door",
                                 duration=31.2, top_k=5)
    # -> [Moment(start=12.1, end=18.4, score=0.83), ...]

Host side: fixed-length eval sampling and GloVe query encoding. Device
side: the serving forward (models/smin.py `smin_forward_inference`, which
runs the fused biLSTM and SMI-stack kernels on the card), the final
proposal scores and the top-k (optionally soft-NMS) selection. Requests are
padded to a power-of-two ladder of batch buckets (1, 2, 4, ..., serve_batch).
Repeated videos in a chunk are featurized and encoded once (the grouped
path). Entry points run on the card unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from video_moment_localization_tpu_torch.config import Config, ModelConfig, load_config
from video_moment_localization_tpu_torch.data.glove import WordEmbedding
from video_moment_localization_tpu_torch.data.labels import build_masks
from video_moment_localization_tpu_torch.data.sampler import sample_fixed_length_features
from video_moment_localization_tpu_torch.data.tokenizer import get_tokens
from video_moment_localization_tpu_torch.models.smin import SMIN, smin_forward_inference
from video_moment_localization_tpu_torch.ops.nms import soft_nms_topk
from video_moment_localization_tpu_torch.ops.packing import triu_packing
from video_moment_localization_tpu_torch.train.metrics import proposal_scores_packed
from video_moment_localization_tpu_torch.utils.checkpoint import checkpoint_paths, load_checkpoint

Request = Tuple[Any, ...]   # (clip_features (nfeats, dv), query, duration_s[, video_key])


@dataclasses.dataclass(frozen=True)
class Moment:
    start: float   # seconds
    end: float     # seconds
    score: float


def bucket_sizes(serve_batch: int) -> List[int]:
    """The batch ladder 1, 2, 4, ... below serve_batch, then serve_batch."""
    sizes, b = [], 1
    while b < serve_batch:
        sizes.append(b)
        b *= 2
    return sizes + [serve_batch]


def topk_lowest_index_first(score: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, ties to the lower index (as jax.lax.top_k):
    a stable descending sort keeps equal scores in index order."""
    vals, idxs = torch.sort(score, dim=-1, descending=True, stable=True)
    return vals[..., :k], idxs[..., :k]


class MomentLocalizer:
    """Batched moment-localization scorer around a SMIN model.

    On a CUDA device the constructor turns TF32 off for the process
    (``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32``): the serving path is fp32
    throughout, as the JAX fp32 kernels run at HIGHEST precision."""

    def __init__(self, model_cfg: ModelConfig, model: SMIN, embedding: WordEmbedding,
                 serve_batch: int = 16, use_nms: bool = False, nms_sigma: float = 0.5,
                 device: str = "cuda"):
        self.cfg = model_cfg
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("MomentLocalizer: no CUDA device; pass device='cpu' "
                                   "to serve on the CPU")
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.model = model.to(self.device).eval()
        self.embedding = embedding
        self.use_nms = use_nms
        self.nms_sigma = nms_sigma
        self.serve_batch = serve_batch
        self.bucket_sizes = bucket_sizes(serve_batch)

    def _bucket_for(self, n: int) -> int:
        for b in self.bucket_sizes:
            if b >= n:
                return b
        return self.serve_batch

    # ------------------------------------------------------------------ #
    @classmethod
    def from_checkpoint(cls, config_path: str, glove_path: Optional[str] = None,
                        serve_batch: int = 16, use_nms: Optional[bool] = None,
                        device: str = "cuda") -> "MomentLocalizer":
        """Load the experiment's reference-format checkpoint. use_nms=None
        inherits the config's ``nms`` eval setting."""
        cfg: Config = load_config(config_path)
        embedding = WordEmbedding.load(glove_path)
        model_path, _ = checkpoint_paths(cfg.checkpoint_path, cfg.experiment)
        ckpt = load_checkpoint(model_path)
        if ckpt is None:
            raise FileNotFoundError(f"No saved model at {model_path}!")
        model = SMIN(cfg.model)
        model.load_state_dict(ckpt["model"], strict=True)
        return cls(cfg.model, model, embedding, serve_batch=serve_batch,
                   use_nms=cfg.nms if use_nms is None else use_nms,
                   nms_sigma=cfg.nms_sigma, device=device)

    # ------------------------------------------------------------------ #
    def _prepare_video(self, clip_features: np.ndarray):
        cfg = self.cfg
        vf, nfeats, _, _ = sample_fixed_length_features(
            np.asarray(clip_features, np.float32), cfg.T, 0.0, 1.0)
        video_mask, length_mask, _ = build_masks(nfeats, cfg.T, cfg.L)
        return vf, video_mask, length_mask

    def _prepare_query(self, query: str):
        token_ids, qf = self.embedding.encode(get_tokens(query), self.cfg.max_query_length)
        qm = self.embedding.query_mask(token_ids)[:, None]
        return qf, qm

    @torch.no_grad()
    def _score(self, vf, vm, qf, qm, lm, k: int, vidx=None):
        """(values, indices) (B, k) of the top-k packed proposals."""
        video_group = None if vidx is None else (vf, vm, vidx)
        pm, ps, pe, _ = smin_forward_inference(
            self.model, self.cfg, None if vidx is not None else vf,
            None if vidx is not None else vm, qf, qm, lm, video_group=video_group)
        score = proposal_scores_packed(pm, ps, pe, lm, self.cfg.L)
        if self.use_nms:
            return soft_nms_topk(score, self.cfg.L, k, self.nms_sigma)
        return topk_lowest_index_first(score, k)

    def dispatch(self, chunk: Sequence[Request], top_k: int = 5):
        """Prepare and enqueue ONE chunk (<= serve_batch) on the device.

        Returns a handle for :meth:`collect`. Kernels run asynchronously:
        this blocks only for host featurization and the copies to the
        device. Rows that carry a 4th element ``video_key`` share one
        featurization and one device encode per key; without it the key is
        the array's identity. When the unique videos fit a bucket at most
        half the pair bucket, the chunk takes the grouped-video path."""
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
            return torch.from_numpy(arr).to(self.device)

        per_row_v = [vid_rows[k][1] for k in vkeys]
        qf = stack([q_cache[row[1]][0] for row in chunk], pad)
        qm = stack([q_cache[row[1]][1] for row in chunk], pad)
        lm = stack([v[2] for v in per_row_v], pad)
        if self._bucket_for(len(uniq)) * 2 <= bucket:
            gpad = self._bucket_for(len(uniq)) - len(uniq)
            vf_g = stack([v[0] for v in uniq], gpad)
            vm_g = stack([v[1] for v in uniq], gpad)
            gidx = torch.as_tensor(vidx + [0] * pad, dtype=torch.int64).to(self.device)
            vals, idxs = self._score(vf_g, vm_g, qf, qm, lm, top_k, gidx)
        else:
            vf = stack([v[0] for v in per_row_v], pad)
            vm = stack([v[1] for v in per_row_v], pad)
            vals, idxs = self._score(vf, vm, qf, qm, lm, top_k)
        return chunk, top_k, vals, idxs

    def collect(self, handle) -> List[List[Moment]]:
        """Wait for a :meth:`dispatch` handle and build the Moment lists."""
        chunk, top_k, vals, idxs = handle
        vals, idxs = vals.cpu().numpy(), idxs.cpu().numpy()
        L = self.cfg.L
        pk = triu_packing(L)
        results: List[List[Moment]] = []
        for b, row in enumerate(chunk):
            duration = row[2]
            moments = []
            for k in range(top_k):
                flat = int(idxs[b, k])
                i, j = int(pk.i_idx[flat]), int(pk.j_idx[flat])
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

"""Sequence-parallel proposal pooling: the clip axis T sharded over the
ranks of a seq group.

Counterpart of ``video_moment_localization_tpu/parallel/sequence.py``. The
reference bounds a video by downsampling it to T <= 128 on the host; this is
the path for longer videos: segment means decompose exactly into per-shard
partial sums. Each of the n ranks of the group

1. holds a contiguous (B, T/n, D) clip shard and takes its fp32 prefix sums;
2. forms the partial sum of every clip of the map with the clip's bounds
   clipped to the shard;
3. reduce-scatters them (`collectives.reduce_scatter`: a sum, and each rank
   keeps its own block of L/n map rows, so the (L, L, C, D) map's memory
   also scales 1/n);
4. applies its rows of the segment weights and of the moment mask; the
   boundary features come from its own shard alone (when n | L, a shard's
   frames are exactly L/n snippets).

Outputs are row blocks: fc (B, L/n, L, C, D), fm (B, L/n, L, D), fb
(B, L/n, D), in f's dtype.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from video_moment_localization_tpu_torch.ops.content_matrix import content_segments
from video_moment_localization_tpu_torch.parallel.collectives import (
    group_rank,
    group_size,
    reduce_scatter,
)


def check_seq_widths(n: int, L: int, T: int) -> None:
    """ValueError unless the seq group's size n divides L and T (the JAX
    package's check, with its message)."""
    if L % n != 0 or T % n != 0:
        raise ValueError(f"seq mesh size {n} must divide L ({L}) and T ({T})")


def partial_clip_sums(f_loc: torch.Tensor, starts: np.ndarray, ends: np.ndarray,
                      k: int) -> torch.Tensor:
    """(B, M, D) fp32 partial sums over the frames of shard k of M clips
    [starts, ends) of the whole video, from the shard f_loc (B, T/n, D): a
    difference of the shard's prefix sums at the clip's bounds clipped to the
    shard."""
    B, T_loc, D = f_loc.shape
    P = torch.cumsum(f_loc.float(), dim=1)
    P = torch.cat([P.new_zeros((B, 1, D)), P], dim=1)                 # (B, T/n + 1, D)
    off = k * T_loc
    cs = torch.from_numpy(np.clip(starts - off, 0, T_loc).astype(np.int64)).to(f_loc.device)
    ce = torch.from_numpy(np.clip(ends - off, 0, T_loc).astype(np.int64)).to(f_loc.device)
    return P[:, ce] - P[:, cs]


def snippet_means(f_loc: torch.Tensor, snippets: int) -> torch.Tensor:
    """(B, snippets, D) window means of the shard (B, T/n, D)."""
    B, T_loc, D = f_loc.shape
    return f_loc.reshape(B, snippets, T_loc // snippets, D).mean(dim=2)


def proposal_features_seq_sharded(f_loc: torch.Tensor, moment_mask_rows: torch.Tensor, L: int,
                                  C: int, group) -> Tuple[torch.Tensor, torch.Tensor,
                                                          torch.Tensor]:
    """This rank's row block of the proposal features (fc, fm, fb) from its
    clip shard f_loc (B, T/n, D) and its rows of the moment mask (B, L/n, L);
    n the size of ``group`` (the seq group). Raises ValueError unless n
    divides L and T."""
    B, T_loc, D = f_loc.shape
    n, k = group_size(group), group_rank(group)
    T = T_loc * n
    check_seq_widths(n, L, T)
    rows = L // n
    seg = content_segments(T, L, C)
    part = partial_clip_sums(f_loc, seg.starts.reshape(-1),
                             (seg.starts + seg.sizes).reshape(-1), k)    # (B, L*L*C, D)
    sums = reduce_scatter(part.reshape(B, L, L * C * D), 1, group)
    sums = sums.reshape(B, rows, L, C, D)
    w_rows = torch.from_numpy(seg.weights[k * rows:(k + 1) * rows]).to(f_loc.device)
    fc = sums * w_rows[None, ..., None]                                 # segment means
    fc = fc * moment_mask_rows[..., None, None]
    fm = fc.mean(dim=3)
    fb = snippet_means(f_loc, rows)
    return fc.to(f_loc.dtype), fm.to(f_loc.dtype), fb

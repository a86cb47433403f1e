"""Triangular-packed proposal-map layout.

Counterpart of ``video_moment_localization_tpu/ops/packing.py``: the L x L
moment map is packed to its N = L(L+1)/2 valid (start i <= end j) pairs in
``np.triu_indices`` order, and the SMI stack runs in (B, N, ...) layout.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TriuPacking:
    """Static packing metadata for an L x L upper-triangular map."""

    L: int
    N: int                   # number of valid pairs = L(L+1)/2
    i_idx: np.ndarray        # (N,) start-snippet index per pair
    j_idx: np.ndarray        # (N,) end-snippet index per pair
    flat_idx: np.ndarray     # (N,) i * L + j (into a flattened dense map)
    row_onehot: np.ndarray   # (L, N) float32: row_onehot[i, n] = [i_idx[n] == i]


@lru_cache(maxsize=None)
def triu_packing(L: int) -> TriuPacking:
    i_idx, j_idx = np.triu_indices(L)
    i_idx = i_idx.astype(np.int32)
    j_idx = j_idx.astype(np.int32)
    N = i_idx.shape[0]
    row_onehot = np.zeros((L, N), np.float32)
    row_onehot[i_idx, np.arange(N)] = 1.0
    return TriuPacking(L=L, N=N, i_idx=i_idx, j_idx=j_idx,
                       flat_idx=(i_idx * L + j_idx).astype(np.int32),
                       row_onehot=row_onehot)


def pair_index(L: int, device) -> tuple:
    """(i_idx, j_idx) as int64 tensors on ``device``, for index_select."""
    p = triu_packing(L)
    return (torch.from_numpy(p.i_idx.astype(np.int64)).to(device),
            torch.from_numpy(p.j_idx.astype(np.int64)).to(device))


def packed_valid_mask(length_mask: torch.Tensor) -> torch.Tensor:
    """(B, L) length mask -> (B, N) packed validity (triu is implicit)."""
    i_idx, j_idx = pair_index(length_mask.shape[1], length_mask.device)
    return length_mask[:, i_idx] * length_mask[:, j_idx]


def unpack_map(x: torch.Tensor, L: int) -> torch.Tensor:
    """(B, N, ...) -> dense (B, L, L, ...) with zeros at invalid pairs."""
    p = triu_packing(L)
    B = x.shape[0]
    dense = x.new_zeros((B, L * L) + tuple(x.shape[2:]))
    dense[:, torch.from_numpy(p.flat_idx.astype(np.int64)).to(x.device)] = x
    return dense.reshape((B, L, L) + tuple(x.shape[2:]))


def pack_rows(fc: torch.Tensor) -> torch.Tensor:
    """(B, N, C, D) packed n-major (the port's layout) -> (B, C*N, D) c-major
    rows (row c*N + n), the layout of the JAX package's train kernels."""
    B, N, C, D = fc.shape
    return fc.permute(0, 2, 1, 3).reshape(B, C * N, D)


def unpack_rows(rows: torch.Tensor, N: int, C: int) -> torch.Tensor:
    """(B, C*N, D) c-major rows -> (B, N, C, D)."""
    B, _, D = rows.shape
    return rows.reshape(B, C, N, D).permute(0, 2, 1, 3)

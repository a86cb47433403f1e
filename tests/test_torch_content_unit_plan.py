"""The moment gate's backward as K10 and K3 launch it (csrc/content_bwd.cuh
`gate_bwd_kernel`), on the CPU: its Python mirror's split of an element's
pairs, and the split arithmetic (each split's share of dfs, the splits
added in order) against autograd through the gate. The mirror is held to
the C code by the card test `test_gate_bwd_splits_match_their_mirror`."""

import os

import numpy as np
import pytest
import torch

from video_moment_localization_tpu_torch.config import load_config
from video_moment_localization_tpu_torch.ops import content_cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("B", (1, 8, 64, 512))
@pytest.mark.parametrize("N", (1, 136, 2080))
@pytest.mark.parametrize("cols", (8, 130, 520))
def test_gate_splits_cover_every_pair_once(B, N, cols):
    splits = content_cuda.gate_bwd_splits(B, N, cols)
    assert 1 <= splits <= min(content_cuda.GATE_MAX_SPLITS, N)
    ranges = content_cuda.gate_bwd_ranges(N, splits)
    covered = [n for lo, hi in ranges for n in range(lo, hi)]
    assert covered == list(range(N))
    col_blocks = -(-cols // content_cuda.GATE_THREADS)
    if splits < min(content_cuda.GATE_MAX_SPLITS, N):   # not capped: the card fills
        assert B * col_blocks * splits >= 4 * content_cuda.SMS


def test_gate_splits_at_the_charades_width():
    """K10 at Charades B=64 (N = 136 pairs, D = 512 in 128 groups of 4): 9
    splits of 16 pairs, 576 blocks of 128 threads, where one block per
    element walked all 136 pairs column by column before."""
    cfg = load_config(os.path.join(REPO, "config", "charadessta.yml")).model
    N = cfg.L * (cfg.L + 1) // 2
    splits = content_cuda.gate_bwd_splits(64, N, cfg.D // 4)
    assert splits == 9
    assert [hi - lo for lo, hi in content_cuda.gate_bwd_ranges(N, splits)] == [16] * 8 + [8]


@pytest.mark.parametrize("B,N,D", [(3, 10, 8), (2, 136, 12), (64, 36, 4)])
def test_split_gate_backward_is_the_gate_gradient(B, N, D):
    """dfm = dfbar (s + z s (1 - s)) and dfs = sum_n dfbar fm^2 s (1 - s),
    z = fm fs, s = sigmoid(z), with dfs summed split by split in the
    kernel's order, against autograd through fbar = sigmoid(fm fs) fm."""
    rng = np.random.default_rng(B * N + D)
    fm = torch.from_numpy(rng.standard_normal((B, N, D)).astype(np.float32))
    fs = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32))
    dfbar = torch.from_numpy(rng.standard_normal((B, N, D)).astype(np.float32))
    leaves = [fm.clone().requires_grad_(True), fs.clone().requires_grad_(True)]
    fbar = torch.sigmoid(leaves[0] * leaves[1][:, None]) * leaves[0]
    want_dfm, want_dfs = torch.autograd.grad(fbar, leaves, dfbar)

    z = fm * fs[:, None]
    s = torch.sigmoid(z)
    t = s * (1 - s)
    dfm = dfbar * (s + z * t)
    share = dfbar * fm * fm * t
    splits = content_cuda.gate_bwd_splits(B, N, D // 4)
    dfs = torch.zeros(B, D)
    for lo, hi in content_cuda.gate_bwd_ranges(N, splits):
        part = torch.zeros(B, D)
        for n in range(lo, hi):
            part = part + share[:, n]
        dfs = dfs + part
    torch.testing.assert_close(dfm, want_dfm, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dfs, want_dfs, rtol=1e-5, atol=1e-5)

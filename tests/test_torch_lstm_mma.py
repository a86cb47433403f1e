"""K5-bf16's recurrence on the tensor cores (csrc/lstm.cu,
`lstm_layer_mma_kernel`), on the CPU: its plan through the Python mirror
(ops/lstm_cuda.py: clusters of 4 CTAs, rows per cluster, shared memory),
the lane-to-gate map of its mma.sync fragments, and a numpy mirror of its
step's arithmetic (bf16 products, fp32 sums in the MMA's k order, 16 k at a
time, fp32 gates, c and carried h, h rounded to bf16 for the next product)
held to the plain bf16 biLSTM, `models/lstm.py::bilstm_bf16`, at the card
tests' tolerance. chip_smoke.py holds the mirror plan against the C plan and
the kernel against `bilstm_bf16` at every rows-per-cluster choice.
"""

import numpy as np
import pytest
import torch

from video_moment_localization_tpu_torch.models.lstm import BiLSTMParams, bilstm_bf16, lstm_layers
from video_moment_localization_tpu_torch.models.smin import cast_weights
from video_moment_localization_tpu_torch.ops import lstm_cuda
from video_moment_localization_tpu_torch.ops.cuda_build import MAX_SMEM_BYTES

# tests/test_torch_cuda.py's K5_BF16_TOL: tests/test_lstm_pallas.py's bf16
# 0.05 cut fivefold.
K5_BF16_TOL = dict(rtol=1e-2, atol=1e-2)
H = 256


def test_bf16_plan_is_four_ctas_and_its_rows_fit_a_block():
    """Each CTA keeps 4H/4 rows of W_hh and two copies of h, rows of H + 8
    bf16: 80 rows at most at H=256 (96 would need 236,544 bytes)."""
    assert lstm_cuda.CLUSTER_BF16 == 4
    assert lstm_cuda.row_choices(H, 2) == (16, 32, 48, 64, 80)
    assert lstm_cuda.lstm_smem_bytes(H, 16, 2) == 2 * (H + 8) * (H + 2 * 16) == 152064
    assert lstm_cuda.lstm_smem_bytes(H, 80, 2) == 219648 <= MAX_SMEM_BYTES
    assert lstm_cuda.lstm_smem_bytes(H, 96, 2) > MAX_SMEM_BYTES
    for h in (32, 64, 128, 256):
        for rows in lstm_cuda.row_choices(h, 2):
            assert lstm_cuda.lstm_smem_bytes(h, rows, 2) <= MAX_SMEM_BYTES
    assert lstm_cuda.row_choices(32, 2)[-1] == lstm_cuda.MAX_ROWS


@pytest.mark.parametrize("B,max_active,rows", [
    (1, 33, 16), (8, 33, 16), (16, 32, 16), (64, 32, 16), (256, 32, 16), (257, 32, 32),
    (512, 33, 32), (512, 32, 32), (512, 31, 48), (520, 33, 48), (1024, 33, 64), (4096, 33, 80)])
def test_bf16_plan_takes_the_fewest_rows_of_one_wave(B, max_active, rows):
    """The card holds about 33 clusters of 4 CTAs (one an SM): B=512 takes
    32 rows a cluster, 32 clusters in one wave; past 80 rows it takes 80."""
    got, clusters = lstm_cuda.lstm_plan(B, H, lambda r: max_active, itemsize=2)
    assert got == rows and clusters == 2 * -(-B // rows)
    smaller = [r for r in lstm_cuda.row_choices(H, 2) if r < rows]
    assert all(2 * -(-B // r) > max_active for r in smaller)


def fragment_rows(rank: int, warp: int, lane: int, H: int = H):
    """The W_hh rows behind lane `lane` of warp `warp` in CTA `rank`: [g][v]
    = the torch row of the accumulator of gate g and unit v of the lane, by
    the kernel's index arithmetic (local slice row g*U + u is W_hh row g*H +
    rank*U + u; n8 tile g of the warp's unit group covers local rows g*U +
    8 ug .. +7; an m16n8 accumulator's lane holds columns 2 (lane % 4) and
    2 (lane % 4) + 1)."""
    U = H // lstm_cuda.CLUSTER_BF16
    nug = U // 8
    ug = warp % nug
    rows = []
    for g in range(4):
        local = [g * U + ug * 8 + 2 * (lane % 4) + v for v in range(2)]
        rows.append([(lr // U) * H + rank * U + lr % U for lr in local])
    return rows


@pytest.mark.parametrize("h", [32, 128, 256])
def test_fragments_hold_the_four_gates_of_two_units(h):
    """Every lane's accumulators are the i, f, g, o rows of its two hidden
    units, and the CTAs' warps cover every unit once per row group."""
    U = h // lstm_cuda.CLUSTER_BF16
    nug = U // 8
    wpu = 16 // nug          # 512 threads a CTA: 16 warps
    seen = set()
    for rank in range(lstm_cuda.CLUSTER_BF16):
        for warp in range(nug * wpu):
            for lane in range(32):
                rows = fragment_rows(rank, warp, lane, h)
                j = rank * U + (warp % nug) * 8 + 2 * (lane % 4)
                assert rows == [[g * h + j, g * h + j + 1] for g in range(4)]
                if warp < nug:
                    seen.update((j, j + 1))
    assert seen == set(range(h))


def _bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16().float().numpy()


def _sigmoid(x):
    return np.float32(1) / (np.float32(1) + np.exp(-x))


def mma_direction(xp, mask, w_hh, b_hh):
    """One direction as the kernel steps it: xp (B, S, 4H) bf16 values,
    w_hh (4H, H) bf16 values, b_hh fp32 -> (B, S, H) bf16 values. The
    product over h in 16-k blocks in order, each block's 16 exact products
    summed in fp32 and added to the fp32 accumulator, as mma.sync m16n8k16
    accumulates."""
    B, S, _ = xp.shape
    Hh = w_hh.shape[1]
    h = np.zeros((B, Hh), np.float32)
    c = np.zeros((B, Hh), np.float32)
    wt = w_hh.T.astype(np.float32)                    # (H, 4H)
    out = np.zeros((B, S, Hh), np.float32)
    for t in range(S):
        hq = _bf16(h)
        acc = np.zeros((B, 4 * Hh), np.float32)
        for k0 in range(0, Hh, 16):
            part = np.zeros_like(acc)
            for k in range(k0, k0 + 16):
                part += hq[:, k:k + 1] * wt[k][None, :]
            acc += part
        gates = acc + xp[:, t] + b_hh[None, :]
        gi, gf, gg, go = (gates[:, q * Hh:(q + 1) * Hh] for q in range(4))
        c_new = _sigmoid(gf) * c + _sigmoid(gi) * np.tanh(gg)
        h_new = _sigmoid(go) * np.tanh(c_new)
        m = mask[:, t:t + 1]
        h = m * h_new + (np.float32(1) - m) * h
        c = m * c_new + (np.float32(1) - m) * c
        out[:, t] = _bf16(h * m)
    return out


def mma_bilstm(x, mask, layers):
    """Both layers and directions through `mma_direction`; the input
    projections as `bilstm_bf16` makes them (the library's bf16 product at
    layer 1, fp32 sums rounded once at layer 2)."""
    bf = torch.bfloat16
    h = x
    for k, p in enumerate(layers):
        outs = []
        for direction in ("fwd", "bwd"):
            d = p[direction]
            if k == 0:
                xp = torch.nn.functional.linear(h, d["w_ih"], d["b_ih"].to(bf))
            else:
                xp = (h.float() @ d["w_ih"].float().t() + d["b_ih"].float()).to(bf)
            xp, m = xp.float().numpy(), mask.numpy()
            args = (d["w_hh"].float().numpy(), d["b_hh"].float().numpy())
            if direction == "fwd":
                y = mma_direction(xp, m, *args)
            else:
                y = mma_direction(xp[:, ::-1], m[:, ::-1], *args)[:, ::-1]
            outs.append(torch.from_numpy(np.ascontiguousarray(y)).to(bf))
        h = torch.cat(outs, dim=-1)
    return h


def test_mma_step_mirror_matches_plain_bf16():
    """Nq=13 steps at B=16, H=256, ragged lengths (one of 1, one full):
    the kernel's arithmetic within K5_BF16_TOL of `bilstm_bf16`, padded steps
    0."""
    rng = np.random.default_rng(0)
    torch.manual_seed(0)
    B, S = 16, 13
    lstm = BiLSTMParams(300, H, 2)
    layers = lstm_layers(lstm, cast_weights(lstm, torch.bfloat16))
    x = torch.from_numpy((rng.standard_normal((B, S, 300)) * 0.5).astype(np.float32)).bfloat16()
    lengths = rng.integers(1, S + 1, size=B)
    lengths[0], lengths[-1] = 1, S
    mask = torch.from_numpy((np.arange(S)[None, :] < lengths[:, None]).astype(np.float32))
    with torch.no_grad():
        got = mma_bilstm(x, mask, layers)
        want = bilstm_bf16(x, mask, layers)
    torch.testing.assert_close(got.float(), want.float(), **K5_BF16_TOL)
    assert bool((got[mask == 0] == 0).all())

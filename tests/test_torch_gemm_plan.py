"""The host-side plans of the port's shared fp32 GEMM (csrc/gemm.cuh) and of
K5's recurrence (csrc/lstm.cu), through their Python mirrors
(ops/gemm_cuda.py, ops/lstm_cuda.py), on the CPU: every product that K2-K5,
K7, K9 and K10 launch for the three shipped configs is admitted (a grid the
card takes, shared memory within a block's 227 KB, split-K covering its
rows), the tile and split choices keep their rules, and a numpy mirror of
gemm_tn's fused column sum, in its fixed order, agrees with float64 within
fp32 rounding. chip_smoke.py holds each mirror against the C plan on the
card; the GEMM's results are held there and in tests/test_torch_cuda.py.
"""

import os

import numpy as np
import pytest
import torch

from video_moment_localization_tpu_torch.config import load_config
from video_moment_localization_tpu_torch.ops import gemm_cuda, lstm_cuda
from video_moment_localization_tpu_torch.ops.cuda_build import MAX_SMEM_BYTES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ("charadessta", "activitynet", "tacos")
BATCHES = (1, 16, 64, 512)
MAX_GRID_X = 2 ** 31 - 1
MAX_GRID_YZ = 65535


def _cfg(name):
    return load_config(os.path.join(REPO, "config", f"{name}.yml")).model


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("config", CONFIGS)
def test_every_model_gemm_is_admitted(config, B):
    shapes = gemm_cuda.model_gemm_shapes(_cfg(config), B)
    kernels = {s[0] for s in shapes}
    assert kernels == {"K2", "K3", "K4", "K5", "K7f", "K7b", "K9", "K10f", "K10b"}
    for kernel, name, layout, M, N, K, groups in shapes:
        assert min(M, N, K) >= 1 and groups in (1, 2), (kernel, name)
        tile, grid_x, grid_z = gemm_cuda.launch_grid(layout, M, N, K, groups)
        assert 1 <= grid_x <= MAX_GRID_X and grid_z <= MAX_GRID_YZ, (kernel, name)
        # On its chosen path, the blocks an SM holds share its 228 KB (1 KB
        # of it reserved per block), and one is within the 227 KB it may have.
        path = gemm_cuda.site_path(name, layout, M, N, K, groups)
        assert path in (gemm_cuda.CUDA_CORE, gemm_cuda.TENSOR)
        if name == gemm_cuda.MOMENT_PRODUCT:
            assert path == gemm_cuda.TENSOR
        elif layout == "tn":
            rows = gemm_cuda.splitk_for(M, N, K)[1]
            assert path == (gemm_cuda.TENSOR if rows >= gemm_cuda.WG_MIN_ROWS
                            else gemm_cuda.CUDA_CORE)
        else:
            big = M * N * K >= gemm_cuda.TC_MIN_WORK
            assert path == (gemm_cuda.TENSOR if big else gemm_cuda.CUDA_CORE)
        per_sm = gemm_cuda.blocks_per_sm(layout, path)
        assert per_sm * (gemm_cuda.smem_bytes(tile, layout, path) + 1024) <= 228 * 1024
        assert gemm_cuda.smem_bytes(tile, layout, path) <= MAX_SMEM_BYTES
        plan = gemm_cuda.plan(layout, M, N, K, groups, name)
        assert plan["tile"] == tile
        assert plan["path"] == path
        bm, bn = gemm_cuda.TILES[tile]
        assert grid_x == -(-M // bm) * -(-N // bn)
        if layout == "tn":
            splits, kchunk = gemm_cuda.splitk_for(M, N, K)
            assert kchunk % gemm_cuda.BK == 0 and splits == grid_z
            assert (splits - 1) * kchunk < K <= splits * kchunk, (kernel, name)
            floats = gemm_cuda.tn_partial_floats(M, N, K)
            assert floats == splits * (M * N + M) and floats * 4 < 2 ** 34


@pytest.mark.parametrize("B", BATCHES + (17, 520))
@pytest.mark.parametrize("config", CONFIGS)
def test_lstm_plan_fits_a_block(config, B):
    cfg = _cfg(config)
    H = cfg.lstm_hidden_size
    choices = lstm_cuda.row_choices(H)
    assert choices[-1] == lstm_cuda.MAX_ROWS
    for rows in choices:
        assert lstm_cuda.lstm_smem_bytes(H, rows) <= MAX_SMEM_BYTES
    # The H100 holds 15 clusters of 8 CTAs (one per SM) on its GPCs.
    rows, clusters = lstm_cuda.lstm_plan(B, H, lambda r: 15)
    assert rows in choices and clusters == 2 * -(-B // rows)
    assert rows * clusters // 2 >= B and (clusters <= 15 or rows == choices[-1])


@pytest.mark.parametrize("B,max_active,rows", [
    (1, 15, 16), (16, 15, 16), (17, 15, 16), (64, 15, 16), (65, 6, 32), (256, 16, 32),
    (512, 16, 64), (512, 15, 80), (520, 15, 80), (512, 14, 80), (1024, 15, 96), (64, 6, 32)])
def test_lstm_plan_takes_the_fewest_rows_of_one_wave(B, max_active, rows):
    got, clusters = lstm_cuda.lstm_plan(B, 256, lambda r: max_active)
    assert got == rows
    if clusters <= max_active:
        smaller = [r for r in lstm_cuda.row_choices(256) if r < rows]
        assert all(2 * -(-B // r) > max_active for r in smaller)


def test_lstm_smem_matches_the_layout():
    # W_hh slice (256, 129) and h (rows, 256), double-buffered up to 48 rows.
    assert lstm_cuda.lstm_smem_bytes(256, 16) == 4 * (256 * 129 + 2 * 16 * 256)
    assert lstm_cuda.lstm_smem_bytes(256, 48) == 4 * (256 * 129 + 2 * 48 * 256)
    assert lstm_cuda.lstm_smem_bytes(256, 64) == 4 * (256 * 129 + 64 * 256)
    assert lstm_cuda.lstm_smem_bytes(256, 96) == 4 * (256 * 129 + 96 * 256)
    assert lstm_cuda.max_rows(256) == 96 and lstm_cuda.max_rows(32) == 96


@pytest.mark.parametrize("M,N,groups", [
    (208, 1024, 2), (8704, 128, 1), (8704, 512, 1), (532480, 128, 1), (532480, 512, 1),
    (133120, 512, 1), (6656, 1024, 2), (1, 1, 1), (64, 4096, 1)])
def test_tile_choice_fills_the_sms(M, N, groups):
    tile = gemm_cuda.tile_for(M, N, groups)
    enough = [gemm_cuda.tiles(t, M, N) * groups >= 2 * gemm_cuda.SMS for t in range(3)]
    assert tile == 2 or enough[tile]
    assert not any(enough[:tile])


@pytest.mark.parametrize("M,N,R", [(512, 128, 532480), (128, 128, 532480), (128, 512, 1280),
                                   (512, 512, 133120), (128, 512, 64), (30, 10, 1),
                                   (512, 512, 832)])
def test_splitk_aims_at_two_waves(M, N, R):
    splits, kchunk = gemm_cuda.splitk_for(M, N, R)
    tiles = gemm_cuda.tiles(0, M, N)
    # One wave of 128x128 blocks, two per SM, unless the rows run out first
    # (at least 64 per split); rounding a split up to a K slice may cost one.
    want = max(1, min(2 * gemm_cuda.SMS // tiles, -(-R // 64)))
    assert splits * tiles <= max(2 * gemm_cuda.SMS, tiles)
    assert want - 1 <= splits <= want and splits >= 1
    assert (splits - 1) * kchunk < R <= splits * kchunk


def _fused_colsum_fp32(a, scale, adiv, kchunk):
    """gemm_tn's column sums in its order: block z adds its rows' scaled
    values one row at a time in fp32; the reduction adds the splits in
    ascending order."""
    rows = np.arange(a.shape[0]) // adiv
    scaled = (a * scale[rows][:, None]).astype(np.float32)
    parts = [np.add.accumulate(scaled[z:z + kchunk], axis=0, dtype=np.float32)[-1]
             for z in range(0, a.shape[0], kchunk)]
    return np.add.accumulate(np.stack(parts), axis=0, dtype=np.float32)[-1], len(parts)


@pytest.mark.parametrize("R,M,adiv", [(1, 128, 1), (63, 10, 1), (1000, 128, 4),
                                      (133120, 16, 1), (532480, 8, 4)])
def test_fused_bias_sum_order_within_fp32_rounding(R, M, adiv):
    rng = np.random.default_rng(R)
    a = rng.standard_normal((R, M)).astype(np.float32)
    scale = (rng.random(-(-R // adiv)) > 0.3).astype(np.float32)
    splits, kchunk = gemm_cuda.splitk_for(M, 128, R)
    got, parts = _fused_colsum_fp32(a, scale, adiv, kchunk)
    assert parts == splits
    want = (a.astype(np.float64) * scale[np.arange(R) // adiv][:, None]).sum(axis=0)
    # Recursive fp32 summation: at most (terms - 1) roundings of 2^-24 of the
    # running sum of magnitudes (kchunk per split, then splits).
    terms = kchunk + splits
    mag = np.abs(a.astype(np.float64) * scale[np.arange(R) // adiv][:, None]).sum(axis=0)
    bound = terms * 2.0 ** -24 * mag + 1e-30
    assert np.all(np.abs(got - want) <= bound)


@pytest.mark.parametrize("layout", ["nt", "nn", "tn"])
def test_gemm_plain_against_float64(layout):
    rng = np.random.default_rng(0)
    M, N, K = 37, 19, 23
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))   # noqa: E731
    A = f(K, M) if layout == "tn" else f(M, K)
    W = f(N, K) if layout == "nt" else f(K, N)
    ascale = None if layout == "nt" else torch.from_numpy(
        (rng.random(A.shape[0] // 2 + 1) > 0.4).astype(np.float32))
    if layout == "tn":
        got, cs = gemm_cuda.gemm("tn", A, W, ascale=ascale, adiv=2, bias_sums=True)
        As = A.double() * ascale.double()[torch.arange(K) // 2][:, None]
        torch.testing.assert_close(got.double(), As.t() @ W.double(), rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(cs.double(), As.sum(0), rtol=1e-5, atol=1e-5)
        return
    terms = dict(bias=f(N), pre=f(M, N), rmask=(torch.arange(M // 3 + 1) % 2).float(),
                 mask_div=3, post=f(M, N), post2=f(M // 2 + 1, N), post2_div=2)
    got = gemm_cuda.gemm(layout, A, W, ascale=ascale, adiv=2, **terms)
    As = A.double()
    if ascale is not None:
        As = As * ascale.double()[torch.arange(M) // 2][:, None]
    ref = As @ (W.double().t() if layout == "nt" else W.double())
    rows = torch.arange(M)
    ref = ((ref + terms["bias"].double() + terms["pre"].double())
           * terms["rmask"].double()[rows // 3][:, None]
           + terms["post"].double() + terms["post2"].double()[rows // 2])
    torch.testing.assert_close(got.double(), ref, rtol=1e-5, atol=1e-5)

"""The host-side plan of the bf16 GEMM's wgmma kernel (csrc/gemm.cuh,
`gemm_bf16_wg_kernel`) through its Python mirror (ops/gemm_cuda.py), on the
CPU: every bf16 product of the three shipped configs takes the wgmma kernel
where TMA can read its operands and the mma.sync kernel where it cannot; a
block's shared memory fits the H100's 227 KB; the persistent blocks' walk
over the tiles covers every output tile of every problem and split once;
gemm_tn's splits cover its R rows once, each split's slices reach no row
of the next split, and no split sums more rows into one accumulator
than the mma.sync kernel's split. The plain versions of the general bf16
entry agree with the bf16 path's other plain versions and with a float64
emulation of the epilogue's roundings. chip_smoke.py and
tests/test_torch_cuda.py hold the mirror to the C plan on the card.
"""

import os

import numpy as np
import pytest
import torch

from video_moment_localization_tpu_torch.config import load_config
from video_moment_localization_tpu_torch.ops import gemm_cuda
from video_moment_localization_tpu_torch.ops.cuda_build import MAX_SMEM_BYTES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ("charadessta", "activitynet", "tacos")


def _cfg(name):
    return load_config(os.path.join(REPO, "config", f"{name}.yml")).model


@pytest.mark.parametrize("B", (1, 16, 64, 512))
@pytest.mark.parametrize("config", CONFIGS)
def test_every_bf16_product_has_a_kernel_that_fits(config, B):
    shapes = gemm_cuda.model_gemm_shapes_bf16(_cfg(config), B)
    assert {s[0] for s in shapes} == {"K5-bf16", "K4-bf16", "K2-bf16", "K3-bf16", "K7f-bf16",
                                      "K7b-bf16", "K9-bf16", "K10f-bf16", "K10b-bf16"}
    for kernel, name, layout, M, N, K, groups in shapes:
        terms, out = gemm_cuda.epilogue_bf16(kernel, name)
        assert out in ("bf16", "fp32") and (layout != "tn" or out == "fp32"), (kernel, name)
        for tma_ok in (True, False):
            plan = gemm_cuda.plan(layout, M, N, K, groups, name, torch.bfloat16, tma_ok)
            assert plan["path"] == (gemm_cuda.BF16_WG if tma_ok else gemm_cuda.BF16)
            per_sm = gemm_cuda.blocks_per_sm(layout, plan["path"])
            assert plan["smem"] <= MAX_SMEM_BYTES
            assert per_sm * (plan["smem"] + 1024) <= 228 * 1024, (kernel, name, plan)
        wg = gemm_cuda.plan(layout, M, N, K, groups, name, torch.bfloat16)
        splits = gemm_cuda.wg_bf16_split(layout, M, N, K)[0]
        rows = 128 if layout == "tn" else 64
        assert wg["rows"] == rows
        assert wg["tiles"] == -(-M // rows) * -(-N // 128) * groups * splits
        assert 1 <= wg["blocks"] <= min(wg["tiles"], gemm_cuda.SMS)
        assert wg["threads"] == gemm_cuda.WG_BF16_THREADS == 3 * 128


def _walk(layout, M, N, K, groups):
    """Every (problem, split, row, column) tile the persistent blocks take,
    block by block, and the k ranges each sums."""
    p = gemm_cuda.wg_bf16_plan(layout, M, N, K, groups)
    seen = []
    for b in range(p["blocks"]):
        for t in range(b, p["tiles"], p["blocks"]):
            seen.append(gemm_cuda.wg_bf16_tile(layout, M, N, K, groups, t))
    return p, seen


@pytest.mark.parametrize("layout,M,N,K,groups", [
    ("nt", 1000, 200, 128, 1), ("nt", 532480 // 64, 512, 128, 1), ("nt", 700, 256, 512, 2),
    ("nn", 4352, 136, 512, 1), ("nn", 133120 // 16, 512, 512, 2), ("nt", 64, 128, 512, 1),
    ("tn", 512, 128, 532480, 1), ("tn", 128, 128, 532480, 1), ("tn", 512, 512, 133120, 1),
    ("tn", 128, 512, 64, 1), ("tn", 300, 45, 1000, 1)])
def test_wg_bf16_walk_covers_every_tile_once(layout, M, N, K, groups):
    p, seen = _walk(layout, M, N, K, groups)
    assert len(seen) == p["tiles"] == len(set(t[:4] for t in seen))
    splits, kchunk = gemm_cuda.wg_bf16_split(layout, M, N, K)
    want = {(g, z, m0, n0) for g in range(groups) for z in range(splits)
            for m0 in range(0, M, p["rows"]) for n0 in range(0, N, 128)}
    assert set(t[:4] for t in seen) == want
    # Consecutive tiles share their A rows (tn: their split) first: a tile's
    # neighbours in the walk differ in the column tile (or the problem).
    first = [gemm_cuda.wg_bf16_tile(layout, M, N, K, groups, t) for t in range(min(4, p["tiles"]))]
    assert len({(t[1], t[2]) for t in first}) <= -(-min(4, p["tiles"]) // (-(-N // 128) * groups))


@pytest.mark.parametrize("M,N,R", [(512, 128, 532480), (128, 128, 532480), (512, 512, 133120),
                                   (128, 512, 1280), (128, 512, 64), (512, 512, 4096),
                                   (300, 45, 1000), (512, 128, 17)])
def test_wg_bf16_splits_cover_rows_once_within_the_chain_rule(M, N, R):
    """gemm_tn's splits on the wgmma kernel: splitk_for's, so each output
    sums at most the mma.sync kernel's kchunk rows through the tensor cores'
    truncating adder; 128-row slices whose last one stops at its split's end
    (the rows past it are outside the split's 3-D view and read as 0)."""
    splits, kchunk = gemm_cuda.wg_bf16_split("tn", M, N, R)
    assert (splits, kchunk) == gemm_cuda.splitk_for(M, N, R)
    covered = np.zeros(R, np.int64)
    for z in range(splits):
        t = z * -(-M // 128) * -(-N // 128)
        _, _, _, _, k0, k1 = gemm_cuda.wg_bf16_tile("tn", M, N, R, 1, t)
        assert k0 == z * kchunk and k1 == min(R, (z + 1) * kchunk)
        assert 0 < k1 - k0 <= kchunk
        bk = gemm_cuda.WG_BF16_SHAPE["tn"][1]
        slices = -(-(k1 - k0) // bk)
        assert (slices - 1) * bk < k1 - k0 <= slices * bk
        covered[k0:k1] += 1
    assert (covered == 1).all()
    assert gemm_cuda.wg_bf16_plan("tn", M, N, R)["slices"] == -(-min(kchunk, R) // 128)


def test_bf16_kernel_choice_is_static():
    """The plan decides by shape and alignment alone."""
    for layout in ("nt", "nn", "tn"):
        assert gemm_cuda.path_for(layout, 532480, 512, 128, 1, torch.bfloat16) == gemm_cuda.BF16_WG
        assert gemm_cuda.path_for(layout, 77, 45, 30, 1, torch.bfloat16,
                                  tma_ok=False) == gemm_cuda.BF16
    with pytest.raises(ValueError, match="unknown layout"):
        gemm_cuda.path_for("tt", 8, 8, 8, 1, torch.bfloat16)
    with pytest.raises(ValueError, match="path must be"):
        gemm_cuda._bf16_path("gemm_bf16", gemm_cuda.TENSOR)


def _round_bf16(x):
    """float64 -> the nearest bf16 value (ties to even), as float64."""
    return torch.from_numpy(np.asarray(x)).float().bfloat16().double().numpy()


@pytest.mark.parametrize("layout", ["nt", "nn"])
@pytest.mark.parametrize("round_each", [False, True])
def test_general_plain_matches_the_epilogue_order(layout, round_each):
    """`gemm_bf16_general_plain` (the plain version of every bf16 entry):
    bias, pre, the mask, (a rounding), post, (a rounding), post32, post2,
    then the output's rounding, in that order: a float64 emulation within
    fp32 rounding (with ``round_each`` within a rounding flip)."""
    g = torch.Generator().manual_seed(3)
    M, N, K = 37, 24, 40
    A = torch.randn(M, K, generator=g).bfloat16()
    W = (torch.randn(N, K, generator=g) if layout == "nt" else torch.randn(K, N, generator=g)
         ).bfloat16()
    bias, pre = torch.randn(N, generator=g), torch.randn(M, N, generator=g)
    rmask = (torch.rand(-(-M // 4), generator=g) > 0.3).float()
    post, post32 = torch.randn(M, N, generator=g).bfloat16(), torch.randn(M, N, generator=g)
    post2 = torch.randn(-(-M // 3), N, generator=g).bfloat16()
    got = gemm_cuda.gemm_bf16_general_plain(
        layout, A, W, bias=bias, pre=pre, rmask=rmask, mask_div=4, post=post, post32=post32,
        post2=post2, post2_div=3, round_each=round_each, out_dtype=torch.float32)
    rows = np.arange(M)
    Wd = W.double().numpy()
    x = A.double().numpy() @ (Wd.T if layout == "nt" else Wd)
    x = (x + bias.double().numpy() + pre.double().numpy()) * rmask.double().numpy()[rows // 4, None]
    x = _round_bf16(x) if round_each else x
    x = x + post.double().numpy()
    x = _round_bf16(x) if round_each else x
    x = x + post32.double().numpy() + post2.double().numpy()[rows // 3]
    scale = np.abs(A.double().numpy()) @ np.abs(Wd.T if layout == "nt" else Wd) + np.abs(x) + 1
    d = np.abs(got.double().numpy() - x)
    if round_each:   # a rounding flip of the fp32 sum's order: one bf16 unit
        assert (d <= 2.0 ** -7 * np.abs(x) + 1e-5 * scale).all()
    else:
        assert (d <= 1e-5 * scale).all()


def test_general_plain_two_problems_and_tn():
    """Two problems are each one's own product; tn rounds the scaled A to
    bf16 and returns its column sums."""
    g = torch.Generator().manual_seed(4)
    A, W0, W1 = (torch.randn(20, 16, generator=g).bfloat16() for _ in range(3))
    b0, b1 = torch.randn(20, generator=g), torch.randn(20, generator=g)
    c0, c1 = gemm_cuda.gemm_bf16_general("nt", A, W0, W1=W1, bias=b0, bias1=b1)
    assert torch.equal(c0, gemm_cuda.gemm_bf16_general("nt", A, W0, bias=b0))
    assert torch.equal(c1, gemm_cuda.gemm_bf16_general("nt", A, W1, bias=b1))
    sc = torch.rand(20, generator=g)
    out, cols = gemm_cuda.gemm_bf16_layout("tn", A, W0, ascale=sc, bias_sums=True)
    As = (A.double() * sc.double()[:, None]).float().bfloat16().double()
    torch.testing.assert_close(out.double(), As.t() @ W0.double(), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(cols.double(), As.sum(0), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("R,M,N,split", [(40, 16, 24, 8), (7, 5, 9, 4), (8704 // 64, 32, 64, 32)])
def test_general_plain_tn_split_is_two_products(R, M, N, split):
    """K3's moment weights' gradients as one tn product over [x1 | x2]: the
    split outputs are the two separate products, bit for bit, and the
    column sums are the one product's."""
    g = torch.Generator().manual_seed(R + N)
    A = torch.randn(R, M, generator=g).bfloat16()
    X = torch.randn(R, N, generator=g).bfloat16()
    sc = (torch.rand(R, generator=g) > 0.3).float()
    (left, right), cols = gemm_cuda.gemm_bf16_general("tn", A, X, ascale=sc, bias_sums=True,
                                                      split=split)
    one, cols1 = gemm_cuda.gemm_bf16_general("tn", A, X[:, :split], ascale=sc, bias_sums=True)
    two = gemm_cuda.gemm_bf16_general("tn", A, X[:, split:], ascale=sc)
    assert left.shape == (M, split) and right.shape == (M, N - split)
    assert torch.equal(left, one) and torch.equal(right, two) and torch.equal(cols, cols1)


@pytest.mark.parametrize("config", CONFIGS)
def test_k3_reduces_both_moment_weights_in_one_product(config):
    """K3's tn products (model_gemm_shapes): the moment unit's two weight
    gradients are one product of width 2D over the pairs, on the epilogue
    of both (the row mask as a row scale and the bias gradient)."""
    cfg = _cfg(config)
    N = cfg.L * (cfg.L + 1) // 2
    k3 = [s for s in gemm_cuda.model_gemm_shapes_bf16(cfg, 64) if s[0] == "K3-bf16"]
    names = [s[1] for s in k3]
    assert "dW conv_fb" not in names and "dW conv_fc" not in names
    (merged,) = [s for s in k3 if s[1] == "dW conv_fb + conv_fc"]
    assert merged[2:] == ("tn", cfg.D, 2 * cfg.D, 64 * N, 1)
    assert gemm_cuda.epilogue_bf16("K3-bf16", merged[1]) == (("ascale", "colsum"), "fp32")
    assert sum(s[2] == "tn" for s in k3) == 9

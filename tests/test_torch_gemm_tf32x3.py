"""The error budget of the shared GEMM's tensor-core path (3xTF32,
csrc/gemm.cuh::gemm_tc_kernel) on the CPU, before the card: a numpy mirror
of its arithmetic against float64, held to the tolerances the card tests
hold the kernel to (tests/test_torch_cuda.py::_gemm_tol and ::_tn_tol).

The mirror follows the kernel: each operand value x (after gemm_nn's row
scale, or gemm_tn's in-place scale of A's stored rows) is split into big =
rna_tf32(x) and small = rna_tf32(x - big), TF32 rounding to nearest with
ties away from zero done by bit arithmetic on float32 (cvt.rna.tf32.f32);
per 16-deep slice, its two k8 steps' three products each (a_s b_b, a_b b_s,
a_b b_b in that order) go into a zeroed fp32 slice sum, each a k8 sum of
exact products (TF32 products are exact in fp32) rounded once to fp32, and
the slice sum is added to the fp32 running sum; gemm_tn sums each split's
kchunk rows that way and adds the splits' partials in ascending order in
fp32. The card's adder inside one mma truncates where this rounds, by an ulp
of a slice sum at most; the card tests hold the kernel itself.
"""

import os

import numpy as np
import pytest

from video_moment_localization_tpu_torch.config import load_config
from video_moment_localization_tpu_torch.ops import gemm_cuda

from test_torch_cuda import _gemm_tol, _tn_tol

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tf32_rna(x):
    """float32 -> the nearest TF32 value (10 explicit mantissa bits), ties
    away from zero, as float32: cvt.rna.tf32.f32."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split_tf32(x):
    big = tf32_rna(x)
    return big, tf32_rna((x.astype(np.float32) - big).astype(np.float32))


def mma_chain(a, b, acc):
    """acc (M, N) fp32 += a (M, K) b (K, N) as the kernel's slices, K a
    multiple of 16: per k8 step a_s b_b, a_b b_s, a_b b_b in that order into
    a zeroed slice sum, then the slice sum into acc."""
    M, K = a.shape
    N = b.shape[1]
    G = K // 8
    a_b, a_s = (v.astype(np.float64).reshape(M, G, 8) for v in split_tf32(a))
    b_b, b_s = (v.astype(np.float64).reshape(G, 8, N) for v in split_tf32(b))
    terms = [np.einsum("mgk,gkn->gmn", x, y).reshape(G // 2, 2, M, N)
             for x, y in ((a_s, b_b), (a_b, b_s), (a_b, b_b))]
    part = np.zeros((G // 2, M, N), np.float32)
    for h in range(2):
        for t in terms:
            part = (part + t[:, h]).astype(np.float32)   # exact sum, then one rounding
    seq = np.concatenate([acc[None].astype(np.float32), part])
    return np.add.accumulate(seq, axis=0, dtype=np.float32)[-1]


def pad16(x, axis):
    extra = -x.shape[axis] % 16
    if not extra:
        return x
    shape = list(x.shape)
    shape[axis] = extra
    return np.concatenate([x, np.zeros(shape, np.float32)], axis=axis)


def gemm_tf32x3(a, b):
    """C = a b, a (M, K), b (K, N): one block's k order (no split)."""
    return mma_chain(pad16(a, 1), pad16(b, 0), np.zeros((a.shape[0], b.shape[1]), np.float32))


def gemm_tn_tf32x3(a, b, kchunk):
    """C = a^T b over the R rows of a (R, M), b (R, N): splits of kchunk
    rows each, their partials added in ascending order."""
    parts = [gemm_tf32x3(a[z:z + kchunk].T, b[z:z + kchunk])
             for z in range(0, a.shape[0], kchunk)]
    return np.add.accumulate(np.stack(parts), axis=0, dtype=np.float32)[-1]


def _close(got, want, tol):
    """torch.testing.assert_close's rule: |got - want| <= atol + rtol |want|;
    returns the largest share of the allowance used."""
    allowed = tol["atol"] + tol["rtol"] * np.abs(want)
    share = float(np.max(np.abs(got.astype(np.float64) - want) / allowed))
    assert share <= 1.0, f"{share:.3f} of the tolerance"
    return share


def test_tf32_rounding_is_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = 2.0 ** -10
    x = np.array([1 + 2 ** -11, 1 + 2 ** -12, 1 + 3 * 2 ** -12, -(1 + 2 ** -11),
                  1 + ulp + 2 ** -11, 2 ** -130, 0.0], np.float32)
    want = np.array([1 + ulp, 1, 1 + ulp, -(1 + ulp), 1 + 2 * ulp, 2 ** -130, 0.0],
                    np.float32)
    np.testing.assert_array_equal(tf32_rna(x), want)
    assert tf32_rna(np.array([one]))[0] == one


def test_split_keeps_22_bits():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(100000) * np.exp(rng.uniform(-20, 20, 100000))).astype(np.float32)
    big, small = split_tf32(x)
    assert not np.any(big.view(np.uint32) & 0x1FFF) and not np.any(small.view(np.uint32) & 0x1FFF)
    rest = np.abs(x.astype(np.float64) - big - small)
    assert np.all(rest <= 2.0 ** -22 * np.abs(x.astype(np.float64)))


@pytest.mark.parametrize("K", [84, 128, 512, 1024])
@pytest.mark.parametrize("layout", ["nt", "nn"])
def test_products_within_the_card_tolerance(layout, K):
    """Unit normals, as the card tests; gemm_nn with its 0/1 row scale."""
    rng = np.random.default_rng(K)
    M, N = 96, 80
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal((K, N)).astype(np.float32)
    if layout == "nn":
        a = (a * (rng.random(M) > 0.3)[:, None]).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    share = _close(gemm_tf32x3(a, b), want, _gemm_tol(K))
    # The dropped terms are about 2^-22 of a product: well inside the budget
    # that fp32 FMAs (2^-24 a product) were given.
    assert share < 0.5


@pytest.mark.parametrize("M,N,R", [(300, 196, 84), (512, 128, 1000), (128, 128, 133120)])
def test_split_k_within_the_card_tolerance(M, N, R):
    """gemm_tn's split-K order at the card tests' shapes, on a slice of 24
    x 16 outputs (the split is that of the full M x N)."""
    rng = np.random.default_rng(R)
    a = rng.standard_normal((R, 24)).astype(np.float32)
    b = rng.standard_normal((R, 16)).astype(np.float32)
    scale = (rng.random(R // 3 + 1) > 0.3).astype(np.float32)
    a = (a * scale[np.arange(R) // 3][:, None]).astype(np.float32)
    kchunk = gemm_cuda.splitk_for(M, N, R)[1]
    want = a.T.astype(np.float64) @ b.astype(np.float64)
    _close(gemm_tn_tf32x3(a, b, kchunk), want, _tn_tol(M, N, R))


def test_k7_largest_weight_gradient_within_the_card_tolerance():
    """K7's largest reduction: dW of c_out, (D, dl) = (512, 128) over the
    B * N * C = 532,480 clip rows of ActivityNet at B=64, split as the card
    splits it (66 splits of 8,080 rows), on a seeded slice of 8 x 8 of its
    outputs; the rows masked by pair validity (a row scale with adiv = C)."""
    cfg = load_config(os.path.join(REPO, "config", "activitynet.yml")).model
    B = 64
    R = B * cfg.L * (cfg.L + 1) // 2 * cfg.C
    M, N = cfg.D, cfg.dl
    assert (R, M, N) == (532480, 512, 128)
    splits, kchunk = gemm_cuda.splitk_for(M, N, R)
    assert splits * kchunk >= R > (splits - 1) * kchunk
    rng = np.random.default_rng(64)
    a = rng.standard_normal((R, 8)).astype(np.float32)
    b = rng.standard_normal((R, 8)).astype(np.float32)
    pair_valid = (rng.random(R // cfg.C) > 0.4).astype(np.float32)
    a = (a * pair_valid[np.arange(R) // cfg.C][:, None]).astype(np.float32)
    want = a.T.astype(np.float64) @ b.astype(np.float64)
    share = _close(gemm_tn_tf32x3(a, b, kchunk), want, _tn_tol(M, N, R))
    assert share < 0.5

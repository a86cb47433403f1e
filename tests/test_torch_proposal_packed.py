"""K6's function in the port (its plain version, on the CPU) against the JAX
package: `proposal_features_packed_fused` forward and backward vs
`proposal_features_packed_pallas(..., interpret=True)` through its custom VJP
and vs `jax.vjp` of the XLA `proposal_features_packed`, at the tolerances of
tests/test_pallas.py (forward rtol 2e-5 / atol 2e-5, gradient rtol 1e-4 /
atol 1e-4); and the closed-form clip geometry that the CUDA kernels compute
in place of a table, held to `content_segments` at the shipped maps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_moment_localization_tpu.ops.proposal import proposal_features_packed as j_packed
from video_moment_localization_tpu.ops.proposal_pallas import proposal_features_packed_pallas
from video_moment_localization_tpu_torch.ops import proposal_cuda
from video_moment_localization_tpu_torch.ops.content_matrix import content_segments
from video_moment_localization_tpu_torch.ops.packing import packed_valid_mask

# The last: two frames per snippet and clips of one frame, as ActivityNet's map.
GEOMETRIES = [dict(T=16, L=8, C=4, D=128), dict(T=64, L=16, C=4, D=32), dict(T=16, L=8, C=3, D=16)]
FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(geo, B, seed):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((B, geo["T"], geo["D"])).astype(np.float32)
    lmask = np.ones((B, geo["L"]), np.float32)
    lmask[0, geo["L"] // 2:] = 0
    lmask[1, 3:] = 0
    N = geo["L"] * (geo["L"] + 1) // 2
    cots = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, N, geo["C"], geo["D"]), (B, N, geo["D"]), (B, geo["L"], geo["D"]))]
    return f, lmask, cots


@pytest.mark.parametrize("reference", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("geo", GEOMETRIES, ids=lambda g: f"T{g['T']}L{g['L']}C{g['C']}")
def test_packed_forward_and_grad_match_jax(geo, reference):
    B = 3
    f, lmask, cots = _inputs(geo, B, seed=geo["L"] + geo["C"])
    L, C = geo["L"], geo["C"]

    def jfn(f_):
        if reference == "xla":
            return j_packed(f_, jnp.asarray(lmask), L, C)
        return proposal_features_packed_pallas(f_, jnp.asarray(lmask), L, C, True)

    want, vjp = jax.vjp(jfn, jnp.asarray(f))
    dwant = vjp(tuple(jnp.asarray(c) for c in cots))[0]

    before = (proposal_cuda.proposal_packed_forward.launches,
              proposal_cuda.proposal_packed_backward.launches)
    ft = torch.from_numpy(f).requires_grad_(True)
    got = proposal_cuda.proposal_features_packed_fused(ft, torch.from_numpy(lmask), L, C)
    df = torch.autograd.grad(got, ft, [torch.from_numpy(c) for c in cots])[0]
    assert (proposal_cuda.proposal_packed_forward.launches,
            proposal_cuda.proposal_packed_backward.launches) == before   # CPU: plain versions

    assert tuple(got[0].shape) == (B, L * (L + 1) // 2, C, geo["D"])
    for g, w, name in zip(got, want, ("fc", "fm", "fb")):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **FWD_TOL, err_msg=name)
    np.testing.assert_allclose(df.numpy(), np.asarray(dwant), **GRAD_TOL)
    vmask = packed_valid_mask(torch.from_numpy(lmask))
    assert (got[0][vmask == 0] == 0).all() and (vmask[1] == 1).sum() == 6   # 3 valid snippets


def _closed_form(T, L, C):
    """The clip geometry as csrc/proposal.cuh::pool_kernel and
    csrc/proposal_rows.cu::proposal_bwd_kernel compute it per pair:
    (start, size, end) of clip c of pair (i, j), size 0 (and start = end = 0)
    for a clip that does not exist. The backward's difference arrays rely on
    a moment's clips tiling one run of frames: each clip ends where the next
    begins."""
    tl = T // L
    starts = np.zeros((L, L, C), np.int32)
    sizes = np.zeros((L, L, C), np.int32)
    ends = np.zeros((L, L, C), np.int32)
    for i in range(L):
        for j in range(i, L):
            frames = (j - i + 1) * tl
            clip = max(1, frames // C)
            valid = min(C, frames)
            for c in range(valid):
                starts[i, j, c] = i * tl + c * clip
                sizes[i, j, c] = clip
                ends[i, j, c] = i * tl + (c + 1) * clip
            assert (ends[i, j, :valid - 1] == starts[i, j, 1:valid]).all()
            assert i * tl <= starts[i, j, 0] and ends[i, j, valid - 1] <= (j + 1) * tl <= T
    return starts, sizes, ends


@pytest.mark.parametrize("T,L,C", [(128, 64, 4), (128, 32, 4), (64, 16, 4), (10, 5, 3)],
                         ids=["activitynet", "tacos", "charades", "odd"])
def test_kernel_clip_geometry_equals_content_segments(T, L, C):
    seg = content_segments(T, L, C)
    starts, sizes, ends = _closed_form(T, L, C)
    np.testing.assert_array_equal(starts, seg.starts)
    np.testing.assert_array_equal(sizes, seg.sizes)
    np.testing.assert_array_equal(ends, seg.starts + seg.sizes)
    if (T, L, C) == (128, 64, 4):
        assert sizes[5, 5].tolist() == [1, 1, 0, 0]        # a 2-frame pair: 2 clips of 1 frame
        assert sizes[0, 63].tolist() == [32] * 4


def test_k6_and_k1_entries_count_apart():
    geo = GEOMETRIES[0]
    f, lmask, _ = _inputs(geo, 3, seed=1)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        proposal_cuda.proposal_packed_forward(torch.zeros(2, 16, 8, device="meta"),
                                              torch.ones(2, 8, device="meta"), 8, 4)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        proposal_cuda.proposal_packed_backward(
            torch.ones(2, 8, device="meta"), 16, 8, 4, torch.zeros(2, 36, 4, 8, device="meta"),
            torch.zeros(2, 36, 8, device="meta"), torch.zeros(2, 8, 8, device="meta"))
    assert proposal_cuda.proposal_packed_forward is not proposal_cuda.proposal_rows_forward
    a = proposal_cuda.proposal_features_packed_fused(torch.from_numpy(f), torch.from_numpy(lmask),
                                                     geo["L"], geo["C"])
    b = proposal_cuda.proposal_features_rows(torch.from_numpy(f), torch.from_numpy(lmask),
                                             geo["L"], geo["C"])
    for x, y in zip(a, b):
        assert torch.equal(x, y)

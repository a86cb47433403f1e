"""A numpy mirror of the arithmetic of the CUDA proposal kernels (K1, K6, K8;
csrc/proposal.cuh::pool_kernel and csrc/proposal_rows.cu::proposal_bwd_kernel),
which cannot run on the CPU, held to the port's plain versions and to the JAX
package's XLA functions at the three shipped maps and two narrow ones, packed
and dense, with ragged masks.

Backward: each of a block's W warps (`proposal_cuda.backward_warps(T, L)`) owns
the pairs q = warp (mod W) of the np.triu_indices order, takes those whose
mask is not 0 four at a time, and scatters every existing clip's
g = (dfc + dfm / C) * (mask / size) into an fp32 difference array of its own:
g(c) - g(c-1) at clip c's start, -g(last) at the last clip's end unless that
is T. The block sums the W arrays in warp order and scans them over t in fp64,
then adds dfb / (T/L). Forward: fp64 prefix sums of f, a clip mean is
(P[end] - P[start]) / size rounded to fp32, times the mask in fp32; fm the
fp32 sum of the C clips over C; fb (P[(l+1) T/L] - P[l T/L]) / (T/L).

Tolerances: chip_smoke.py's. K1's forward and backward and K8's forward:
rtol 1e-4, atol 1e-5 (``K1_TOL``); K6's and K8's backward: rtol 5e-4, atol 5e-5
of the gradient's magnitude. `test_backward_scan_error_against_float64`
prints the mirror's largest error against the same scatter and scan in
float64 at each shipped map and holds it to the same tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_proposal_packed import _closed_form
from video_moment_localization_tpu.ops.proposal import proposal_features as j_dense
from video_moment_localization_tpu.ops.proposal import proposal_features_packed as j_packed
from video_moment_localization_tpu_torch.ops import proposal_cuda

GROUP = 4   # csrc/proposal_rows.cu: kGroup
SLOTS = 5   # csrc/proposal_rows.cu: kSlots
K1_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_RTOL, GRAD_ATOL_REL = 5e-4, 5e-5

SHIPPED = {"charades": (64, 16, 4), "activitynet": (128, 64, 4), "tacos": (128, 32, 4)}
# C=9 takes three clip batches per moment (one frame per snippet); the odd
# map has T/L = 2, C = 3.
GEOMETRIES = dict(SHIPPED, c9=(32, 32, 9), odd=(10, 5, 3))


def _pairs(L):
    i, j = np.triu_indices(L)
    return list(zip(i.tolist(), j.tolist()))


def _inputs(T, L, C, dense, B, D, seed):
    """f, the layout's mask (B, P) and cotangents: ragged lengths (one video
    of L/2 snippets, one of 3); a dense mask with fractional values and ones
    below the diagonal, which no clip reads."""
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((B, T, D)).astype(np.float32)
    lmask = np.ones((B, L), np.float32)
    lmask[0, L // 2:] = 0
    lmask[1, 3:] = 0
    if dense:
        mm = np.triu(lmask[:, :, None] * lmask[:, None, :])
        mm = mm * rng.uniform(0.5, 1.0, mm.shape).astype(np.float32)
        mm[:, np.tril_indices(L, -1)[0], np.tril_indices(L, -1)[1]] = 1.0
        mask, P = mm, L * L
    else:
        mask, P = lmask, L * (L + 1) // 2
    cots = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, P, C, D), (B, P, D), (B, L, D))]
    return f, mask, cots


def _moment_mask(mask, L, dense):
    """(B, P) mask value of each moment of the layout."""
    if dense:
        return mask.reshape(mask.shape[0], L * L)
    valid = np.triu(mask[:, :, None] * mask[:, None, :])
    i, j = np.triu_indices(L)
    return valid[:, i, j]


def _index(i, j, L, dense):
    return i * L + j if dense else i * L - i * (i - 1) // 2 + (j - i)


def mirror_backward(T, L, C, mask, dfc, dfm, dfb, dense, dtype=np.float32):
    """df (B, T, D) as the backward kernel computes it; ``dtype`` is that of
    the difference arrays and of g (the scan is fp64 in any case)."""
    starts, sizes, ends = _closed_form(T, L, C)
    vm = _moment_mask(mask, L, dense).astype(dtype)
    B, D = dfc.shape[0], dfc.shape[-1]
    warps = proposal_cuda.backward_warps(T, L)
    diff = np.zeros((warps, B, T, D), dtype)
    inv_c = dtype(1.0) / dtype(C)
    pairs = _pairs(L)
    for warp in range(warps):
        mine = [(i, j) for i, j in pairs[warp::warps]]
        # Groups of GROUP moments whose mask is not 0 (in one element; the
        # elements' masks differ, so the mirror groups each element apart).
        for b in range(B):
            live = [(i, j) for i, j in mine if vm[b, _index(i, j, L, dense)] != 0]
            for g0 in range(0, len(live), GROUP):
                group = []
                for i, j in live[g0:g0 + GROUP]:
                    n = _index(i, j, L, dense)
                    valid = int((sizes[i, j] > 0).sum())
                    group.append((n, i, j, valid, vm[b, n] / dtype(sizes[i, j, 0]),
                                  dfm[b, n].astype(dtype) * inv_c))
                prev = [np.zeros(D, dtype) for _ in group]
                for c0 in range(0, C + 1, SLOTS):
                    for k, (n, i, j, valid, wk, gm) in enumerate(group):
                        for c in range(c0, min(c0 + SLOTS, valid + 1)):
                            g = ((dfc[b, n, c].astype(dtype) + gm) * wk).astype(dtype) \
                                if c < valid else np.zeros(D, dtype)
                            pos = starts[i, j, c] if c < valid else ends[i, j, valid - 1]
                            if pos < T:
                                diff[warp, b, pos] += g - prev[k]
                            prev[k] = g
    acc = np.cumsum(diff.astype(np.float64).sum(axis=0), axis=1)
    acc += np.repeat(dfb.astype(np.float64), T // L, axis=1) / (T // L)
    return acc.astype(np.float32)


def mirror_forward(T, L, C, f, mask, dense):
    """(fc, fm, fb) as the pooling kernel computes them."""
    starts, sizes, ends = _closed_form(T, L, C)
    B, _, D = f.shape
    P = np.concatenate([np.zeros((B, 1, D)), np.cumsum(f.astype(np.float64), axis=1)], axis=1)
    cells = [(i, j) for i in range(L) for j in range(L)] if dense else _pairs(L)
    vm = _moment_mask(mask, L, dense)
    fc = np.zeros((B, len(cells), C, D), np.float32)
    for n, (i, j) in enumerate(cells):
        for c in range(C):
            if i <= j and sizes[i, j, c] > 0:
                mean = (P[:, ends[i, j, c]] - P[:, starts[i, j, c]]) / sizes[i, j, c]
                fc[:, n, c] = mean.astype(np.float32) * vm[:, n, None]
    fm = fc.sum(axis=2, dtype=np.float32) / np.float32(C)
    tl = T // L
    fb = ((P[:, tl::tl] - P[:, :-1:tl]) / tl).astype(np.float32)
    if dense:
        fc, fm = fc.reshape(B, L, L, C, D), fm.reshape(B, L, L, D)
    return fc, fm, fb


def _cots_of(cots, L, dense):
    """The cotangents in the layout's own shape (dense: (B, L, L, ...))."""
    if not dense:
        return cots
    B, _, C, D = cots[0].shape
    return [cots[0].reshape(B, L, L, C, D), cots[1].reshape(B, L, L, D), cots[2]]


def _assert_backward(got, want, tight, name):
    """K1_TOL where ``tight`` (K1: the packed layout at the Charades map),
    else the gradient tolerance of K6 and K8."""
    if tight:
        np.testing.assert_allclose(got, want, **K1_TOL, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_REL * float(np.abs(want).max()), err_msg=name)


@pytest.mark.parametrize("dense", [False, True], ids=["packed", "dense"])
@pytest.mark.parametrize("geo", list(GEOMETRIES), ids=list(GEOMETRIES))
def test_backward_mirror_matches_plain_and_jax(geo, dense):
    T, L, C = GEOMETRIES[geo]
    f, mask, cots = _inputs(T, L, C, dense, B=3, D=16, seed=T + L + C)
    got = mirror_backward(T, L, C, mask, *cots, dense)
    shaped = _cots_of(cots, L, dense)
    plain = proposal_cuda.proposal_backward_plain(
        torch.from_numpy(mask), T, L, C, *[torch.from_numpy(c) for c in shaped]).numpy()
    jfn = j_dense if dense else j_packed
    _, vjp = jax.vjp(lambda x: jfn(x, jnp.asarray(mask), L, C), jnp.asarray(f))
    jax_df = np.asarray(vjp(tuple(jnp.asarray(c) for c in shaped))[0])
    tight = geo == "charades" and not dense
    _assert_backward(got, plain, tight, "against proposal_backward_plain")
    _assert_backward(got, jax_df, tight, "against the JAX VJP")


@pytest.mark.parametrize("dense", [False, True], ids=["packed", "dense"])
@pytest.mark.parametrize("geo", list(GEOMETRIES), ids=list(GEOMETRIES))
def test_forward_mirror_matches_plain_and_jax(geo, dense):
    T, L, C = GEOMETRIES[geo]
    f, mask, _ = _inputs(T, L, C, dense, B=3, D=16, seed=T + L + C)
    got = mirror_forward(T, L, C, f, mask, dense)
    plain_fn = proposal_cuda.proposal_features if dense else proposal_cuda.proposal_features_packed
    plain = plain_fn(torch.from_numpy(f), torch.from_numpy(mask), L, C)
    want_jax = (j_dense if dense else j_packed)(jnp.asarray(f), jnp.asarray(mask), L, C)
    for g, p, w, name in zip(got, plain, want_jax, ("fc", "fm", "fb")):
        np.testing.assert_allclose(g, p.numpy(), **K1_TOL, err_msg=f"{name} against the plain")
        np.testing.assert_allclose(g, np.asarray(w), **K1_TOL, err_msg=f"{name} against JAX")
    if dense:   # every cell below the diagonal is 0 whatever the mask holds there
        below = np.tril(np.ones((L, L), bool), -1)
        assert (got[0][:, below] == 0).all() and (got[1][:, below] == 0).all()


@pytest.mark.parametrize("dense", [False, True], ids=["packed", "dense"])
@pytest.mark.parametrize("geo", list(SHIPPED), ids=list(SHIPPED))
def test_backward_scan_error_against_float64(geo, dense):
    """The fp32 difference arrays (scanned in fp64, as the kernel does)
    against the same scatter and scan in float64, at B=8 and 64 columns."""
    T, L, C = SHIPPED[geo]
    _, mask, cots = _inputs(T, L, C, dense, B=8, D=64, seed=7)
    got = mirror_backward(T, L, C, mask, *cots, dense)
    exact = mirror_backward(T, L, C, mask, *[c.astype(np.float64) for c in cots], dense,
                            dtype=np.float64)
    err, mag = float(np.abs(got - exact).max()), float(np.abs(exact).max())
    print(f"{geo} {'dense' if dense else 'packed'}: fp32 scatter max abs err {err:.3e} against "
          f"float64, gradient magnitude {mag:.3e}")
    _assert_backward(got, exact, geo == "charades" and not dense, "against float64")

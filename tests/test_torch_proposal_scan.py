"""A numpy mirror of the arithmetic of the CUDA proposal kernels (K1, K6, K8
and their bf16 variants; csrc/proposal.cuh::pool_kernel and pool_kernel_bf16,
csrc/proposal_rows.cu::proposal_bwd_kernel and proposal_bwd_bf16_kernel),
which cannot run on the CPU, held to the port's plain versions and to the JAX
package's XLA functions at the three shipped maps and two narrow ones, packed
and dense, with ragged masks.

Backward at fp32: each of a block's W warps (`proposal_cuda.backward_warps(T,
L)`) owns the pairs q = warp (mod W) of the np.triu_indices order, takes
those whose mask is not 0 four at a time, and scatters every existing clip's
g = (dfc + dfm / C) * (mask / size) into an fp32 difference array of its own:
g(c) - g(c-1) at clip c's start, -g(last) at the last clip's end unless that
is T. The block sums the W arrays in warp order and scans them over t in fp64,
then adds dfb / (T/L). Backward at bf16: the same scatter of the bf16
cotangents' values, partitioned otherwise: the element's unmasked moments in
pair order are cut into chunks of at most ``BOX_MOMENTS`` adjacent moments
(cut where a run of consecutive moment indices starts and at each index that
is a multiple of ``BOX_MOMENTS``), consumer warp w of W
(`proposal_cuda.pair_plan(T, L, C)[0]`) takes the chunks w (mod W) in order
and scatters their moments ``SCATTER_GROUP`` at a time; df rounded once to
bf16. Forward at fp32: fp64 prefix sums of
f, a clip mean is (P[end] - P[start]) / size rounded to fp32, times the mask
in fp32; fm the fp32 sum of the C clips over C; fb (P[(l+1) T/L] - P[l T/L]) /
(T/L). Forward at bf16: the same in fp32 throughout (prefix sums by a
two-level scan over 8 warps' runs of frames, a clip mean (P[end] - P[start])
times the fp32 1 / size), each output rounded once.

Tolerances: chip_smoke.py's. K1's forward and backward and K8's forward:
rtol 1e-4, atol 1e-5 (``K1_TOL``); K6's and K8's backward: rtol 5e-4, atol 5e-5
of the gradient's magnitude; at bf16 one bf16 rounding (2^-8 of the value) on
top of them against the plain version's fp32 value, and against the JAX XLA
functions run at bf16 (which round fc before its mask and each summand of
df) tests/test_torch_bf16_train.py's two roundings: rtol 1e-2, atol 1e-3, and
for df and fm 2^-7 of the summands' magnitude on top (the dense fc: rtol
2e-2, JAX rounding its fractional moment_mask too).
`test_backward_scan_error_against_float64` prints the mirror's largest error
against the same scatter and scan in float64 at each shipped map and holds it
to the same tolerance.
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

GROUP = 4     # csrc/proposal_rows.cu: kGroup
BOX_MOMENTS = 8   # csrc/proposal_rows.cu: kBoxMoments
SCATTER_GROUP = 4   # csrc/proposal_rows.cu: kScatterGroup
POOL16_WARPS = 8   # csrc/proposal.cuh: kPool16Warps
SLOTS = 5     # csrc/proposal_rows.cu: kSlots
K1_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_RTOL, GRAD_ATOL_REL = 5e-4, 5e-5
BF16_REL = 2.0 ** -8
# Two bf16 roundings (tests/test_torch_bf16_train.py: K1-bf16 against JAX).
JAX_BF16_TOL = dict(rtol=1e-2, atol=1e-3)
# The dense forward at bf16: JAX rounds the clip mean, the fractional
# moment_mask and their product, the kernel the product once: four
# roundings of up to 2^-8 of the value between them.
JAX_BF16_DENSE_FWD_RTOL = 2e-2

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


def _scatter(diff, group, dfc, starts, ends, T, dtype, b):
    """Scatter a group of moments (n, i, j, valid, wk, gm) into one warp's
    difference array ``diff`` (T, D): SLOTS clip boundaries at a time, each
    moment's in turn, as the kernels do."""
    D = diff.shape[-1]
    prev = [np.zeros(D, dtype) for _ in group]
    C = dfc.shape[2]
    for c0 in range(0, C + 1, SLOTS):
        for k, (n, i, j, valid, wk, gm) in enumerate(group):
            for c in range(c0, min(c0 + SLOTS, valid + 1)):
                g = ((dfc[b, n, c].astype(dtype) + gm) * wk).astype(dtype) \
                    if c < valid else np.zeros(D, dtype)
                pos = starts[i, j, c] if c < valid else ends[i, j, valid - 1]
                if pos < T:
                    diff[pos] += g - prev[k]
                prev[k] = g


def _chunks(pairs, live, L, dense):
    """The bf16 backward's chunks of one element: its unmasked moments in pair
    order, cut where a run of consecutive moment indices starts and at each
    index that is a multiple of BOX_MOMENTS."""
    chunks, prev = [], None
    for i, j in pairs:
        if (i, j) not in live:
            continue
        n = _index(i, j, L, dense)
        if prev is None or n != prev + 1 or n % BOX_MOMENTS == 0:
            chunks.append([])
        chunks[-1].append((i, j))
        prev = n
    return chunks


def _partition(pairs, live, warps, bf16, L, dense):
    """Each warp's moments of one element, in its scatter order and groups:
    at fp32 the pairs q = warp (mod W) whose mask is not 0, four at a time; at
    bf16 the chunks warp (mod W) in order, SCATTER_GROUP moments of a chunk
    a group."""
    out = []
    chunks = _chunks(pairs, live, L, dense) if bf16 else None
    for warp in range(warps):
        if bf16:
            groups = [chunk[g0:g0 + SCATTER_GROUP] for chunk in chunks[warp::warps]
                      for g0 in range(0, len(chunk), SCATTER_GROUP)]
        else:
            mine = [ij for ij in pairs[warp::warps] if ij in live]
            groups = [mine[g0:g0 + GROUP] for g0 in range(0, len(mine), GROUP)]
        out.append(groups)
    return out


def mirror_backward(T, L, C, mask, dfc, dfm, dfb, dense, dtype=np.float32, bf16=False):
    """df (B, T, D) as the backward kernel computes it; ``dtype`` is that of
    the difference arrays and of g (the scan is fp64 in any case); ``bf16``:
    the bf16 kernel's partition over warps (the inputs hold bf16 values; df
    is returned before its rounding to bf16)."""
    starts, sizes, ends = _closed_form(T, L, C)
    vm = _moment_mask(mask, L, dense).astype(dtype)
    B, D = dfc.shape[0], dfc.shape[-1]
    warps = proposal_cuda.pair_plan(T, L, C)[0] if bf16 else proposal_cuda.backward_warps(T, L)
    diff = np.zeros((warps, B, T, D), dtype)
    inv_c = dtype(1.0) / dtype(C)
    pairs = _pairs(L)
    for b in range(B):
        live = {(i, j) for i, j in pairs if vm[b, _index(i, j, L, dense)] != 0}
        for warp, groups in enumerate(_partition(pairs, live, warps, bf16, L, dense)):
            for members in groups:
                group = []
                for i, j in members:
                    n = _index(i, j, L, dense)
                    valid = int((sizes[i, j] > 0).sum())
                    group.append((n, i, j, valid, vm[b, n] / dtype(sizes[i, j, 0]),
                                  dfm[b, n].astype(dtype) * inv_c))
                _scatter(diff[warp, b], group, dfc, starts, ends, T, dtype, b)
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


def mirror_forward_bf16(T, L, C, f, mask, dense):
    """(fc, fm, fb) as the bf16 pooling kernel computes them, before the
    rounding to bf16 (``f`` holds bf16 values): fp32 prefix sums, each of
    the block's 8 warps scanning a run of ceil(T / 8) frames and adding the
    runs before it in warp order."""
    starts, sizes, ends = _closed_form(T, L, C)
    B, _, D = f.shape
    x = f.astype(np.float32)
    run = -(-T // POOL16_WARPS)
    P = np.zeros((B, T + 1, D), np.float32)
    totals = []
    for w in range(POOL16_WARPS):
        t0 = min(T, w * run)
        acc = np.zeros((B, D), np.float32)
        for t in range(t0, min(T, t0 + run)):
            acc = acc + x[:, t]
            P[:, t + 1] = acc
        totals.append(acc)
    for w in range(POOL16_WARPS):
        t0 = min(T, w * run)
        off = np.zeros((B, D), np.float32)
        for v in range(w):
            off = off + totals[v]
        P[:, t0 + 1:min(T, t0 + run) + 1] += off[:, None]
    cells = [(i, j) for i in range(L) for j in range(L)] if dense else _pairs(L)
    vm = _moment_mask(mask, L, dense).astype(np.float32)
    fc = np.zeros((B, len(cells), C, D), np.float32)
    for n, (i, j) in enumerate(cells):
        for c in range(C):
            if i <= j and sizes[i, j, c] > 0:
                w = np.float32(1) / np.float32(sizes[i, j, c])
                fc[:, n, c] = ((P[:, ends[i, j, c]] - P[:, starts[i, j, c]]) * w) * vm[:, n, None]
    fm = np.zeros((B, len(cells), D), np.float32)
    for c in range(C):
        fm = fm + fc[:, :, c]
    fm = fm / np.float32(C)
    tl = T // L
    fb = (P[:, tl::tl] - P[:, :-1:tl]) / np.float32(tl)
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


def _bf16(x):
    """x rounded to bf16 (nearest even), as float32."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16).float().numpy()


def _assert_one_rounding(got, ref, tol, name):
    """|got - ref| <= (2^-8 + tol's rtol) |ref| + tol's atol: one bf16 rounding
    of the fp32 value ``ref`` on top of the fp32 kernel's tolerance."""
    bound = (BF16_REL + tol["rtol"]) * np.abs(ref) + tol["atol"]
    err = np.abs(got - ref)
    assert (err <= bound).all(), (name, float((err - bound).max()))


def _assert_one_ulp(got, other, tol, name):
    """Two values each rounded once to bf16 from fp32 values within ``tol``
    of each other: at most one bf16 unit (2^-7 of the value) apart."""
    bound = (2 * BF16_REL + tol["rtol"]) * np.maximum(np.abs(got), np.abs(other)) + tol["atol"]
    assert (np.abs(got - other) <= bound).all(), name


@pytest.mark.parametrize("dense", [False, True], ids=["packed", "dense"])
@pytest.mark.parametrize("geo", list(GEOMETRIES), ids=list(GEOMETRIES))
def test_backward_mirror_bf16_matches_plain_and_jax(geo, dense):
    """The bf16 backward's partition (the chunks w (mod W) of consumer warp w,
    four moments at a time) on bf16 cotangents, df rounded once:
    within one rounding of the plain version's fp32 value, one bf16 unit of
    `proposal_rows_backward_plain_bf16`, and two roundings (and 2^-7 of the
    summands) of the JAX XLA function's VJP at bf16."""
    T, L, C = GEOMETRIES[geo]
    f, mask, cots = _inputs(T, L, C, dense, B=3, D=16, seed=T + L + C + 1)
    f, cots = _bf16(f), [_bf16(c) for c in cots]
    got = _bf16(mirror_backward(T, L, C, mask, *cots, dense, bf16=True))
    shaped = [torch.from_numpy(c) for c in _cots_of(cots, L, dense)]
    tmask = torch.from_numpy(mask)
    plain32 = proposal_cuda.proposal_backward_plain(tmask, T, L, C, *shaped).numpy()
    plain16 = proposal_cuda.proposal_rows_backward_plain_bf16(
        tmask, T, L, C, *(c.bfloat16() for c in shaped)).float().numpy()
    tol = K1_TOL if geo == "charades" and not dense else dict(
        rtol=GRAD_RTOL, atol=GRAD_ATOL_REL * float(np.abs(plain32).max()))
    _assert_one_rounding(got, plain32, tol, "against proposal_backward_plain")
    _assert_one_ulp(got, plain16, tol, "against proposal_rows_backward_plain_bf16")
    jfn = j_dense if dense else j_packed
    _, vjp = jax.vjp(lambda x: jfn(x, jnp.asarray(mask), L, C), jnp.asarray(f, jnp.bfloat16))
    jax_df = np.asarray(vjp(tuple(jnp.asarray(c.numpy(), jnp.bfloat16) for c in shaped))[0],
                        np.float32)
    summands = proposal_cuda.proposal_backward_plain(tmask, T, L, C,
                                                     *(c.abs() for c in shaped)).numpy()
    bound = JAX_BF16_TOL["atol"] + JAX_BF16_TOL["rtol"] * np.abs(jax_df) + 2.0 ** -7 * summands
    assert (np.abs(got - jax_df) <= bound).all(), float((np.abs(got - jax_df) - bound).max())


@pytest.mark.parametrize("dense", [False, True], ids=["packed", "dense"])
@pytest.mark.parametrize("geo", list(SHIPPED), ids=list(SHIPPED))
def test_forward_mirror_bf16_matches_plain_and_jax(geo, dense):
    """The bf16 forward (fp32 prefix sums of bf16 f, each output rounded
    once): within one rounding of the plain version's fp32 value,
    equal to `proposal_rows_forward_plain_bf16` within one bf16 unit, and
    within two roundings of the JAX XLA function at bf16 (fm: and 2^-7 of
    its clip means' magnitude; dense: four roundings)."""
    T, L, C = SHIPPED[geo]
    f, mask, _ = _inputs(T, L, C, dense, B=3, D=16, seed=T + L + C + 2)
    f = _bf16(f)
    got = [_bf16(x) for x in mirror_forward_bf16(T, L, C, f, mask, dense)]
    tf, tmask = torch.from_numpy(f), torch.from_numpy(mask)
    plain_fn = proposal_cuda.proposal_features if dense else proposal_cuda.proposal_features_packed
    plain32 = plain_fn(tf, tmask, L, C)
    plain16 = proposal_cuda.proposal_rows_forward_plain_bf16(tf.bfloat16(), tmask, L, C)
    want_jax = (j_dense if dense else j_packed)(jnp.asarray(f, jnp.bfloat16), jnp.asarray(mask),
                                                L, C)
    # JAX's fm averages the C clip means after rounding each: 2^-7 of their
    # mean magnitude on top where they cancel.
    summands = [0.0, 2.0 ** -7 * plain32[0].abs().mean(dim=-2).numpy(), 0.0]
    for g, p32, p16, w, extra, name in zip(got, plain32, plain16, want_jax, summands,
                                           ("fc", "fm", "fb")):
        _assert_one_rounding(g, p32.numpy(), K1_TOL, f"{name} against the plain fp32 value")
        _assert_one_ulp(g, p16.float().numpy(), K1_TOL, f"{name} against the plain bf16")
        w = np.asarray(w, np.float32)
        rtol = JAX_BF16_DENSE_FWD_RTOL if dense else JAX_BF16_TOL["rtol"]
        bound = JAX_BF16_TOL["atol"] + rtol * np.abs(w) + extra
        assert (np.abs(g - w) <= bound).all(), (name, float((np.abs(g - w) - bound).max()))

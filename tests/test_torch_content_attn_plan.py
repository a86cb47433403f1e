"""The tile plan of the content-attention pair (csrc/content_attn.cuh) and the
order of its backward's sums, through the Python mirror in
ops/content_attn_cuda.py, on the CPU: the plan admits every shipped config
at every batch and query length within a block's 227 KB of shared memory,
its tiles cover every pair of an element exactly once (the last one
ragged), and a numpy mirror of the backward's two-stage fixed-order sums of
dfwh, dkhat and dfsh agrees with float64 within fp32 rounding. The pair's
plain version is held to the port's content unit, which
tests/test_torch_smin_stack.py holds to the JAX package. chip_smoke.py holds
the mirror against the C plan on the card; the kernels are held to the plain
version there and in tests/test_torch_cuda.py.
"""

import math
import os

import numpy as np
import pytest
import torch

from video_moment_localization_tpu_torch.config import ModelConfig, load_config
from video_moment_localization_tpu_torch.models.smin import SMIN, _linear, content_unit_packed
from video_moment_localization_tpu_torch.ops import content_attn_cuda as ca
from video_moment_localization_tpu_torch.ops.cuda_build import MAX_SMEM_BYTES
from video_moment_localization_tpu_torch.ops.packing import packed_valid_mask

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ("charadessta", "activitynet", "tacos")
BATCHES = (1, 16, 64, 512)
MAX_GRID_X = 2 ** 31 - 1
# The narrow widths of the card tests (tests/test_torch_cuda.py): TINY, ODD
# (no multiple of 4) and the content route's C=9.
NARROW = ((4, 6, 32, 8), (3, 5, 10, 5), (9, 6, 32, 32))   # C, Nq, dl, L


def _cfg(name):
    return load_config(os.path.join(REPO, "config", f"{name}.yml")).model


def _check_plan(B, N, C, Nq, dl, backward):
    p = ca.plan(B, N, C, Nq, dl, backward)
    assert 0 < p["smem"] <= MAX_SMEM_BYTES, p
    assert p["smem"] == 4 * ca.smem_floats(p["pp"], C, Nq, dl, backward)
    s = ca.shape(p["pp"], C, Nq, dl)
    assert s["R"] <= ca.ROWS or p["pp"] == 1
    # The word phases give each of 4 word groups at most 8 words.
    assert s["NQ4"] // 4 <= 8
    if backward:
        assert s["dl4"] <= 2 * ca.chunk_threads(s["RP"])
    assert 1 <= p["passes"] <= ca.MAX_PASSES
    assert B * p["tiles"] <= MAX_GRID_X
    covered = []
    for passes in ca.tile_bounds(p, N):
        assert 1 <= len(passes) <= p["passes"]
        for n0, n1 in passes:
            assert 1 <= n1 - n0 <= p["pp"]
            covered.extend(range(n0, n1))
    assert covered == list(range(N))
    return p


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("config", CONFIGS)
def test_plan_admits_every_shipped_config(config, B, backward):
    cfg = _cfg(config)
    N = cfg.L * (cfg.L + 1) // 2
    for Nq in range(1, cfg.max_query_length + 1):
        p = _check_plan(B, N, cfg.C, Nq, cfg.dl, backward)
        assert p["pp"] * cfg.C == ca.ROWS
    assert ca.partial_floats(B, N, cfg.C, cfg.max_query_length, cfg.dl) == (
        B * ca.plan(B, N, cfg.C, cfg.max_query_length, cfg.dl, True)["tiles"]
        * (2 * cfg.max_query_length * cfg.dl + cfg.dl))


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("C,Nq,dl,L", NARROW)
def test_plan_admits_the_narrow_test_widths(C, Nq, dl, L, backward):
    for B in (1, 2, 7, 9):
        _check_plan(B, L * (L + 1) // 2, C, Nq, dl, backward)


@pytest.mark.parametrize("B,expect", [(1, 1), (64, 8), (512, 16)])
def test_plan_fills_the_card_at_activitynet(B, expect):
    """Passes grow while at least four blocks per SM slot remain; the
    ragged last tile holds the rest of the element's 2,080 pairs."""
    p = ca.plan(B, 2080, 4, 20, 128, False)
    assert p["passes"] == expect
    per_sm = ca.SMEM_PER_SM // (p["smem"] + ca.RESERVED_PER_BLOCK)
    assert per_sm == 2
    if p["passes"] > 1:
        assert B * p["tiles"] >= 4 * ca.SMS * per_sm
    last = ca.tile_bounds(p, 2080)[-1]
    assert sum(n1 - n0 for n0, n1 in last) == 2080 - (p["tiles"] - 1) * p["pp"] * p["passes"]


def _arrays(layout):
    return [(k, v) for k, v in layout.items() if k not in ("DSS", "fused", "bytes")]


@pytest.mark.parametrize("C,Nq,dl,L", NARROW + ((4, 13, 128, 16), (4, 20, 128, 64),
                                                (4, 13, 128, 32)))
def test_fp32_backward_layout_is_the_floats_of_the_kernel(C, Nq, dl, L):
    """The fp32 backward's byte layout is `smem_floats`' arrays end to end:
    the fp32 kernel's shared memory is unchanged."""
    p = ca.plan(2, L * (L + 1) // 2, C, Nq, dl, True)
    lay = ca.bwd_layout(p["pp"], C, Nq, dl, False)
    assert lay["bytes"] == p["smem"] == 4 * ca.smem_floats(p["pp"], C, Nq, dl, True)
    assert lay["DSS"] == ca.shape(p["pp"], C, Nq, dl)["DS"]


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("config", CONFIGS)
def test_bf16_backward_plan_is_the_fp32_plan_on_half_the_memory(config, B):
    """The bf16 backward (its rows staged as bf16) at every shipped width
    and query length: the fp32 backward's pairs per pass, passes and tiles
    (the shipped widths fit one block an SM either way), less than 60 % of
    its shared memory, no g or clip arrays on the fused path, and partials
    for its tiles."""
    cfg = _cfg(config)
    N = cfg.L * (cfg.L + 1) // 2
    for Nq in range(1, cfg.max_query_length + 1):
        p = ca.plan(B, N, cfg.C, Nq, cfg.dl, True, bf16=True)
        f32 = ca.plan(B, N, cfg.C, Nq, cfg.dl, True)
        lay = ca.bwd_layout(p["pp"], cfg.C, Nq, cfg.dl, True)
        assert (p["pp"], p["passes"], p["tiles"]) == (f32["pp"], f32["passes"], f32["tiles"])
        assert lay["fused"] and p["smem"] == lay["bytes"] < 0.6 * f32["smem"]
        assert lay["G"] == lay["As"] == lay["dAs"] == 0
    q = cfg.max_query_length
    assert ca.partial_floats(B, N, cfg.C, q, cfg.dl, bf16=True) == ca.partial_floats(
        B, N, cfg.C, q, cfg.dl)


def test_bf16_backward_shared_memory_at_the_charades_width():
    """Charades (C 4, Nq 13, dl 128, 16 pairs a pass): khat and fwh (16
    staged words) and the pass's q, h and dfcc (64 rows each) as bf16 rows
    of 136 values (272 bytes); fsh, the masks, da (64 fp32 rows of 132), p
    and ds (64 x 16 floats) and the tile's dfwh and dkhat (16 x 128 floats):
    119,952 bytes against the fp32 backward's 213,136."""
    lay = ca.bwd_layout(16, 4, 13, 128, True)
    assert lay["DSS"] == 136
    assert lay["bytes"] == (2 * 16 * 272 + 528 + 64 + 64 + 3 * 64 * 272 + 64 * 528
                            + 2 * 64 * 16 * 4 + 2 * 16 * 128 * 4) == 119952
    assert ca.plan(64, 136, 4, 13, 128, True)["smem"] == 213136
    assert ca.plan(64, 136, 4, 13, 128, True, bf16=True)["smem"] == 119952


@pytest.mark.parametrize("C,Nq,dl,L", NARROW)
def test_bf16_backward_layout_at_the_narrow_widths(C, Nq, dl, L):
    """The narrow test widths: staged rows at 8-byte chunks, arrays 16-byte
    aligned and apart; off the fused path (C != 4) g and the clip arrays are
    there too."""
    p = ca.plan(3, L * (L + 1) // 2, C, Nq, dl, True, bf16=True)
    assert p["smem"]
    lay = ca.bwd_layout(p["pp"], C, Nq, dl, True)
    assert (2 * lay["DSS"]) % 8 == 0 and lay["DSS"] >= dl
    present = sorted(off for name, off in _arrays(lay) if off or name == "K")
    assert all(off % 16 == 0 for off in present) and len(set(present)) == len(present)
    assert lay["fused"] == (C == 4) and (lay["G"] > 0) == (C != 4)


def test_plan_refuses_what_the_kernels_do_not_take():
    assert ca.plan(4, 10, 4, 33, 128, False)["smem"] == 0      # Nq past 32
    assert ca.plan(4, 10, 65, 6, 32, False)["smem"] == 0       # C past a pass's rows
    assert ca.plan(4, 10, 65, 6, 32, True)["smem"] == 0
    assert ca.plan(0, 10, 4, 6, 32, False)["smem"] == 0


def _sums_in_kernel_order(p, C, N, a, w, dg_h):
    """The backward's sums for one element in the kernels' fp32 order:
    dfwh[m] = sum_r a[r, m] w[r] and dkhat[m] = sum_r ... row by row within a
    tile (passes in order, rows in order); dfsh per thread of 4 rows and a
    chunk over the passes, then over the row groups in order; then the
    tiles' partials in tile order. a (rows, Nq), w (rows, dl), dg_h (rows,
    dl) float32. Returns (dfwh, dfsh)."""
    s = ca.shape(p["pp"], C, 1, w.shape[1])
    RG = s["RP"] // 4
    tiles_fw, tiles_fs = [], []
    for passes in ca.tile_bounds(p, N):
        fw = np.zeros((a.shape[1], w.shape[1]), np.float32)
        groups = np.zeros((RG, w.shape[1]), np.float32)
        for n0, n1 in passes:
            for r in range(n0 * C, n1 * C):
                fw = (fw + np.outer(a[r], w[r]).astype(np.float32)).astype(np.float32)
                g = (r - n0 * C) // 4
                groups[g] = (groups[g] + dg_h[r]).astype(np.float32)
        fs = np.zeros(w.shape[1], np.float32)
        for g in range(RG):
            fs = (fs + groups[g]).astype(np.float32)
        tiles_fw.append(fw)
        tiles_fs.append(fs)
    fw = np.zeros_like(tiles_fw[0])
    fs = np.zeros_like(tiles_fs[0])
    for t in range(len(tiles_fw)):
        fw = (fw + tiles_fw[t]).astype(np.float32)
        fs = (fs + tiles_fs[t]).astype(np.float32)
    return fw, fs


@pytest.mark.parametrize("B,N,C,Nq,dl", [(64, 136, 4, 13, 16), (64, 2080, 4, 20, 8),
                                         (1, 2080, 4, 20, 8), (7, 15, 3, 5, 10)])
def test_backward_sum_order_within_fp32_rounding(B, N, C, Nq, dl):
    p = ca.plan(B, N, C, Nq, dl, True)
    rng = np.random.default_rng(N + C)
    rows = N * C
    a = rng.random((rows, Nq)).astype(np.float32)          # p or ds of each row
    w = rng.standard_normal((rows, dl)).astype(np.float32)  # da or q of each row
    dg_h = rng.standard_normal((rows, dl)).astype(np.float32)
    got_fw, got_fs = _sums_in_kernel_order(p, C, N, a, w, dg_h)
    want_fw = a.astype(np.float64).T @ w.astype(np.float64)
    want_fs = dg_h.astype(np.float64).sum(axis=0)
    # Recursive fp32 summation: at most (terms - 1) roundings of 2^-24 of the
    # running sum of magnitudes; a tile adds at most pp * passes * C rows,
    # then the tiles add up.
    terms = p["pp"] * p["passes"] * C + p["tiles"]
    mag_fw = np.abs(a.astype(np.float64)).T @ np.abs(w.astype(np.float64))
    mag_fs = np.abs(dg_h.astype(np.float64)).sum(axis=0)
    assert np.all(np.abs(got_fw - want_fw) <= terms * 2.0 ** -24 * mag_fw + 1e-30)
    assert np.all(np.abs(got_fs - want_fs) <= terms * 2.0 ** -24 * mag_fs + 1e-30)


def _pair_inputs(cfg, B, seed):
    rng = np.random.default_rng(seed)
    N = cfg.L * (cfg.L + 1) // 2
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))   # noqa: E731
    fc, fw, fs = t(B, N, cfg.C, cfg.D), t(B, cfg.max_query_length, cfg.D), t(B, cfg.D)
    fm = t(B, N, cfg.D)
    qlen = rng.integers(1, cfg.max_query_length + 1, size=B)
    qlen[0] = cfg.max_query_length
    nlen = rng.integers(1, cfg.L + 1, size=B)
    nlen[0] = cfg.L
    qmask = (np.arange(cfg.max_query_length)[None, :] < qlen[:, None]).astype(np.float32)
    lmask = (np.arange(cfg.L)[None, :] < nlen[:, None]).astype(np.float32)
    qmask, lmask = torch.from_numpy(qmask[..., None]), torch.from_numpy(lmask)
    return fc, fm, fw * qmask, fs, qmask, packed_valid_mask(lmask)


@pytest.mark.parametrize("cfg", [ModelConfig(T=16, L=8, C=4, D=64, dl=32, num_smi_layers=1,
                                             max_query_length=6, lstm_hidden_size=32),
                                 ModelConfig(T=10, L=5, C=3, D=30, dl=10, num_smi_layers=1,
                                             max_query_length=5, lstm_hidden_size=15)])
def test_pair_plain_is_the_content_unit_between_its_projections(cfg):
    torch.manual_seed(0)
    unit = SMIN(cfg).smis[0].content_unit
    fc, fm, fw, fs, qmask, vmask = _pair_inputs(cfg, 3, seed=cfg.C)
    with torch.no_grad():
        want = content_unit_packed(unit, fc, fw, fs, fm, qmask, vmask)
        fcc = ca.content_attn_forward(*ca.unit_projections(unit, fc, fw, fs, qmask, vmask),
                                      qmask, vmask)
        fbar = torch.sigmoid(fm * fs[:, None, :]) * fm
        got = (_linear(unit.linear_c, fcc) * vmask[..., None, None] + fc
               + fbar[:, :, None, :])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_pair_backward_plain_matches_float64():
    """The backward's plain version on the CPU (autograd through the plain
    forward) against the same VJP in float64, with a query of no valid word
    and an invalid pair."""
    rng = np.random.default_rng(1)
    B, N, C, dl = 2, 21, 4, 16
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))   # noqa: E731
    h, q, dfcc = t(B, N, C, dl), t(B, N, C, dl), t(B, N, C, dl)
    khat, fwh, fsh = t(B, 5, dl), t(B, 5, dl), t(B, dl)
    qmask = torch.ones(B, 5, 1)
    qmask[1] = 0.0
    vmask = torch.ones(B, N)
    vmask[0, -3:] = 0.0
    got = ca.content_attn_backward(h, q, khat, fwh, fsh, qmask, vmask, dfcc)
    want = ca.content_attn_backward_plain(*(x.double() for x in (h, q, khat, fwh, fsh)),
                                          qmask.double(), vmask.double(), dfcc.double())
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        torch.testing.assert_close(g.double(), w, rtol=1e-4, atol=1e-5)
    # No gradient reaches a word that no row may attend to.
    assert float(got[3][1].abs().max()) == 0.0
    assert math.isfinite(float(got[2].abs().max()))

"""Card tests of the port's kernels: each CUDA kernel against its plain
PyTorch version on the same card, the serving path on the card against the
same localizer on the CPU, and a train step on the card against the same
step on the CPU. They skip where there is no CUDA device.

The file imports neither JAX nor the JAX package, so the card machine runs it
without them:

    python -m pytest -q --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from video_moment_localization_tpu_torch.config import Config, ModelConfig
from video_moment_localization_tpu_torch.data.glove import WordEmbedding
from video_moment_localization_tpu_torch.inference import MomentLocalizer
from video_moment_localization_tpu_torch.models.lstm import BiLSTMParams, lstm_layers
from video_moment_localization_tpu_torch.models.smin import SMIN, block_weights
from video_moment_localization_tpu_torch.ops import (
    content_cuda,
    content_train_cuda,
    lstm_cuda,
    proposal_cuda,
    smin_cuda,
    smin_train_cuda,
)
from video_moment_localization_tpu_torch.ops.packing import packed_valid_mask, unpack_map
from video_moment_localization_tpu_torch.parallel.steps import build_optimizer, make_train_step

pytestmark = pytest.mark.cuda

LSTM_TOL = dict(rtol=2e-5, atol=2e-5)
STACK_TOL = dict(rtol=2e-4, atol=2e-5)
# Gradients: tests/test_smin_train_pallas.py's rtol 5e-4; the absolute part is
# relative to a magnitude, because a weight gradient sums thousands of rows
# in another order than the plain version: an activation gradient's own
# largest magnitude, and for the weights the largest over the layer's 20 (a
# key-projection bias shifts every logit of a row alike, so its gradient is
# structurally zero and only rounding noise of the others' size is left).
GRAD_RTOL, GRAD_ATOL_REL = 5e-4, 5e-5
CHARADES = ModelConfig()
ACTIVITYNET = ModelConfig(T=128, L=64, C=4, D=512, dl=128, input_video_dim=500,
                          max_query_length=20, lstm_hidden_size=256, num_smi_layers=3)
# TACoS at fp32 also takes the content-unit route (K6, K7): two frames per
# snippet at T=128, four frames at L=32.
TACOS = ModelConfig(T=128, L=32, C=4, D=512, dl=128, input_video_dim=4096,
                    max_query_length=14, lstm_hidden_size=256, num_smi_layers=3)

TINY = ModelConfig(T=16, L=8, C=4, D=64, dl=32, num_smi_layers=3, input_video_dim=12,
                   max_query_length=6, lstm_hidden_size=32)
# Widths that are no multiple of 4 or of a GEMM tile: the scalar-load path and
# the ragged tile edges of every operand layout.
ODD = ModelConfig(T=10, L=5, C=3, D=30, dl=10, num_smi_layers=2, input_video_dim=7,
                  max_query_length=5, lstm_hidden_size=15)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; python3 chip_smoke.py runs the port there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("B,Din,H", [(1, 300, 256), (37, 300, 256), (8, 36, 128), (20, 7, 32)])
def test_bilstm_kernel_matches_plain(card, B, Din, H):
    torch.manual_seed(B)
    S = 13
    layers = lstm_layers(BiLSTMParams(Din, H, 2).to(card))
    x = torch.randn(B, S, Din, device=card)
    lengths = torch.randint(1, S + 1, (B,))
    lengths[0] = 1
    mask = (torch.arange(S)[None, :] < lengths[:, None]).float().to(card)
    before = lstm_cuda.bilstm_fused.launches
    with torch.no_grad():
        got = lstm_cuda.bilstm_fused(x, mask, layers)
        want = lstm_cuda.bilstm_plain(x, mask, layers)
    torch.cuda.synchronize()
    assert lstm_cuda.bilstm_fused.launches == before + 1
    torch.testing.assert_close(got, want, **LSTM_TOL)
    assert bool((got[mask == 0] == 0).all())


def _stack_inputs(cfg, B, seed, device):
    g = torch.Generator().manual_seed(seed)
    Nq = cfg.max_query_length
    f = torch.randn(B, cfg.T, cfg.D, generator=g)
    fw = torch.randn(B, Nq, cfg.D, generator=g)
    fs = torch.randn(B, cfg.D, generator=g)
    qlen = torch.randint(0, Nq + 1, (B,), generator=g)     # 0: no valid word
    qmask = (torch.arange(Nq)[None, :] < qlen[:, None]).float()[..., None]
    nlen = torch.randint(1, cfg.L + 1, (B,), generator=g)
    lmask = (torch.arange(cfg.L)[None, :] < nlen[:, None]).float()
    ins = [t.to(device) for t in (f, fw * qmask, fs, qmask, lmask)]
    return ins + [packed_valid_mask(ins[4]).contiguous()]


@pytest.mark.parametrize("cfg,B", [(TINY, 1), (TINY, 9), (CHARADES, 5)])
def test_smin_stack_kernel_matches_plain(card, cfg, B):
    torch.manual_seed(B)
    model = SMIN(cfg).to(card).eval()
    ins = _stack_inputs(cfg, B, seed=B, device=card)
    before = smin_cuda.smin_stack_fused.launches
    with torch.no_grad():
        got = smin_cuda.smin_stack_fused(model, cfg, *ins)
        want = smin_cuda.smin_stack_plain(model, cfg, *ins)
    torch.cuda.synchronize()
    assert smin_cuda.smin_stack_fused.launches == before + 1
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        torch.testing.assert_close(g, w, **STACK_TOL)


def test_wrappers_refuse_wrong_dtype_on_card(card):
    layers = lstm_layers(BiLSTMParams(8, 32, 2).to(card))
    x = torch.randn(2, 3, 8, device=card, dtype=torch.float64)
    with pytest.raises(ValueError, match="float32"):
        lstm_cuda.bilstm_fused(x, torch.ones(2, 3, device=card), layers)
    model = SMIN(TINY).to(card)
    ins = _stack_inputs(TINY, 2, seed=0, device=card)
    ins[0] = ins[0].double()
    with pytest.raises(ValueError, match="float32"):
        smin_cuda.smin_stack_fused(model, TINY, *ins)


@pytest.mark.parametrize("use_nms", [False, True])
def test_localizer_on_card_matches_cpu(card, use_nms):
    torch.manual_seed(0)
    model = SMIN(TINY)
    emb = WordEmbedding.synthetic(["person", "opens", "the", "door", "sits"], dim=300)
    kw = dict(serve_batch=8, use_nms=use_nms)
    gpu = MomentLocalizer(TINY, SMIN(TINY), emb, **kw)
    gpu.model.load_state_dict(model.state_dict())
    cpu = MomentLocalizer(TINY, model, emb, device="cpu", **kw)
    rng = np.random.default_rng(1)
    vids = [rng.standard_normal((int(n), 12)).astype(np.float32) for n in (5, 16, 40)]
    reqs = [(vids[k % 3], ["person opens the door", "the xylophone sits"][k % 2], 9.0)
            for k in range(11)]
    for g, c in zip(gpu.localize_batch(reqs, top_k=5), cpu.localize_batch(reqs, top_k=5)):
        assert [(m.start, m.end) for m in g] == [(m.start, m.end) for m in c]
        np.testing.assert_allclose([m.score for m in g], [m.score for m in c], atol=1e-5)


def _assert_grad_close(got, want, name, scale=None):
    assert bool(torch.isfinite(got).all()), name
    scale = float(want.abs().max()) if scale is None else scale
    torch.testing.assert_close(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL_REL * scale,
                               msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("cfg,B", [(TINY, 3), (ODD, 7), (CHARADES, 5), (CHARADES, 64),
                                   (TACOS, 2)])
def test_proposal_rows_kernels_match_plain(card, cfg, B):
    g = torch.Generator().manual_seed(B)
    f = torch.randn(B, cfg.T, cfg.D, generator=g).to(card)
    nlen = torch.randint(1, cfg.L + 1, (B,), generator=g)
    nlen[0] = cfg.L
    lmask = (torch.arange(cfg.L)[None, :] < nlen[:, None]).float().to(card)
    before = (proposal_cuda.proposal_rows_forward.launches,
              proposal_cuda.proposal_rows_backward.launches)
    f.requires_grad_(True)
    got = proposal_cuda.proposal_features_rows(f, lmask, cfg.L, cfg.C)
    cots = [torch.randn(o.shape, generator=g).to(card) for o in got]
    df = torch.autograd.grad(got, f, cots)[0]
    want = proposal_cuda.proposal_features_packed(f, lmask, cfg.L, cfg.C)
    df_want = torch.autograd.grad(want, f, cots)[0]
    torch.cuda.synchronize()
    assert (proposal_cuda.proposal_rows_forward.launches,
            proposal_cuda.proposal_rows_backward.launches) == (before[0] + 1, before[1] + 1)
    for o, w in zip(got, want):
        torch.testing.assert_close(o, w, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(df, df_want, rtol=1e-4, atol=1e-4)


def _layer_inputs(cfg, B, seed, device):
    f, fw, fs, qmask, lmask, vmask = _stack_inputs(cfg, B, seed, device)
    fc, fm, fb = proposal_cuda.proposal_features_packed(f, lmask, cfg.L, cfg.C)
    return [t.contiguous() for t in (fc, fm, fb, fw, fs, qmask, lmask, vmask)]


@pytest.mark.parametrize("cfg,B", [(TINY, 1), (TINY, 9), (ODD, 7), (CHARADES, 5)])
@pytest.mark.parametrize("has_dcu", [True, False])
def test_smi_layer_kernels_match_plain(card, cfg, B, has_dcu):
    torch.manual_seed(B)
    weights = [w.detach() for w in block_weights(SMIN(cfg).to(card).smis[1])]
    ins = _layer_inputs(cfg, B, seed=B, device=card)
    before = (smin_train_cuda.smi_layer_forward.launches,
              smin_train_cuda.smi_layer_backward.launches)
    with torch.no_grad():
        got = smin_train_cuda.smi_layer_forward(weights, *ins, cfg.L)
        want = smin_train_cuda.smi_layer_plain(weights, *ins, cfg.L)
    for g_, w_, name in zip(got, want, ("cu", "mu", "bu")):
        torch.testing.assert_close(g_, w_, **STACK_TOL, msg=lambda m: f"{name}: {m}")
    gen = torch.Generator().manual_seed(100 + B)
    dcu, dmu, dbu = [torch.randn(t.shape, generator=gen).to(card) for t in want]
    if not has_dcu:
        dcu = None
    got = smin_train_cuda.smi_layer_backward(weights, *ins, cfg.L, dcu, dmu, dbu)
    want = smin_train_cuda.smi_layer_backward_plain(weights, *ins, cfg.L, dcu, dmu, dbu)
    torch.cuda.synchronize()
    assert (smin_train_cuda.smi_layer_forward.launches,
            smin_train_cuda.smi_layer_backward.launches) == (before[0] + 1, before[1] + 1)
    for g_, w_, name in zip(got[:5], want[:5], ("dfc", "dfm", "dfb", "dfw", "dfs")):
        _assert_grad_close(g_, w_, name)
    scale = max(float(w_.abs().max()) for w_ in want[5])
    for k, (g_, w_) in enumerate(zip(got[5], want[5])):
        _assert_grad_close(g_, w_, f"weight gradient {k}", scale)


def test_grad_free_wrappers_refuse_a_graph_on_card(card):
    model = SMIN(TINY).to(card)                     # parameters require grad
    ins = _stack_inputs(TINY, 2, seed=0, device=card)
    with pytest.raises(RuntimeError, match="no backward kernel"):
        smin_cuda.smin_stack_fused(model, TINY, *ins)
    layers = lstm_layers(model.backbone.queryencoder.lstm)
    with pytest.raises(RuntimeError, match="no backward kernel"):
        lstm_cuda.bilstm_fused(torch.randn(2, 3, 300, device=card),
                               torch.ones(2, 3, device=card), layers)


def _train_batch(cfg, B, seed):
    g = torch.Generator().manual_seed(seed)
    Nq, L = cfg.max_query_length, cfg.L
    N = L * (L + 1) // 2
    qlen = torch.randint(1, Nq + 1, (B,), generator=g)
    nlen = torch.randint(1, L + 1, (B,), generator=g)
    lmask = (torch.arange(L)[None, :] < nlen[:, None]).float()
    sample_mask = torch.ones(B)
    sample_mask[-1] = 0
    return {
        "video_features": torch.randn(B, cfg.T, cfg.input_video_dim, generator=g),
        "video_mask": torch.ones(B, cfg.T, 1),
        "query_features": torch.randn(B, Nq, cfg.word_dim, generator=g),
        "query_mask": (torch.arange(Nq)[None, :] < qlen[:, None]).float()[..., None],
        "length_mask": lmask,
        "sm": torch.rand(B, N, generator=g), "ym": (torch.rand(B, N, generator=g) > 0.7).float(),
        "ss": torch.rand(B, L, generator=g), "ys": (torch.rand(B, L, generator=g) > 0.7).float(),
        "se": torch.rand(B, L, generator=g), "ye": (torch.rand(B, L, generator=g) > 0.7).float(),
        "ya": (torch.rand(B, L, generator=g) > 0.5).float(),
        "sample_mask": sample_mask,
    }


def test_train_steps_on_card_match_cpu(card):
    """Three Adam steps through K1/K2/K3 on the card against the same steps
    through the plain versions on the CPU: the losses within 1e-4 relative
    (fp32 summation order; Adam's normalised update amplifies the noise of
    near-zero gradients from step 2 on)."""
    torch.manual_seed(0)
    ref = SMIN(TINY)
    models = {"cuda": SMIN(TINY), "cpu": ref}
    models["cuda"].load_state_dict(ref.state_dict())
    losses = {}
    for device, model in models.items():
        step = make_train_step(TINY, model, build_optimizer(Config(model=TINY), model),
                               device=device)
        losses[device] = [float(step(_train_batch(TINY, 6, seed=k))["loss"]) for k in range(3)]
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)
    assert smin_train_cuda.smi_layer_backward.launches > 0


@pytest.mark.parametrize("cfg,B", [(TINY, 3), (ODD, 7), (ACTIVITYNET, 2), (TACOS, 2),
                                   (CHARADES, 64)])
def test_proposal_packed_kernels_match_plain(card, cfg, B):
    """K6: its own entry and counters over the pooling and gather kernels."""
    g = torch.Generator().manual_seed(B)
    f = torch.randn(B, cfg.T, cfg.D, generator=g).to(card)
    nlen = torch.randint(1, cfg.L + 1, (B,), generator=g)
    nlen[0] = cfg.L
    lmask = (torch.arange(cfg.L)[None, :] < nlen[:, None]).float().to(card)
    before = (proposal_cuda.proposal_packed_forward.launches,
              proposal_cuda.proposal_packed_backward.launches,
              proposal_cuda.proposal_rows_forward.launches)
    f.requires_grad_(True)
    got = proposal_cuda.proposal_features_packed_fused(f, lmask, cfg.L, cfg.C)
    cots = [torch.randn(o.shape, generator=g).to(card) for o in got]
    df = torch.autograd.grad(got, f, cots)[0]
    want = proposal_cuda.proposal_features_packed(f, lmask, cfg.L, cfg.C)
    df_want = torch.autograd.grad(want, f, cots)[0]
    torch.cuda.synchronize()
    assert (proposal_cuda.proposal_packed_forward.launches,
            proposal_cuda.proposal_packed_backward.launches,
            proposal_cuda.proposal_rows_forward.launches) == (before[0] + 1, before[1] + 1,
                                                              before[2])
    for o, w in zip(got, want):
        torch.testing.assert_close(o, w, rtol=1e-5, atol=1e-5)
    _assert_grad_close(df, df_want, "df")


def _content_inputs(cfg, B, seed, device):
    fc, fm, _, fw, fs, qmask, _, vmask = _layer_inputs(cfg, B, seed, device)
    fbar = torch.sigmoid(fm * fs[:, None, :]) * fm
    return [fc, fbar.contiguous(), fw, fs, qmask, vmask]


@pytest.mark.parametrize("cfg,B", [(TINY, 1), (TINY, 9), (ODD, 7), (ACTIVITYNET, 2),
                                   (TACOS, 2)])
@pytest.mark.parametrize("has_dcu", [True, False])
def test_content_rows_kernels_match_plain(card, cfg, B, has_dcu):
    """K7 forward and backward: cu, convfc, dfc, dfbar, dfw, dfs and the 14
    weight gradients."""
    torch.manual_seed(B)
    block = SMIN(cfg).to(card).smis[1]
    weights = [w.detach() for w in content_train_cuda.content_weights(block)]
    ins = _content_inputs(cfg, B, seed=B, device=card)
    before = (content_train_cuda.content_rows_forward.launches,
              content_train_cuda.content_rows_backward.launches)
    with torch.no_grad():
        got = content_train_cuda.content_rows_forward(weights, *ins)
        want = content_train_cuda.content_rows_plain(weights, *ins)
    for g_, w_, name in zip(got, want, ("cu", "convfc")):
        torch.testing.assert_close(g_, w_, **STACK_TOL, msg=lambda m: f"{name}: {m}")
    gen = torch.Generator().manual_seed(100 + B)
    dcu, dconv = [torch.randn(t.shape, generator=gen).to(card) for t in want]
    if not has_dcu:
        dcu = None
    got = content_train_cuda.content_rows_backward(weights, *ins, dcu, dconv)
    want = content_train_cuda.content_rows_backward_plain(weights, *ins, dcu, dconv)
    torch.cuda.synchronize()
    assert (content_train_cuda.content_rows_forward.launches,
            content_train_cuda.content_rows_backward.launches) == (before[0] + 1, before[1] + 1)
    for g_, w_, name in zip(got[:4], want[:4], ("dfc", "dfbar", "dfw", "dfs")):
        _assert_grad_close(g_, w_, name)
    scale = max(float(w_.abs().max()) for w_ in want[4])
    for k, (g_, w_) in enumerate(zip(got[4], want[4])):
        _assert_grad_close(g_, w_, f"weight gradient {k}", scale)


ROUTED = ModelConfig(T=32, L=32, C=9, D=64, dl=32, num_smi_layers=2, input_video_dim=12,
                     max_query_length=6, lstm_hidden_size=32)


def test_content_route_train_steps_on_card_match_cpu(card):
    """Three Adam steps of a config that takes the content-unit route (K6,
    K7) on the card against the same steps through the plain versions on the
    CPU, as `test_train_steps_on_card_match_cpu` for the whole-layer route."""
    torch.manual_seed(0)
    ref = SMIN(ROUTED)
    models = {"cuda": SMIN(ROUTED), "cpu": ref}
    models["cuda"].load_state_dict(ref.state_dict())
    before = (content_train_cuda.content_rows_backward.launches,
              proposal_cuda.proposal_packed_backward.launches,
              smin_train_cuda.smi_layer_backward.launches)
    losses = {}
    for device, model in models.items():
        step = make_train_step(ROUTED, model, build_optimizer(Config(model=ROUTED), model),
                               device=device)
        losses[device] = [float(step(_train_batch(ROUTED, 4, seed=k))["loss"]) for k in range(3)]
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)
    assert (content_train_cuda.content_rows_backward.launches,
            proposal_cuda.proposal_packed_backward.launches,
            smin_train_cuda.smi_layer_backward.launches) == (before[0] + 6, before[1] + 3,
                                                             before[2])


@pytest.mark.parametrize("B", [1, 8])
def test_serving_kernels_at_the_activitynet_width(card, B):
    """K5 at Nq=20 and K4 at L=64, the shapes of the ActivityNet eval step."""
    cfg = ACTIVITYNET
    torch.manual_seed(B)
    model = SMIN(cfg).to(card).eval()
    layers = lstm_layers(model.backbone.queryencoder.lstm)
    S = cfg.max_query_length
    x = torch.randn(B, S, cfg.word_dim, device=card)
    lengths = torch.randint(1, S + 1, (B,))
    mask = (torch.arange(S)[None, :] < lengths[:, None]).float().to(card)
    ins = _stack_inputs(cfg, B, seed=B, device=card)
    with torch.no_grad():
        torch.testing.assert_close(lstm_cuda.bilstm_fused(x, mask, layers),
                                   lstm_cuda.bilstm_plain(x, mask, layers), **LSTM_TOL)
        got = smin_cuda.smin_stack_fused(model, cfg, *ins)
        want = smin_cuda.smin_stack_plain(model, cfg, *ins)
    torch.cuda.synchronize()
    for g_, w_ in zip(got, want):
        assert bool(torch.isfinite(g_).all())
        torch.testing.assert_close(g_, w_, **STACK_TOL)


# --------------------------------------------------------------------------- #
# The reference-compat modes: K8 (dense proposal), K9 (all layers' forward),
# K10 (the fused content unit of the packed unit loop).
# --------------------------------------------------------------------------- #
def _moment_mask(cfg, B, g):
    """A moment_mask with fractional values, ones below the diagonal (where
    the kernel must still write zeros) and one short video."""
    mm = torch.rand(B, cfg.L, cfg.L, generator=g)
    mm = torch.where(torch.ones(cfg.L, cfg.L).tril(-1).bool(), torch.ones(()), mm)
    mm[0, :, cfg.L // 2:] = 0
    return mm


@pytest.mark.parametrize("cfg,B", [(TINY, 3), (ODD, 7), (CHARADES, 5), (ACTIVITYNET, 2),
                                   (TACOS, 2), (CHARADES, 64)])
def test_proposal_dense_kernels_match_plain(card, cfg, B):
    """K8 forward and backward against the plain dense pooling and autograd
    through it; every output element is written, zeros below the diagonal."""
    g = torch.Generator().manual_seed(B)
    f = torch.randn(B, cfg.T, cfg.D, generator=g).to(card).requires_grad_(True)
    mm = _moment_mask(cfg, B, g).to(card)
    before = (proposal_cuda.proposal_dense_forward.launches,
              proposal_cuda.proposal_dense_backward.launches,
              proposal_cuda.proposal_rows_forward.launches,
              proposal_cuda.proposal_packed_backward.launches)
    got = proposal_cuda.proposal_features_dense_fused(f, mm, cfg.L, cfg.C)
    cots = [torch.randn(o.shape, generator=g).to(card) for o in got]
    df = torch.autograd.grad(got, f, cots)[0]
    want = proposal_cuda.proposal_features(f, mm, cfg.L, cfg.C)
    df_want = torch.autograd.grad(want, f, cots)[0]
    torch.cuda.synchronize()
    assert (proposal_cuda.proposal_dense_forward.launches,
            proposal_cuda.proposal_dense_backward.launches,
            proposal_cuda.proposal_rows_forward.launches,
            proposal_cuda.proposal_packed_backward.launches) == (
                before[0] + 1, before[1] + 1, before[2], before[3])
    below = torch.ones(cfg.L, cfg.L).tril(-1).bool().to(card)
    for o, w in zip(got, want):
        torch.testing.assert_close(o, w, rtol=1e-5, atol=1e-5)
    assert bool((got[0][:, below] == 0).all()) and bool((got[1][:, below] == 0).all())
    _assert_grad_close(df, df_want, "df")



def _proposal_case(cfg, B, dense, seed=0):
    """(mask, f, cotangents) of one layout: a ragged length mask, or the
    fractional moment_mask of `_moment_mask`."""
    g = torch.Generator().manual_seed(seed)
    f = torch.randn(B, cfg.T, cfg.D, generator=g)
    if dense:
        mask = _moment_mask(cfg, B, g)
        lead = (B, cfg.L, cfg.L)
    else:
        nlen = torch.randint(1, cfg.L + 1, (B,), generator=g)
        mask = (torch.arange(cfg.L)[None, :] < nlen[:, None]).float()
        lead = (B, cfg.L * (cfg.L + 1) // 2)
    cots = [torch.randn(lead + (cfg.C, cfg.D), generator=g),
            torch.randn(lead + (cfg.D,), generator=g), torch.randn(B, cfg.L, cfg.D, generator=g)]
    return mask, f, cots


_PROPOSAL_ENTRIES = {
    "K1": (False, proposal_cuda.proposal_rows_forward, proposal_cuda.proposal_rows_backward),
    "K6": (False, proposal_cuda.proposal_packed_forward, proposal_cuda.proposal_packed_backward),
    "K8": (True, proposal_cuda.proposal_dense_forward, proposal_cuda.proposal_dense_backward),
}


@pytest.mark.parametrize("cfg,B", [(CHARADES, 64), (ACTIVITYNET, 8)])
@pytest.mark.parametrize("kernel", list(_PROPOSAL_ENTRIES))
def test_proposal_backward_is_repeatable(card, kernel, cfg, B):
    """Two launches of a backward give the same bits: a fixed partition of
    the moments over warps and sums in one fixed order, no atomics."""
    dense, _, backward = _PROPOSAL_ENTRIES[kernel]
    mask, _, cots = _proposal_case(cfg, B, dense, seed=B)
    mask, cots = mask.to(card), [c.to(card) for c in cots]
    first = backward(mask, cfg.T, cfg.L, cfg.C, *cots)
    second = backward(mask, cfg.T, cfg.L, cfg.C, *cots)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def _nan_blocks(shapes, device):
    """Fill blocks of the caching allocator of these shapes with NaN and
    free them, so that the next allocations of the same sizes get them.
    Returns their addresses."""
    torch.cuda.empty_cache()
    blocks = [torch.full(s, float("nan"), device=device) for s in shapes]
    ptrs = {b.data_ptr() for b in blocks}
    del blocks
    return ptrs


@pytest.mark.parametrize("kernel", list(_PROPOSAL_ENTRIES))
def test_proposal_kernels_write_every_element(card, kernel):
    """Outputs come from torch.empty: a launch onto NaN-filled memory leaves
    no NaN (zeros below the diagonal and for missing clips are written)."""
    cfg, B = CHARADES, 64     # every output over 1 MB: the large pool, exact fits
    dense, forward, backward = _PROPOSAL_ENTRIES[kernel]
    mask, f, cots = _proposal_case(cfg, B, dense)
    mask, f, cots = mask.to(card), f.to(card), [c.to(card) for c in cots]
    torch.cuda.synchronize()
    ptrs = _nan_blocks([tuple(c.shape) for c in cots], card)
    out = forward(f, mask, cfg.L, cfg.C)
    torch.cuda.synchronize()
    assert {o.data_ptr() for o in out} <= ptrs
    assert not any(bool(o.isnan().any()) for o in out)
    del out
    ptrs = _nan_blocks([(B, cfg.T, cfg.D)], card)
    df = backward(mask, cfg.T, cfg.L, cfg.C, *cots)
    torch.cuda.synchronize()
    assert df.data_ptr() in ptrs
    assert not bool(df.isnan().any())


def test_proposal_wrappers_refuse_what_the_kernels_do_not_take(card):
    """The wrapper's shared-memory sizes are the library's, and a T whose
    tile exceeds a block's shared memory raises before any launch."""
    lib = proposal_cuda._library()
    for T, L in ((10, 5), (64, 16), (128, 64), (128, 32), (225, 15), (899, 1), (1792, 16)):
        for backward in (False, True):
            assert lib.vml_proposal_smem_bytes(T, L, int(backward)) == \
                proposal_cuda.proposal_smem_bytes(T, L, backward)
    T, L, C, D, B = 1792, 16, 4, 32, 2
    N = L * (L + 1) // 2
    lmask = torch.ones(B, L, device=card)
    with pytest.raises(ValueError, match="shared memory"):
        proposal_cuda.proposal_rows_backward(
            lmask, T, L, C, torch.zeros(B, N, C, D, device=card),
            torch.zeros(B, N, D, device=card), torch.zeros(B, L, D, device=card))
    proposal_cuda.proposal_rows_forward(torch.zeros(B, 256, D, device=card), lmask, L, C)
    with pytest.raises(ValueError, match="shared memory"):
        proposal_cuda.proposal_rows_forward(torch.zeros(B, 912, D, device=card), lmask, L, C)

@pytest.mark.parametrize("cfg,B", [(TINY, 1), (TINY, 9), (ODD, 7), (CHARADES, 5)])
def test_content_unit_kernels_match_plain(card, cfg, B):
    """K10 forward and backward: cu, dfc, dfm, dfw, dfs and the 12 weight
    gradients, against `content_unit_packed` and autograd through it."""
    torch.manual_seed(B)
    block = SMIN(cfg).to(card).smis[1]
    weights = [w.detach() for w in content_cuda.unit_weights(block.content_unit)]
    fc, fm, _, fw, fs, qmask, _, vmask = _layer_inputs(cfg, B, seed=B, device=card)
    ins = (fc, fm, fw, fs, qmask, vmask)
    before = (content_cuda.content_unit_forward.launches,
              content_cuda.content_unit_backward.launches,
              content_train_cuda.content_rows_forward.launches)
    with torch.no_grad():
        got = content_cuda.content_unit_forward(weights, *ins)
        want = content_cuda.content_unit_plain(weights, *ins)
    torch.testing.assert_close(got, want, **STACK_TOL)
    dcu = torch.randn(fc.shape, generator=torch.Generator().manual_seed(100 + B)).to(card)
    got = content_cuda.content_unit_backward(weights, *ins, dcu)
    want = content_cuda.content_unit_backward_plain(weights, *ins, dcu)
    torch.cuda.synchronize()
    assert (content_cuda.content_unit_forward.launches,
            content_cuda.content_unit_backward.launches,
            content_train_cuda.content_rows_forward.launches) == (before[0] + 1, before[1] + 1,
                                                                  before[2])
    for g_, w_, name in zip(got[:4], want[:4], ("dfc", "dfm", "dfw", "dfs")):
        _assert_grad_close(g_, w_, name)
    scale = max(float(w_.abs().max()) for w_ in want[4])
    for k, (g_, w_) in enumerate(zip(got[4], want[4])):
        _assert_grad_close(g_, w_, f"weight gradient {k}", scale)


@pytest.mark.parametrize("cfg,B", [(TINY, 5), (ODD, 3), (CHARADES, 4)])
def test_stack_forward_kernel_equals_per_layer_kernels(card, cfg, B, monkeypatch):
    """K9 writes bit for bit what one K2 launch per layer writes, carries
    included, and each of its layers is within K2's tolerance of the plain
    layer on that layer's input carry (over three layers the rounding
    compounds past it); the stack under VML_SMIN_TRAIN_FUSED_FWD=1 launches
    K9 once and K2 never, and its gradients (K3 on those carries) are the
    per-layer route's bit for bit."""
    torch.manual_seed(B)
    model = SMIN(cfg).to(card)
    weights = [w.detach() for b in model.smis for w in block_weights(b)]
    fc, fm, fb, fw, fs, qmask, lmask, vmask = _layer_inputs(cfg, B, seed=B, device=card)
    shared = (fw, fs, qmask, lmask, vmask)
    fm_out, fb_out, carries = smin_train_cuda.smi_stack_forward(weights, fc, fm, fb, *shared,
                                                                cfg.L)
    carry = (fc, fm, fb)
    for k in range(cfg.num_smi_layers):
        for a, b in zip(carries[k], carry):
            assert torch.equal(a, b)
        carry = smin_train_cuda.smi_layer_forward(weights[20 * k:20 * (k + 1)], *carry, *shared,
                                                  cfg.L)
    assert torch.equal(fm_out, carry[1]) and torch.equal(fb_out, carry[2])
    outs = [c for c in carries[1:]] + [(None, fm_out, fb_out)]
    for k in range(cfg.num_smi_layers):
        want = smin_train_cuda.smi_layer_plain(weights[20 * k:20 * (k + 1)], *carries[k],
                                               *shared, cfg.L)
        for g_, w_ in zip(outs[k], want):
            if g_ is not None:
                torch.testing.assert_close(g_, w_, **STACK_TOL)

    grads = {}
    for flag in ("0", "1"):
        monkeypatch.setenv("VML_SMIN_TRAIN_FUSED_FWD", flag)
        leaves = [t.clone().requires_grad_(True) for t in (fc, fm, fb, fw, fs)]
        model.zero_grad(set_to_none=True)
        before = (smin_train_cuda.smi_stack_forward.launches,
                  smin_train_cuda.smi_layer_forward.launches)
        out = smin_train_cuda.smi_stack_layers(model.smis, *leaves, qmask, lmask, vmask, cfg.L)
        ((out[0] * vmask[..., None]).sum() + (out[1] * lmask[..., None]).sum()).backward()
        torch.cuda.synchronize()
        launched = (smin_train_cuda.smi_stack_forward.launches - before[0],
                    smin_train_cuda.smi_layer_forward.launches - before[1])
        assert launched == ((1, 0) if flag == "1" else (0, cfg.num_smi_layers))
        grads[flag] = [t.grad for t in leaves] + [p.grad for p in model.smis.parameters()]
    for a, b in zip(grads["0"], grads["1"]):
        assert torch.equal(a, b)


def _dense_train_batch(cfg, B, seed):
    """`_train_batch` with its IoU map and labels dense (B, L, L) beside the
    moment_mask, as the dense layout and compat_head read them."""
    batch = _train_batch(cfg, B, seed)
    for k in ("sm", "ym"):
        batch[k] = unpack_map(batch[k], cfg.L)
    batch["moment_mask"] = unpack_map(packed_valid_mask(batch["length_mask"]), cfg.L)
    return batch


def _counters():
    return {"K1f": proposal_cuda.proposal_rows_forward, "K1b": proposal_cuda.proposal_rows_backward,
            "K2": smin_train_cuda.smi_layer_forward, "K3": smin_train_cuda.smi_layer_backward,
            "K6f": proposal_cuda.proposal_packed_forward,
            "K6b": proposal_cuda.proposal_packed_backward,
            "K7f": content_train_cuda.content_rows_forward,
            "K7b": content_train_cuda.content_rows_backward,
            "K8f": proposal_cuda.proposal_dense_forward,
            "K8b": proposal_cuda.proposal_dense_backward,
            "K9": smin_train_cuda.smi_stack_forward,
            "K10f": content_cuda.content_unit_forward,
            "K10b": content_cuda.content_unit_backward}


@pytest.mark.parametrize("mode", ["dense", "compat", "fused_fwd"])
def test_mode_train_steps_on_card_match_cpu(card, mode, monkeypatch):
    """Three Adam steps in each reference-compat mode on the card against the
    same steps through the plain versions on the CPU, and the kernels each
    mode launches per step (and no other)."""
    n = TINY.num_smi_layers
    cfg, batch, per_step = {
        "dense": (dataclasses.replace(TINY, packed=False), _dense_train_batch,
                  {"K8f": 1, "K8b": 1}),
        "compat": (dataclasses.replace(TINY, compat_head=True, fused_content=True),
                   _dense_train_batch, {"K6f": 1, "K6b": 1, "K10f": n, "K10b": n}),
        "fused_fwd": (TINY, _train_batch, {"K1f": 1, "K1b": 1, "K9": 1, "K3": n}),
    }[mode]
    if mode == "fused_fwd":
        monkeypatch.setenv("VML_SMIN_TRAIN_FUSED_FWD", "1")
    torch.manual_seed(0)
    ref = SMIN(cfg)
    models = {"cuda": SMIN(cfg), "cpu": ref}
    models["cuda"].load_state_dict(ref.state_dict())
    counters = _counters()
    before = {k: fn.launches for k, fn in counters.items()}
    losses = {}
    for device, model in models.items():
        step = make_train_step(cfg, model, build_optimizer(Config(model=cfg), model),
                               device=device)
        losses[device] = [float(step(batch(cfg, 4, seed=k))["loss"]) for k in range(3)]
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)
    launched = {k: fn.launches - before[k] for k, fn in counters.items()}
    assert launched == {k: 3 * per_step.get(k, 0) for k in counters}


@pytest.mark.parametrize("mode", ["compat", "dense"])
def test_mode_localizer_on_card_matches_cpu(card, mode):
    change = {"compat_head": True} if mode == "compat" else {"packed": False}
    cfg = dataclasses.replace(TINY, **change)
    torch.manual_seed(0)
    model = SMIN(cfg)
    emb = WordEmbedding.synthetic(["person", "opens", "the", "door", "sits"], dim=300)
    gpu = MomentLocalizer(cfg, SMIN(cfg), emb, serve_batch=8)
    gpu.model.load_state_dict(model.state_dict())
    cpu = MomentLocalizer(cfg, model, emb, serve_batch=8, device="cpu")
    rng = np.random.default_rng(1)
    vids = [rng.standard_normal((int(n), 12)).astype(np.float32) for n in (5, 16, 40)]
    reqs = [(vids[k % 3], ["person opens the door", "the xylophone sits"][k % 2], 9.0)
            for k in range(11)]
    for g, c in zip(gpu.localize_batch(reqs, top_k=5), cpu.localize_batch(reqs, top_k=5)):
        assert [(m.start, m.end) for m in g] == [(m.start, m.end) for m in c]
        np.testing.assert_allclose([m.score for m in g], [m.score for m in c], atol=1e-5)

"""Card tests of the port's kernels: each CUDA kernel against its plain
PyTorch version on the same card, and the serving path on the card against
the same localizer on the CPU. They skip where there is no CUDA device.

The file imports neither JAX nor the JAX package, so the card machine runs it
without them:

    python -m pytest -q --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from video_moment_localization_tpu_torch.config import ModelConfig
from video_moment_localization_tpu_torch.data.glove import WordEmbedding
from video_moment_localization_tpu_torch.inference import MomentLocalizer
from video_moment_localization_tpu_torch.models.lstm import BiLSTMParams, lstm_layers
from video_moment_localization_tpu_torch.models.smin import SMIN
from video_moment_localization_tpu_torch.ops import lstm_cuda, smin_cuda
from video_moment_localization_tpu_torch.ops.packing import packed_valid_mask

pytestmark = pytest.mark.cuda

LSTM_TOL = dict(rtol=2e-5, atol=2e-5)
STACK_TOL = dict(rtol=2e-4, atol=2e-5)
CHARADES = ModelConfig()
TINY = ModelConfig(T=16, L=8, C=4, D=64, dl=32, num_smi_layers=3, input_video_dim=12,
                   max_query_length=6, lstm_hidden_size=32)


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

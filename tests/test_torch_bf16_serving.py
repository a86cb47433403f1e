"""bf16 serving of the port against the JAX package on the CPU, at a narrow
config, with weights carried over by models/port.py:

* K4's plain version at bf16 (`smin_stack_fused` on CPU tensors) against the
  JAX serving kernel at bf16 in interpret mode, by the criterion of
  tests/test_smin_pallas.py::test_fused_stack_bf16_close: per output, mean
  |diff| < 0.01, 98th percentile < 0.05, max < 0.3;
* K5's plain version at bf16 (`bilstm_fused` on CPU tensors) against the JAX
  fused biLSTM at bf16 in interpret mode and its XLA scan, rtol = atol =
  0.05 (tests/test_lstm_pallas.py::test_bf16_parity);
* the whole default-route forward at bf16 against JAX `smin_forward` at bf16,
  atol 2e-2 (tests/test_dtype_remat.py), with the fused and the plain
  biLSTM;
* `MomentLocalizer` at bf16 against the fp32 one, its top-k scores by the K4
  criterion;
* a control on those criteria, which a plain version that ran in fp32 would
  meet too: K4's and K5's plain bf16 versions part from their fp32 versions
  by far more than fp32 rounding and lie closer to the JAX kernels at bf16
  than at fp32;
* the pieces K4 and K5's bf16 variants are made of: the bf16 GEMM's and the
  content-attention pair's plain versions, the bf16 plans of the GEMM, the
  pair and K5's recurrence, and the weights' one cast per model.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_moment_localization_tpu.config import ModelConfig as JaxModelConfig
from video_moment_localization_tpu.models import init_smin_params
from video_moment_localization_tpu.models import smin_forward as jax_smin_forward
from video_moment_localization_tpu.models.lstm import bilstm as jax_bilstm
from video_moment_localization_tpu.ops.lstm_pallas import bilstm_fused as jax_bilstm_fused
from video_moment_localization_tpu.ops.packing import packed_valid_mask as jax_valid_mask
from video_moment_localization_tpu.ops.smin_pallas import smin_stack_fused as jax_stack
from video_moment_localization_tpu_torch.config import ModelConfig
from video_moment_localization_tpu_torch.data.glove import WordEmbedding
from video_moment_localization_tpu_torch.inference import MomentLocalizer
from video_moment_localization_tpu_torch.models.lstm import lstm_layers
from video_moment_localization_tpu_torch.models.port import state_dict_from_jax_params
from video_moment_localization_tpu_torch.models.smin import (
    SMIN,
    cast_weights,
    smin_forward_inference,
)
from video_moment_localization_tpu_torch.ops import (
    content_attn_cuda,
    gemm_cuda,
    lstm_cuda,
    smin_cuda,
)
from video_moment_localization_tpu_torch.ops.packing import packed_valid_mask

SHAPE = dict(T=16, L=8, C=4, D=64, dl=16, num_smi_layers=2, input_video_dim=12,
             max_query_length=6, lstm_hidden_size=32)
JCFG = JaxModelConfig(**SHAPE, compute_dtype="bfloat16")
CFG = ModelConfig(**SHAPE, compute_dtype="bfloat16")
BF = jnp.bfloat16


def k4_criterion(got, want, name):
    """tests/test_smin_pallas.py::test_fused_stack_bf16_close's bounds."""
    diff = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    assert np.mean(diff) < 0.01, (name, np.mean(diff))
    assert np.quantile(diff, 0.98) < 0.05, (name, np.quantile(diff, 0.98))
    assert diff.max() < 0.3, (name, diff.max())


@pytest.fixture(scope="module")
def shared():
    jparams = init_smin_params(jax.random.PRNGKey(7), JaxModelConfig(**SHAPE))
    model = SMIN(CFG)
    model.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, jparams)),
                          strict=True)
    return jparams, model.eval()


def _masks(B, rng):
    qm = np.ones((B, SHAPE["max_query_length"], 1), np.float32)
    lm = np.ones((B, SHAPE["L"]), np.float32)
    for b in range(B):
        qm[b, int(rng.integers(1, SHAPE["max_query_length"] + 1)):] = 0
        lm[b, int(rng.integers(1, SHAPE["L"] + 1)):] = 0
    return qm, lm


@pytest.mark.parametrize("B,seed", [(2, 0), (4, 1)])
def test_k4_plain_bf16_matches_jax_kernel(shared, B, seed):
    jparams, model = shared
    rng = np.random.default_rng(seed)
    D, T, Nq = SHAPE["D"], SHAPE["T"], SHAPE["max_query_length"]
    f = (rng.standard_normal((B, T, D)) * 0.5).astype(np.float32)
    fw = (rng.standard_normal((B, Nq, D)) * 0.5).astype(np.float32)
    fs = (rng.standard_normal((B, D)) * 0.5).astype(np.float32)
    qm, lm = _masks(B, rng)
    want = jax_stack(jparams, JCFG, jnp.asarray(f).astype(BF), jnp.asarray(fw).astype(BF),
                     jnp.asarray(fs).astype(BF), qm, lm, jax_valid_mask(jnp.asarray(lm)),
                     interpret=True)
    bf = lambda a: torch.from_numpy(a).bfloat16()   # noqa: E731
    with torch.no_grad():
        got = smin_cuda.smin_stack_fused(model, CFG, bf(f), bf(fw), bf(fs),
                                         torch.from_numpy(qm), torch.from_numpy(lm),
                                         packed_valid_mask(torch.from_numpy(lm)))
    for g, w, name in zip(got, want, ("pm", "ps", "pe", "pa")):
        assert g.dtype == torch.float32 and tuple(g.shape) == tuple(w.shape)
        k4_criterion(g.numpy(), w, name)


@pytest.mark.parametrize("B,seed", [(3, 0), (8, 2)])
def test_k5_plain_bf16_matches_jax(shared, B, seed):
    jparams, model = shared
    rng = np.random.default_rng(seed)
    Nq = SHAPE["max_query_length"]
    x = (rng.standard_normal((B, Nq, 300)) * 0.5).astype(np.float32)
    qm, _ = _masks(B, rng)
    mask = qm[..., 0]
    layers_j = jparams["query_encoder"]
    xj = jnp.asarray(x).astype(BF)
    fused = np.asarray(jax_bilstm_fused(xj, jnp.asarray(mask), layers_j, interpret=True),
                       np.float32)
    scan = np.asarray(jax_bilstm(xj, jnp.asarray(mask).astype(BF), layers_j), np.float32)
    lstm = model.backbone.queryencoder.lstm
    with torch.no_grad():
        got = lstm_cuda.bilstm_fused(torch.from_numpy(x).bfloat16(), torch.from_numpy(mask),
                                     lstm_layers(lstm, cast_weights(lstm, torch.bfloat16)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), fused, rtol=0.05, atol=0.05)
    np.testing.assert_allclose(got.float().numpy(), scan, rtol=0.05, atol=0.05)
    assert np.all(got.float().numpy()[mask == 0] == 0)


def _mean_gap(a, b):
    return float(np.mean(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))))


def _parts_beyond_fp32(a, b):
    """Whether a and b part by more than 2^-16 of their largest magnitude:
    256 units of fp32 rounding, 1/256 of one bf16 rounding."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max()) > 2.0 ** -16 * float(b.abs().max())


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_plain_versions_round_in_bf16(shared, seed):
    jparams, model = shared
    rng = np.random.default_rng(seed)
    B, D, T, Nq = 4, SHAPE["D"], SHAPE["T"], SHAPE["max_query_length"]
    bf = lambda a: torch.from_numpy(a).bfloat16()   # noqa: E731
    # Inputs that bf16 holds exactly, so that only the arithmetic differs.
    f, fw, fs = (bf((rng.standard_normal(s) * 0.5).astype(np.float32)).float().numpy()
                 for s in ((B, T, D), (B, Nq, D), (B, D)))
    qm, lm = _masks(B, rng)
    masks = (torch.from_numpy(qm), torch.from_numpy(lm), packed_valid_mask(torch.from_numpy(lm)))
    cfg32 = dataclasses.replace(CFG, compute_dtype="float32")
    with torch.no_grad():
        port16 = smin_cuda.smin_stack_fused(model, CFG, bf(f), bf(fw), bf(fs), *masks)
        port32 = smin_cuda.smin_stack_fused(model, cfg32, *(torch.from_numpy(a)
                                                            for a in (f, fw, fs)), *masks)
    jmask = (qm, lm, jax_valid_mask(jnp.asarray(lm)))
    jax16 = jax_stack(jparams, JCFG, *(jnp.asarray(a).astype(BF) for a in (f, fw, fs)), *jmask,
                      interpret=True)
    jax32 = jax_stack(jparams, dataclasses.replace(JCFG, compute_dtype="float32"),
                      *(jnp.asarray(a) for a in (f, fw, fs)), *jmask, interpret=True)
    assert all(_parts_beyond_fp32(p16, p32) for p16, p32 in zip(port16, port32))
    gaps = [(_mean_gap(p16, j16), _mean_gap(p16, j32))
            for p16, j16, j32 in zip(port16, jax16, jax32)]
    assert sum(g[0] for g in gaps) < sum(g[1] for g in gaps), gaps

    x = bf((rng.standard_normal((B, Nq, 300)) * 0.5).astype(np.float32))
    mask = qm[..., 0]
    lstm = model.backbone.queryencoder.lstm
    with torch.no_grad():
        k5_16 = lstm_cuda.bilstm_fused(x, torch.from_numpy(mask),
                                       lstm_layers(lstm, cast_weights(lstm, torch.bfloat16)))
        k5_32 = lstm_cuda.bilstm_fused(x.float(), torch.from_numpy(mask), lstm_layers(lstm))
    layers_j = jparams["query_encoder"]
    xj = jnp.asarray(x.float().numpy())
    j16 = jax_bilstm_fused(xj.astype(BF), jnp.asarray(mask), layers_j, interpret=True)
    j32 = jax_bilstm_fused(xj, jnp.asarray(mask), layers_j, interpret=True)
    assert _parts_beyond_fp32(k5_16, k5_32)
    gaps = _mean_gap(k5_16.float(), j16), _mean_gap(k5_16.float(), j32)
    assert gaps[0] < gaps[1], gaps


def _forward_inputs(B=4, seed=3):
    rng = np.random.default_rng(seed)
    vf = rng.standard_normal((B, SHAPE["T"], SHAPE["input_video_dim"])).astype(np.float32)
    vm = np.ones((B, SHAPE["T"], 1), np.float32)
    vm[1, 10:] = 0
    vm[2, 4:] = 0
    qf = (rng.standard_normal((B, SHAPE["max_query_length"], 300)) * 0.3).astype(np.float32)
    qm, lm = _masks(B, rng)
    return vf, vm, qf, qm, lm


@pytest.mark.parametrize("fused_lstm", [True, False])
def test_default_route_bf16_matches_jax_forward(shared, fused_lstm):
    jparams, model = shared
    args = _forward_inputs()
    want = jax_smin_forward(jparams, dataclasses.replace(JCFG, fused_lstm=fused_lstm),
                            *args, None)
    cfg = dataclasses.replace(CFG, fused_lstm=fused_lstm)
    got = smin_forward_inference(model, cfg, *(torch.from_numpy(a) for a in args))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-2)


def test_localizer_bf16_close_to_fp32(shared):
    _, model = shared
    words = ["person", "opens", "the", "door", "sits", "down"]
    emb = WordEmbedding.synthetic(words, dim=300, seed=1)
    rng = np.random.default_rng(5)
    reqs = [(rng.standard_normal((int(n), SHAPE["input_video_dim"])).astype(np.float32),
             "person opens the door" if k % 2 else "person sits down", 10.0 + k)
            for k, n in enumerate((5, 16, 40, 9, 23, 31))]
    fp32 = MomentLocalizer(dataclasses.replace(CFG, compute_dtype="float32"), model, emb,
                           serve_batch=4, device="cpu")
    bf16 = MomentLocalizer(CFG, model, emb, serve_batch=4, device="cpu")
    got, want = bf16.localize_batch(reqs, top_k=5), fp32.localize_batch(reqs, top_k=5)
    assert len(got) == len(reqs) and all(len(m) == 5 for m in got)
    k4_criterion([[m.score for m in r] for r in got], [[m.score for m in r] for r in want],
                 "top-5 scores")


def test_gemm_bf16_plain_is_bf16_products_in_fp32():
    rng = np.random.default_rng(0)
    A = torch.from_numpy(rng.standard_normal((37, 24)).astype(np.float32)).bfloat16()
    W = torch.from_numpy(rng.standard_normal((19, 24)).astype(np.float32)).bfloat16()
    bias = torch.from_numpy(rng.standard_normal(19).astype(np.float32))
    rmask = torch.from_numpy((rng.random(37) > 0.3).astype(np.float32))
    post = torch.from_numpy(rng.standard_normal((37, 19)).astype(np.float32)).bfloat16()
    out = gemm_cuda.gemm_bf16(A, W, bias=bias, rmask=rmask, post=post, out_dtype=torch.float32)
    want = ((A.double() @ W.double().t() + bias.double()) * rmask.double()[:, None]
            + post.double())
    torch.testing.assert_close(out.double(), want, rtol=1e-6, atol=1e-5)
    assert gemm_cuda.gemm_bf16(A, W).dtype == torch.bfloat16


def test_content_attn_plain_bf16_is_the_fp32_pair_rounded():
    rng = np.random.default_rng(1)
    B, N, C, Nq, dl = 2, 10, 4, 5, 16
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))   # noqa: E731
    h, q, khat, fwh = (x.bfloat16() for x in (t(B, N, C, dl), t(B, N, C, dl), t(B, Nq, dl),
                                               t(B, Nq, dl)))
    fsh = t(B, dl)
    qm = torch.ones(B, Nq, 1)
    qm[1, 3:] = 0
    vm = torch.ones(B, N)
    vm[0, 7:] = 0
    got = content_attn_cuda.content_attn_forward(h, q, khat, fwh, fsh, qm, vm)
    want = content_attn_cuda.content_attn_plain(h.float(), q.float(), khat.float(), fwh.float(),
                                                fsh, qm, vm)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.bfloat16())


@pytest.mark.parametrize("B", [1, 16, 64, 512])
def test_bf16_plans(B):
    """The bf16 plans of the mirrors: every bf16 product of K4, K5, K2, K3,
    K7, K9 and K10 takes the wgmma kernel (one block an SM) where TMA can
    read its operands and the mma.sync kernel with the fp32 tile rule
    (gemm_tn: 128x128, two blocks an SM) where it cannot, in all three
    layouts; K5's rows per cluster at bf16 fit a block and its clusters of 4
    CTAs one wave (the pair's plans are those of fp32 rows: it stages bf16
    rows in fp32)."""
    charades = ModelConfig()
    layouts = set()
    for kernel, name, layout, M, N, K, groups in gemm_cuda.model_gemm_shapes_bf16(charades, B):
        tile = 0 if layout == "tn" else gemm_cuda.tile_for(M, N, groups)
        p = gemm_cuda.plan(layout, M, N, K, groups, name, dtype=torch.bfloat16)
        assert p["path"] == gemm_cuda.BF16_WG and p["tile"] == tile
        assert p["smem"] + 1024 <= 228 * 1024
        p = gemm_cuda.plan(layout, M, N, K, groups, name, dtype=torch.bfloat16, tma_ok=False)
        assert p["path"] == gemm_cuda.BF16 and p["tile"] == tile
        assert 2 * (p["smem"] + 1024) <= 228 * 1024
        layouts.add(layout)
    assert layouts == {"nt", "nn", "tn"}
    with pytest.raises(ValueError, match="unknown layout"):
        gemm_cuda.path_for("tt", 64, 64, 64, dtype=torch.bfloat16)
    # K5-bf16: clusters of 4 CTAs, each with 4H/4 rows of W_hh and two
    # copies of h, rows of H + 8 bf16 (tests/test_torch_lstm_mma.py).
    for rows in lstm_cuda.row_choices(256, itemsize=2):
        assert lstm_cuda.lstm_smem_bytes(256, rows, 2) <= lstm_cuda.MAX_SMEM_BYTES
    assert lstm_cuda.lstm_smem_bytes(256, 16, 2) == 2 * (256 + 8) * (256 + 2 * 16)
    rows, clusters = lstm_cuda.lstm_plan(B, 256, lambda r: 33, itemsize=2)
    assert clusters == 2 * -(-B // rows) <= 33


def test_cast_weights_once_per_model(shared):
    _, model = shared
    block = model.smis[0]
    first = cast_weights(block, torch.bfloat16)
    assert cast_weights(block, torch.bfloat16) is first
    w = first["content_unit.linear_c_hat.weight"]
    assert w.dtype == torch.bfloat16
    assert first["content_unit.linear_c_hat.bias"].dtype == torch.float32
    layer = block.content_unit.linear_c_hat
    with torch.no_grad():
        layer.weight.mul_(1.0)           # an optimizer step bumps the version counter
    again = cast_weights(block, torch.bfloat16)
    assert again is not first and torch.equal(again["content_unit.linear_c_hat.weight"], w)

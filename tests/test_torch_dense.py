"""The dense layout of the port (``packed: False``) against the JAX package,
from shared weights and numpy inputs on the CPU:

* K8's function: `proposal_features_dense_fused` (its plain version and the
  plain backward) vs `proposal_features_pallas(..., interpret=True)` through
  its custom VJP and vs `jax.vjp` of the XLA `proposal_features`, at
  tests/test_pallas.py's tolerances (forward rtol / atol 2e-5, gradient
  1e-4), on a moment_mask with fractional values and ones below the diagonal;
* the dense SMI block, heads and `smin_forward` / `smin_forward_inference`
  vs the JAX units with ``packed=False``, at tests/test_model.py's rtol 1e-4
  / atol 1e-5;
* the dense loss, recall counts (ties to the lower flat index, masked slots
  included, PARITY.md #16) and soft-NMS, exactly or at fp32 rounding;
* the loss and every gradient, three Adam steps and an eval step vs
  jax.value_and_grad / the JAX steps; the dense step-1 loss equal to the
  packed one (JAX tests/test_packed.py); ``remat_smi`` gradients equal to
  the plain ones; and the config checks, which take fp32 and bf16 in every
  mode and refuse any other compute_dtype.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_moment_localization_tpu.models import smin as jsmin
from video_moment_localization_tpu.ops.nms import soft_nms_topk as j_soft_nms
from video_moment_localization_tpu.ops.proposal import proposal_features as j_proposal
from video_moment_localization_tpu.ops.proposal_pallas import proposal_features_pallas
from video_moment_localization_tpu.train import metrics as jmetrics
from video_moment_localization_tpu.train.loss import smin_loss as j_smin_loss
from video_moment_localization_tpu_torch.config import Config, ModelConfig
from video_moment_localization_tpu_torch.models import smin
from video_moment_localization_tpu_torch.ops import proposal_cuda
from video_moment_localization_tpu_torch.ops.nms import soft_nms_topk
from video_moment_localization_tpu_torch.parallel.steps import build_optimizer, make_train_step
from video_moment_localization_tpu_torch.train import metrics as tmetrics
from video_moment_localization_tpu_torch.train.loss import smin_loss

from _torch_train_common import (
    CFG,
    FORWARD_KEYS,
    SHAPE,
    assert_loss_and_gradients_match_jax,
    assert_steps_match_jax,
    make_batch,
    make_model,
    mode_configs,
    to_torch,
)

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
PROPOSAL_GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
MODEL_TOL = dict(rtol=1e-4, atol=1e-5)
JCFG_D, CFG_D = mode_configs("dense")
# Two frames per snippet and clips of one frame (as ActivityNet's map), and C=3.
GEOMETRIES = [dict(T=16, L=8, C=4, D=32), dict(T=16, L=8, C=3, D=16)]


def _proposal_inputs(geo, B, seed):
    """f, a moment_mask with fractional values, ones below the diagonal and
    one short video, and cotangents of (fc, fm, fb)."""
    rng = np.random.default_rng(seed)
    L, C, D = geo["L"], geo["C"], geo["D"]
    f = rng.standard_normal((B, geo["T"], D)).astype(np.float32)
    mm = rng.uniform(0.0, 1.0, (B, L, L)).astype(np.float32)
    mm[:, np.tril_indices(L, -1)[0], np.tril_indices(L, -1)[1]] = 1.0
    mm[0, :, L // 2:] = 0.0
    mm[0, L // 2:, :] = 0.0
    cots = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, L, L, C, D), (B, L, L, D), (B, L, D))]
    return f, mm, cots


@pytest.mark.parametrize("reference", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("geo", GEOMETRIES, ids=lambda g: f"T{g['T']}L{g['L']}C{g['C']}")
def test_k8_forward_and_grad_match_jax(geo, reference):
    B, L, C = 3, geo["L"], geo["C"]
    f, mm, cots = _proposal_inputs(geo, B, seed=L + C)

    def jfn(f_):
        if reference == "xla":
            return j_proposal(f_, jnp.asarray(mm), L, C)
        return proposal_features_pallas(f_, jnp.asarray(mm), L, C, True)

    want, vjp = jax.vjp(jfn, jnp.asarray(f))
    dwant = vjp(tuple(jnp.asarray(c) for c in cots))[0]

    before = (proposal_cuda.proposal_dense_forward.launches,
              proposal_cuda.proposal_dense_backward.launches)
    ft = torch.from_numpy(f).requires_grad_(True)
    got = proposal_cuda.proposal_features_dense_fused(ft, torch.from_numpy(mm), L, C)
    df = torch.autograd.grad(got, ft, [torch.from_numpy(c) for c in cots])[0]
    assert (proposal_cuda.proposal_dense_forward.launches,
            proposal_cuda.proposal_dense_backward.launches) == before   # CPU: plain versions

    assert tuple(got[0].shape) == (B, L, L, C, geo["D"])
    for g, w, name in zip(got, want, ("fc", "fm", "fb")):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **FWD_TOL, err_msg=name)
    np.testing.assert_allclose(df.numpy(), np.asarray(dwant), **PROPOSAL_GRAD_TOL)
    # Below the diagonal every cell is 0 although the mask holds 1 there.
    below = torch.ones(L, L).tril(-1).bool()
    assert (got[0][:, below] == 0).all() and (got[1][:, below] == 0).all()
    assert (got[0][0, L // 2:] == 0).all()


def test_k8_wrappers_reject_other_devices_and_count_apart():
    with pytest.raises(ValueError, match="CPU or CUDA"):
        proposal_cuda.proposal_dense_forward(torch.zeros(2, 16, 8, device="meta"),
                                             torch.ones(2, 8, 8, device="meta"), 8, 4)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        proposal_cuda.proposal_dense_backward(
            torch.ones(2, 8, 8, device="meta"), 16, 8, 4,
            torch.zeros(2, 8, 8, 4, 8, device="meta"), torch.zeros(2, 8, 8, 8, device="meta"),
            torch.zeros(2, 8, 8, device="meta"))
    assert proposal_cuda.proposal_dense_forward is not proposal_cuda.proposal_rows_forward
    # The plain backward takes either layout by the mask's rank.
    geo = GEOMETRIES[0]
    f, mm, cots = _proposal_inputs(geo, 2, seed=0)
    df = proposal_cuda.proposal_dense_backward(torch.from_numpy(mm), geo["T"], geo["L"],
                                               geo["C"], *map(torch.from_numpy, cots))
    ft = torch.from_numpy(f).requires_grad_(True)
    out = proposal_cuda.proposal_features_dense_fused(ft, torch.from_numpy(mm), geo["L"],
                                                      geo["C"])
    want = torch.autograd.grad(out, ft, [torch.from_numpy(c) for c in cots])[0]
    torch.testing.assert_close(df, want, rtol=0, atol=0)


def _dense_block_inputs(B=3, seed=0):
    """Dense layer inputs as numpy, from the JAX XLA proposal."""
    rng = np.random.default_rng(seed)
    Nq, L = CFG.max_query_length, CFG.L
    f = rng.standard_normal((B, CFG.T, CFG.D)).astype(np.float32)
    fw = rng.standard_normal((B, Nq, CFG.D)).astype(np.float32)
    fs = rng.standard_normal((B, CFG.D)).astype(np.float32)
    qmask = np.ones((B, Nq, 1), np.float32)
    qmask[0, 2:] = 0
    qmask[2, 1:] = 0
    lmask = np.ones((B, L), np.float32)
    lmask[1, L // 2:] = 0
    mm = np.triu(lmask[:, :, None] * lmask[:, None, :]).astype(np.float32)
    fw = fw * qmask
    fc, fm, fb = (np.asarray(a) for a in j_proposal(jnp.asarray(f), jnp.asarray(mm), L, CFG.C))
    return dict(fc=fc, fm=fm, fb=fb, fw=fw, fs=fs, qmask=qmask, lmask=lmask, mm=mm)


@pytest.mark.parametrize("layer", [0, 1])
def test_dense_block_and_heads_match_jax(layer):
    params, model = make_model(3)
    ins = _dense_block_inputs(seed=layer)
    args = [ins[k] for k in ("fc", "fm", "fb", "fw", "fs", "qmask", "lmask", "mm")]
    want = jax.jit(jsmin.smi_block)(params["smi"][layer], *map(jnp.asarray, args))
    t = [torch.from_numpy(np.array(a)) for a in args]
    with torch.no_grad():
        got = smin.smi_block(model.smis[layer], *t)
        heads = smin.localization(model.localization, got[1], got[2], t[6], t[7])
    for g, w, name in zip(got, want, ("cu", "mu", "bu")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **MODEL_TOL, err_msg=name)
    jheads = jax.jit(jsmin.localization)(params["localization"], want[1], want[2], args[6],
                                         args[7])
    for g, w in zip(heads, jheads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **MODEL_TOL)
    assert tuple(heads[0].shape) == (3, CFG.L, CFG.L)


@pytest.mark.parametrize("inference", [False, True])
def test_dense_forward_matches_jax(inference):
    params, model = make_model(4, dict(SHAPE, packed=False))
    batch = make_batch(B=4, seed=2, packed_labels=False)
    want = jax.jit(lambda p, *a: jsmin.smin_forward(p, JCFG_D, *a))(
        params, *(jnp.asarray(batch[k]) for k in FORWARD_KEYS))
    tb = to_torch(batch)
    run = smin.smin_forward_inference if inference else smin.smin_forward
    with torch.no_grad():
        got = run(model, CFG_D, *(tb[k] for k in FORWARD_KEYS))
    assert tuple(got[0].shape) == (4, CFG.L, CFG.L)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **MODEL_TOL)


def _dense_outputs(B=4, seed=0):
    rng = np.random.default_rng(seed)
    batch = make_batch(B=B, seed=seed, packed_labels=False)
    L = CFG.L
    pm = (rng.uniform(0.01, 0.99, (B, L, L)) * batch["moment_mask"]).astype(np.float32)
    ps, pe, pa = (rng.uniform(0.01, 0.99, (B, L)).astype(np.float32) * batch["length_mask"]
                  for _ in range(3))
    return (pm, ps, pe, pa), batch


@pytest.mark.parametrize("with_sample_mask", [True, False])
def test_dense_loss_matches_jax(with_sample_mask):
    outputs, batch = _dense_outputs(seed=3)
    if not with_sample_mask:
        del batch["sample_mask"]
    want = j_smin_loss(tuple(map(jnp.asarray, outputs)),
                       {k: jnp.asarray(v) for k, v in batch.items()})[0]
    t = [torch.from_numpy(o).requires_grad_(True) for o in outputs]
    got = smin_loss(tuple(t), to_torch(batch))[0]
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    got.backward()
    assert all(torch.isfinite(x.grad).all() for x in t)


@pytest.mark.parametrize("use_nms", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_dense_recall_counts_equal_jax(use_nms, seed):
    (pm, ps, pe, _), batch = _dense_outputs(seed=seed)
    args = (pm, ps, pe, batch["moment_mask"], batch["sm"], batch["sample_mask"])
    want = jmetrics.recall_counts(*map(jnp.asarray, args), use_nms=use_nms)
    got = tmetrics.recall_counts(*map(torch.from_numpy, args), use_nms=use_nms)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dense_recall_ties_pick_masked_slots_as_the_reference():
    """A sample with one scored moment: the other four of the top-5 are
    zero-score ties taken in flat-index order, masked cells included, whose
    dense sm entries are real IoUs (PARITY.md #16): R@5 counts a hit there
    that the packed ranking would not."""
    L, B = 4, 2
    mm = np.zeros((B, L, L), np.float32)
    mm[:, 2, 3] = 1.0
    pm = mm * 0.8
    ps = pe = np.ones((B, L), np.float32)
    sm = np.zeros((B, L, L), np.float32)
    sm[0, 0, 1] = 0.9            # flat index 1: masked, a real IoU
    sm[1, 3, 3] = 0.9            # flat index 15: outside the top-5
    args = (pm, ps, pe, mm, sm, np.ones(B, np.float32))
    want = np.asarray(jmetrics.recall_counts(*map(jnp.asarray, args)))
    got = tmetrics.recall_counts(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[1].tolist() == [1.0, 1.0, 1.0, 1.0] and got[0].tolist() == [0.0] * 4


@pytest.mark.parametrize("k", [1, 5, 12])
def test_dense_soft_nms_matches_jax(k):
    rng = np.random.default_rng(k)
    L = 6
    scores = (rng.uniform(0, 1, (3, L * L)) * np.triu(np.ones((L, L))).reshape(-1)
              ).astype(np.float32)
    scores[1, ::2] = 0.25                       # ties
    wv, wi = j_soft_nms(jnp.asarray(scores), L, k, 0.5, packed=False)
    gv, gi = soft_nms_topk(torch.from_numpy(scores), L, k, 0.5, packed=False)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("seed", [0, 1])
def test_dense_loss_and_every_gradient_match_jax(seed):
    params, model = make_model(40 + seed, dict(SHAPE, packed=False))
    assert_loss_and_gradients_match_jax(JCFG_D, CFG_D, params, model,
                                        make_batch(B=4, seed=seed, packed_labels=False))


def test_three_dense_train_steps_and_eval_step_match_jax():
    params, model = make_model(41, dict(SHAPE, packed=False))
    before = (proposal_cuda.proposal_dense_forward.launches,
              proposal_cuda.proposal_dense_backward.launches)
    batches = [make_batch(B=4, seed=20 + k, packed_labels=False) for k in range(3)]
    assert_steps_match_jax(JCFG_D, CFG_D, params, model, batches)
    assert (proposal_cuda.proposal_dense_forward.launches,
            proposal_cuda.proposal_dense_backward.launches) == before   # CPU: plain versions


def test_dense_step1_loss_equals_packed():
    """From the same weights and the same draws, the dense layout's first
    loss equals the packed layout's (JAX tests/test_packed.py: rel 2e-5)."""
    _, model_p = make_model(42)
    _, model_d = make_model(42, dict(SHAPE, packed=False))
    losses = {}
    for name, cfg, model in (("packed", CFG, model_p), ("dense", CFG_D, model_d)):
        step = make_train_step(cfg, model, build_optimizer(Config(model=cfg), model),
                               device="cpu")
        batch = make_batch(B=4, seed=7, packed_labels=cfg.packed)
        losses[name] = float(step(to_torch(batch))["loss"])
    assert losses["dense"] == pytest.approx(losses["packed"], rel=2e-5)


@pytest.mark.parametrize("mode", ["dense", "compat"])
def test_remat_gives_the_same_gradients(mode):
    """``remat_smi`` recomputes each block in the backward: the same loss
    and gradients as keeping the activations."""
    _, cfg = mode_configs(mode)
    batch = to_torch(make_batch(B=3, seed=8, packed_labels=False))
    grads = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat_smi=remat)
        _, model = make_model(43)
        loss = smin_loss(smin.smin_forward(model, c, *(batch[k] for k in FORWARD_KEYS)),
                         batch)[0]
        loss.backward()
        grads[remat] = (float(loss.detach()), {n: p.grad for n, p in model.named_parameters()})
    assert grads[True][0] == grads[False][0]
    for name, g in grads[False][1].items():
        torch.testing.assert_close(grads[True][1][name], g, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("field,value", [
    ("compute_dtype", "bfloat16"), ("packed", False), ("compat_head", True),
    ("fused_content", True), ("fused_smi", False), ("fused_smi_train", False),
    ("fused_lstm", False), ("remat_smi", True), ("use_pallas", False)])
def test_config_checks_admit_bf16_and_refuse_other_dtypes(field, value):
    """fp32 and bf16 are taken by the training and serving checks in every
    mode (packed: False through K8-bf16 and the dense blocks in bf16); any
    other compute_dtype raises."""
    cfg = dataclasses.replace(ModelConfig(**SHAPE), **{field: value})
    smin.check_dtype(cfg)
    smin.check_dtype(dataclasses.replace(cfg, compute_dtype="bfloat16"))
    with pytest.raises(NotImplementedError, match="compute_dtype=float16"):
        smin.check_dtype(dataclasses.replace(cfg, compute_dtype="float16"))

"""bf16 on the content-unit route and in the packed unit loop of the PyTorch
port against the JAX package, on the CPU. The port runs the plain bf16
versions of K6, K7 and K10 here; the JAX side runs as its own tests run it:
the Pallas kernels in interpret mode at bf16, `make_train_step` /
`make_eval_step` and `smin_forward` on the CPU's XLA path (which trains every
packed config through the unit loop at bf16, the oracle of the step tests).

* K6-bf16 (the packed proposal, K1-bf16's device code) against
  `proposal_features_packed_pallas(interpret=True)` at bf16, forward and VJP,
  at K1-bf16's tolerances (tests/test_torch_bf16_train.py);
* K7-bf16 against `content_train_pallas.content_rows_train` at bf16 (c-major
  <-> n-major through ops/packing.py): cu and convfc at valid pairs, dfc,
  dfbar, dfw, dfs and the 14 weight gradients; the bf16 content-unit stack
  against `smi_stack_content_train(interpret=True)` at bf16;
* K10-bf16 against `content_unit_fused(..., True)` at bf16 and its custom VJP
  (the XLA unit's VJP at bf16);
* one bf16 train step on each route this slice admits (a narrow config whose
  N * C is over the whole-layer rule's row cap, ``compat_head`` +
  ``fused_content``, ``fused_smi_train: False``) against the JAX
  `make_train_step` at bf16; the eval step and `smin_forward_inference` at
  bf16 under ``compat_head`` and ``fused_smi: False``;
* where each plain bf16 version rounds: K6's as K1's, K7's content section as
  the bf16 layer's, K10's residual added in bf16 as the JAX kernel adds it.

Tolerances are those of tests/test_torch_bf16_train.py: the bulk criterion
of tests/test_smin_train_pallas.py::test_forward_parity_bf16 (mean |diff| <
0.02, 98th percentile < 0.1, max < 0.5 of the mean |reference| on valid
positions), weight gradients against the layer's largest, the loss at rtol
2e-2, a gradient that cannot meet the bulk criterion no farther from JAX-bf16
than 1.5 times JAX-bf16's distance from JAX-fp32, and the eval step at atol
2e-2 (tests/test_dtype_remat.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_moment_localization_tpu.config import ModelConfig as JaxModelConfig
from video_moment_localization_tpu.models import smin as jsmin
from video_moment_localization_tpu.models import smin_forward as j_smin_forward
from video_moment_localization_tpu.ops import content_train_pallas as ctp
from video_moment_localization_tpu.ops.content_pallas import content_unit_fused as j_fused
from video_moment_localization_tpu.ops.packing import packed_valid_mask as j_packed_valid_mask
from video_moment_localization_tpu.ops.proposal import proposal_features_packed as j_proposal
from video_moment_localization_tpu.ops.proposal_pallas import (
    proposal_features_packed_pallas as j_k6,
)
from video_moment_localization_tpu.ops.smin_pallas import _stack_weights
from video_moment_localization_tpu.parallel import steps as jsteps
from video_moment_localization_tpu_torch.config import ModelConfig
from video_moment_localization_tpu_torch.models import smin
from video_moment_localization_tpu_torch.models.port import state_dict_from_jax_params
from video_moment_localization_tpu_torch.ops import content_cuda, proposal_cuda
from video_moment_localization_tpu_torch.ops import content_train_cuda as ctc
from video_moment_localization_tpu_torch.ops.packing import pack_rows
from video_moment_localization_tpu_torch.ops import smin_train_cuda
from video_moment_localization_tpu_torch.ops.smin_train_cuda import layer_weights_for
from video_moment_localization_tpu_torch.parallel.steps import make_eval_step

from _torch_train_common import ACTS, make_batch, make_model, readout, to_torch
from test_torch_bf16_train import (
    BULK,
    FORWARD_KEYS,
    K1_TOL,
    _jax_step_loss_and_grads,
    _module_of,
    _port_value_and_grad,
    assert_bulk,
    bulk_distance,
)

BF = torch.bfloat16
# The content kernels' tests: D and dl at the JAX content train kernel's
# lane width (content_train_pallas.supports asks for multiples of 128).
SHAPE = dict(T=16, L=8, C=4, D=128, dl=128, num_smi_layers=2, input_video_dim=12,
             max_query_length=6, lstm_hidden_size=64, compute_dtype="bfloat16")
CFG = ModelConfig(**SHAPE)
N = CFG.L * (CFG.L + 1) // 2
# The step tests: tests/test_torch_bf16_train.py's small config, and
# tests/test_torch_content_train_step.py's narrow one (N * C = 4752 clip rows,
# over the whole-layer rule's cap: the content-unit route).
STEP_SHAPE = dict(T=16, L=8, C=4, D=32, dl=8, num_smi_layers=2, input_video_dim=12,
                  max_query_length=6, lstm_hidden_size=16)
ROWS_SHAPE = dict(T=32, L=32, C=9, D=16, dl=8, num_smi_layers=2, input_video_dim=6,
                  max_query_length=4, lstm_hidden_size=8)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bf16(x):
    return torch.from_numpy(np.array(_f32(x))).to(BF)


def _valid_bulk(got, want, mask, name):
    """The bulk criterion on valid positions; prints the readings (mean,
    p98, max over the mean |want|), which `pytest -s` shows."""
    got, want = _f32(got), _f32(want)
    keep = np.broadcast_to(mask, want.shape) > 0
    scale = float(np.abs(want[keep].astype(np.float64)).mean())
    readings = tuple(float(x) for x in bulk_distance(got[keep], want[keep], scale))
    print(f"{name}: mean, p98, max {readings}")
    assert_bulk(got[keep], want[keep], name)


def _bulk_or_named_fallback(got, want, want32, mask, name, fallback=()):
    """The bulk criterion on valid positions; for a gradient named in
    ``fallback`` that misses it, tests/test_torch_bf16_train.py's fallback
    instead: no farther from JAX-bf16 (``want``) than 1.5 times JAX-bf16's
    distance from JAX-fp32 (``want32``), mean and max, at the same scale."""
    got, want, want32 = _f32(got), _f32(want), _f32(want32)
    keep = np.broadcast_to(mask, want.shape) > 0
    got, want, want32 = got[keep], want[keep], want32[keep]
    scale = float(np.abs(want.astype(np.float64)).mean())
    mean, p98, mx = bulk_distance(got, want, scale)
    if mean < BULK["mean"] and p98 < BULK["p98"] and mx < BULK["max"]:
        return
    assert name in fallback, (name, dict(mean=mean, p98=p98, max=mx))
    ref = bulk_distance(want, want32, scale)
    assert mean <= 1.5 * ref[0] and mx <= 1.5 * ref[2], (name, (mean, p98, mx), ref)


def _weights_bulk(got, want, name):
    """Weight gradients by name against their layer's largest."""
    scale = max(float(np.abs(w).max()) for w in want.values())
    for n, w in want.items():
        g = got[n]
        assert g is not None and g.dtype == torch.float32, (name, n)
        mean, p98, mx = bulk_distance(g.numpy(), w, scale)
        assert mean < BULK["mean"] and p98 < BULK["p98"] and mx < BULK["max"], \
            (name, n, mean, p98, mx)


@pytest.fixture(scope="module")
def inputs():
    return layer_inputs()


def layer_inputs():
    """bf16 layer inputs (JAX arrays) of three elements: the proposal
    features of random f, a video cut to L/2 snippets, a query of three words
    and one of a single word; the masks fp32 (numpy)."""
    rng = np.random.default_rng(0)
    B, Nq, D = 3, CFG.max_query_length, CFG.D
    qmask = np.ones((B, Nq, 1), np.float32)
    qmask[0, 3:] = 0
    qmask[2, 1:] = 0
    lmask = np.ones((B, CFG.L), np.float32)
    lmask[1, CFG.L // 2:] = 0
    f = jnp.asarray(rng.standard_normal((B, CFG.T, D)), jnp.bfloat16)
    fc, fm, fb = j_proposal(f, jnp.asarray(lmask), CFG.L, CFG.C)
    vmask = np.array(j_packed_valid_mask(jnp.asarray(lmask)))
    acts = dict(fc=fc, fm=fm, fb=fb,
                fw=jnp.asarray(rng.standard_normal((B, Nq, D)) * qmask, jnp.bfloat16),
                fs=jnp.asarray(rng.standard_normal((B, D)), jnp.bfloat16))
    return acts, qmask, lmask, vmask


@pytest.fixture(scope="module")
def model():
    return make_model(5, SHAPE)


# --------------------------------------------------------------------------- #
# K6-bf16
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", [0, 1])
def test_k6_bf16_forward_and_vjp_match_the_jax_packed_kernel(seed):
    rng = np.random.default_rng(seed)
    B, T, L, C, D = 3, 16, 8, 4, 32
    n = L * (L + 1) // 2
    f = jnp.asarray(rng.standard_normal((B, T, D)), jnp.bfloat16)
    lmask = np.ones((B, L), np.float32)
    lmask[1, L // 2:] = 0
    lmask[2, 1:] = 0
    cots = [jnp.asarray(rng.standard_normal(s), jnp.bfloat16)
            for s in ((B, n, C, D), (B, n, D), (B, L, D))]
    want, vjp = jax.vjp(lambda f_: j_k6(f_, jnp.asarray(lmask), L, C, True), f)
    (dwant,) = vjp(tuple(cots))

    before = (proposal_cuda.proposal_packed_forward.launches_bf16,
              proposal_cuda.proposal_packed_backward.launches_bf16)
    ft = _bf16(f).requires_grad_(True)
    got = proposal_cuda.proposal_features_packed_fused(ft, torch.from_numpy(lmask), L, C)
    assert all(g.dtype == BF for g in got)
    torch.autograd.backward(got, [_bf16(c) for c in cots])
    assert ft.grad.dtype == BF
    assert (proposal_cuda.proposal_packed_forward.launches_bf16,
            proposal_cuda.proposal_packed_backward.launches_bf16) == before  # CPU: plain
    for g, w in zip(got, want):
        np.testing.assert_allclose(_f32(g), _f32(w), **K1_TOL)
    # df sums clip cotangents that the JAX backward rounds one by one: two
    # roundings of each summand, 2^-7 of the summands' magnitude, on top.
    summands = proposal_cuda.proposal_backward_plain(
        torch.from_numpy(lmask), T, L, C, *(torch.from_numpy(np.abs(_f32(c))) for c in cots))
    err = np.abs(_f32(ft.grad) - _f32(dwant))
    bound = K1_TOL["atol"] + K1_TOL["rtol"] * np.abs(_f32(dwant)) + 2.0 ** -7 * summands.numpy()
    assert (err <= bound).all(), float((err - bound).max())


def test_k6_bf16_plain_rounds_the_fp32_pooling_once():
    """K6-bf16's plain versions are K1-bf16's: the fp32 pooling of the bf16
    values, each output (and df) rounded once, bit for bit."""
    rng = np.random.default_rng(3)
    f = torch.from_numpy(rng.standard_normal((2, 16, 8)).astype(np.float32)).to(BF)
    lmask = torch.ones(2, 8)
    lmask[1, 5:] = 0
    got = proposal_cuda.proposal_packed_forward(f, lmask, 8, 4)
    want = proposal_cuda.proposal_features_packed(f.float(), lmask, 8, 4)
    for g, w in zip(got, want):
        assert g.dtype == BF and torch.equal(g, w.to(BF))
    cots = [torch.from_numpy(rng.standard_normal(tuple(w.shape)).astype(np.float32)).to(BF)
            for w in want]
    df = proposal_cuda.proposal_packed_backward(lmask, 16, 8, 4, *cots)
    dwant = proposal_cuda.proposal_backward_plain(lmask, 16, 8, 4, *(c.float() for c in cots))
    assert df.dtype == BF and torch.equal(df, dwant.to(BF))
    # K8-bf16's plain version is the dense pooling, rounded once the same way.
    mm = torch.triu(lmask[:, :, None] * lmask[:, None, :])
    dense = proposal_cuda.proposal_dense_forward(f, mm, 8, 4)
    for g, w in zip(dense, proposal_cuda.proposal_features(f.float(), mm, 8, 4)):
        assert g.dtype == BF and torch.equal(g, w.to(BF))


# --------------------------------------------------------------------------- #
# K7-bf16
# --------------------------------------------------------------------------- #
def _c_major(x):
    """(B, N, C, D) -> the JAX kernel's (B, C, N, D)."""
    t = torch.from_numpy(np.array(_f32(x)))
    B, n, C, D = t.shape
    return jnp.asarray(pack_rows(t).reshape(B, C, n, D).numpy(), jnp.bfloat16)


def _n_major(x):
    """The JAX kernel's (B, C, N, D) -> (B, N, C, D)."""
    return _f32(x).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("layer,has_dcu", [(0, True), (1, False)])
def test_k7_bf16_matches_the_jax_kernel(inputs, model, layer, has_dcu):
    params, tmodel = model
    acts, qmask, lmask, vmask = inputs
    B, Nq, D, dl = qmask.shape[0], CFG.max_query_length, CFG.D, CFG.dl
    fbar = smin.moment_gate(_bf16(acts["fm"]), _bf16(acts["fs"]))     # the stack's bf16 gate
    rng = np.random.default_rng(3 + layer)
    vm4 = vmask[..., None, None]
    dcu = jnp.asarray(rng.standard_normal(acts["fc"].shape) * vm4, jnp.bfloat16)
    if not has_dcu:
        dcu = jnp.zeros_like(dcu)
    dconv = jnp.asarray(rng.standard_normal(fbar.shape), jnp.bfloat16)

    static = (ctp._pick_bn(N, CFG.C, D, 2), CFG.C, N, Nq, D, dl, CFG.L, True)
    qflat = jnp.asarray(qmask[..., 0][:, None, :])
    lrow = jnp.asarray(lmask[..., None])

    def jfn(p, fc_cm, fbar_, fw, fs):
        cw, cb, *_ = _stack_weights(p, D, dl, jnp.float32)
        mfc = p["smi"][layer]["moment"]["conv_fc"]
        return ctp.content_rows_train(static, cw[layer].astype(jnp.bfloat16), cb[layer],
                                      mfc["w"].astype(jnp.bfloat16), mfc["b"][None, :],
                                      fc_cm, fbar_, fw, fs[:, None, :], qflat, lrow)

    jargs = (params, _c_major(acts["fc"]), jnp.asarray(_f32(fbar), jnp.bfloat16),
             acts["fw"], acts["fs"])
    (cu_want, conv_want), vjp = jax.vjp(jfn, *jargs)
    gwant = vjp((_c_major(dcu), dconv))

    weights = layer_weights_for([w.detach() for w in ctc.content_weights(tmodel.smis[layer])],
                                BF)
    args = (_bf16(acts["fc"]), fbar, _bf16(acts["fw"]), _bf16(acts["fs"]),
            torch.from_numpy(qmask), torch.from_numpy(vmask))
    before = (ctc.content_rows_forward.launches_bf16, ctc.content_rows_backward.launches_bf16)
    cu, conv = ctc.content_rows_forward(weights, *args)
    got = ctc.content_rows_backward(weights, *args, _bf16(dcu) if has_dcu else None,
                                    _bf16(dconv))
    assert (ctc.content_rows_forward.launches_bf16,
            ctc.content_rows_backward.launches_bf16) == before     # CPU: plain versions
    assert cu.dtype == conv.dtype == BF and all(g.dtype == BF for g in got[:4])

    _valid_bulk(cu, _n_major(cu_want), vm4, "cu")
    _valid_bulk(conv, conv_want, vmask[..., None], "convfc")
    masks = (vm4, vmask[..., None], qmask, np.ones((B, 1), np.float32))
    wants = (_n_major(gwant[1]), gwant[2], gwant[3], gwant[4])
    for g, w, m, name in zip(got[:4], wants, masks, ("dfc", "dfbar", "dfw", "dfs")):
        _valid_bulk(g, w, m, name)
    sd = state_dict_from_jax_params(jax.tree.map(lambda a: np.asarray(a, np.float32), gwant[0]))
    names = [f"smis.{layer}.{n}" for n in ctc.CONTENT_WEIGHT_NAMES]
    _weights_bulk(dict(zip(names, got[4])), {n: sd[n].numpy() for n in names}, "K7-bf16")


def _stack_grads_bf16(model, acts, qmask, lmask, vmask, wm, wb):
    """The port's bf16 content-unit stack: outputs and the gradients of a
    masked fp32 readout w.r.t. the bf16 inputs and the fp32 weights."""
    B = qmask.shape[0]
    t = {k: _bf16(v).requires_grad_(True) for k, v in acts.items()}
    model.zero_grad(set_to_none=True)
    before = (ctc.content_rows_forward.launches_bf16, ctc.content_rows_backward.launches_bf16)
    fm_o, fb_o = ctc.smi_stack_content_train(model.smis, t["fc"], t["fm"], t["fb"], t["fw"],
                                             t["fs"], torch.from_numpy(qmask),
                                             torch.from_numpy(lmask), torch.from_numpy(vmask),
                                             CFG.L)
    assert fm_o.dtype == fb_o.dtype == BF
    s = ((fm_o.float() * torch.from_numpy(wm * vmask[..., None])).sum()
         + (fb_o.float() * torch.from_numpy(wb * lmask[..., None])).sum()) / B
    s.backward()
    assert before == (ctc.content_rows_forward.launches_bf16,
                      ctc.content_rows_backward.launches_bf16)
    grads = {k: t[k].grad for k in ACTS}
    grads.update({n: p.grad for n, p in model.named_parameters() if n.startswith("smis.")})
    return fm_o, fb_o, grads


def test_bf16_content_stack_matches_the_jax_kernel_stack(inputs, model):
    """The two-layer stack's outputs and the gradients of a masked readout
    against the JAX kernel stack at bf16. dfw and dfs, sums over every pair
    and clip row with much cancellation, are named for the fallback: the JAX
    kernel stack at bf16 lies as far from its fp32 result as the criterion's
    bounds there (mean 0.11 of dfw's mean magnitude at these widths)."""
    params, tmodel = model
    acts, qmask, lmask, vmask = inputs
    B = qmask.shape[0]
    wm, wb = readout(CFG, B, 1)
    jcfg = JaxModelConfig(**SHAPE)
    q, lm = jnp.asarray(qmask), jnp.asarray(lmask)

    def kernel_stack(p, fc, fm, fb, fw, fs):
        return ctp.smi_stack_content_train(p, jcfg, fc, fm, fb, fw, fs, q, lm,
                                           jnp.asarray(vmask).astype(jnp.bfloat16),
                                           interpret=True)

    def xla_stack(p, fc, fm, fb, fw, fs):
        for layer in p["smi"]:
            fc, fm, fb = jsmin.smi_block_packed(layer, fc, fm, fb, fw, fs, q, lm,
                                                jnp.asarray(vmask), CFG.L)
        return fm, fb

    def grads_of(stack, dtype):
        def scalar(p, *a):
            fm_o, fb_o = stack(p, *a)
            s = (jnp.sum(fm_o.astype(jnp.float32) * wm * vmask[..., None])
                 + jnp.sum(fb_o.astype(jnp.float32) * wb * lmask[..., None])) / B
            return s, (fm_o, fb_o)
        return jax.value_and_grad(scalar, argnums=tuple(range(6)), has_aux=True)(
            params, *(acts[k].astype(dtype) for k in ACTS))

    (_, outs), g = grads_of(kernel_stack, jnp.bfloat16)
    g32 = grads_of(xla_stack, jnp.float32)[1]          # JAX-fp32, for the fallback
    fm_o, fb_o, grads = _stack_grads_bf16(tmodel, acts, qmask, lmask, vmask, wm, wb)
    _valid_bulk(fm_o, outs[0], vmask[..., None], "fm_out")
    _valid_bulk(fb_o, outs[1], lmask[..., None], "fb_out")
    masks = dict(fc=vmask[..., None, None], fm=vmask[..., None], fb=lmask[..., None],
                 fw=qmask, fs=np.ones((B, 1), np.float32))
    for k, w, w32 in zip(ACTS, g[1:], g32[1:]):
        assert grads[k].dtype == BF, k
        _bulk_or_named_fallback(grads[k], w, w32, masks[k], f"d{k}", fallback=("dfw", "dfs"))
    sd = state_dict_from_jax_params(jax.tree.map(lambda a: np.asarray(a, np.float32), g[0]))
    for layer in range(CFG.num_smi_layers):
        names = [n for n in sd if n.startswith(f"smis.{layer}.")]
        _weights_bulk(grads, {n: sd[n].numpy() for n in names}, f"layer {layer}")


def test_k7_bf16_plain_rounds_as_the_bf16_layer(inputs, model):
    """K7-bf16's plain forward is the content section of the bf16 layer
    (`smi_layer_bf16`, K2-bf16's plain version) bit for bit, then the clip
    mean of the stored cu rounded once and conv_fc with bf16 operands, fp32
    sums and one rounding; its backward gives bf16 input gradients, fp32
    weight gradients, and with a zero dcu the same bits as with none."""
    _, tmodel = model
    acts, qmask, lmask, vmask = inputs
    t = {k: _bf16(v) for k, v in acts.items()}
    q, lm, vm = (torch.from_numpy(m) for m in (qmask, lmask, vmask))
    block = [w.detach() for w in smin.block_weights(tmodel.smis[0])]
    weights = layer_weights_for([w.detach() for w in ctc.content_weights(tmodel.smis[0])], BF)
    fbar = smin.gate_bf16(t["fm"].float(), t["fs"].float())
    cu, conv = ctc.content_rows_forward(weights, t["fc"], fbar, t["fw"], t["fs"], q, vm)
    layer_cu, _, _ = smin.smi_layer_bf16(dict(zip(smin.BLOCK_WEIGHT_NAMES, block)), t["fc"],
                                         t["fm"], t["fb"], t["fw"], t["fs"], q, lm, vm, CFG.L)
    assert torch.equal(cu, layer_cu)
    x2 = cu.float().mean(dim=2).to(BF).float()
    w_fc = weights[12].float().reshape(CFG.D, CFG.D)
    want = ((x2 @ w_fc.t() + weights[13]) * vm[..., None]).to(BF)
    assert torch.equal(conv, want)
    rng = np.random.default_rng(0)
    dconv = torch.from_numpy(rng.standard_normal(tuple(conv.shape)).astype(np.float32)).to(BF)
    args = (weights, t["fc"], fbar, t["fw"], t["fs"], q, vm)
    a = ctc.content_rows_backward(*args, torch.zeros_like(cu), dconv)
    b = ctc.content_rows_backward(*args, None, dconv)
    assert all(x.dtype == BF for x in a[:4]) and all(x.dtype == torch.float32 for x in a[4])
    for x, y in zip(list(a[:4]) + a[4], list(b[:4]) + b[4]):
        assert torch.equal(x, y)


# --------------------------------------------------------------------------- #
# K10-bf16
# --------------------------------------------------------------------------- #
UNIT_NAMES = ("fc", "fw", "fs", "fm")
UNIT_PARAMS = ("c_hat", "w_hat", "s_hat", "c_out", "attn_q", "attn_k")


@pytest.mark.parametrize("layer", [0, 1])
def test_k10_bf16_matches_the_jax_kernel_and_its_vjp(inputs, model, layer):
    """The forward against the JAX kernel at bf16, the gradients against its
    VJP (the XLA unit's at bf16, every op rounded). dfw is named for the
    fallback: the JAX VJP at bf16 lies 0.19 (98th percentile) of dfw's mean
    magnitude from its fp32 result, the port's plain backward a quarter of
    that."""
    params, tmodel = model
    acts, qmask, _, vmask = inputs
    p = params["smi"][layer]["content"]
    qm, vm = jnp.asarray(qmask), jnp.asarray(vmask)
    dcu = jnp.asarray(np.random.default_rng(9 + layer).standard_normal(acts["fc"].shape),
                      jnp.bfloat16)

    @jax.jit
    def value_and_vjp(args, cot):
        out, vjp = jax.vjp(lambda p_, fc, fw, fs, fm: j_fused(p_, fc, fw, fs, fm, qm, vm, True),
                           *args)
        return out, vjp(cot)

    want, gwant = value_and_vjp((p, *(acts[k] for k in UNIT_NAMES)), dcu)
    _, g32 = value_and_vjp((p, *(acts[k].astype(jnp.float32) for k in UNIT_NAMES)),
                           dcu.astype(jnp.float32))
    unit = tmodel.smis[layer].content_unit
    t = {k: _bf16(acts[k]).requires_grad_(True) for k in UNIT_NAMES}
    before = (content_cuda.content_unit_forward.launches_bf16,
              content_cuda.content_unit_backward.launches_bf16)
    got = content_cuda.content_unit_fused(unit, t["fc"], t["fw"], t["fs"], t["fm"],
                                          torch.from_numpy(qmask), torch.from_numpy(vmask))
    weights = content_cuda.unit_weights(unit)
    grads = torch.autograd.grad(got, [t[k] for k in UNIT_NAMES] + weights, _bf16(dcu))
    assert (content_cuda.content_unit_forward.launches_bf16,
            content_cuda.content_unit_backward.launches_bf16) == before   # CPU: plain
    assert got.dtype == BF and all(g.dtype == BF for g in grads[:4])

    ones = np.ones((1, 1, 1, 1), np.float32)
    _valid_bulk(got, want, ones, "cu")
    masks = dict(fc=ones, fw=qmask, fs=ones[0, 0], fm=ones[0])
    for g, w, w32, name in zip(grads, gwant[1:], g32[1:], UNIT_NAMES):
        _bulk_or_named_fallback(g, w, w32, masks[name], f"d{name}", fallback=("dfw",))
    jw = gwant[0]
    got_w, want_w = {}, {}
    for k, name in enumerate(UNIT_PARAMS):
        got_w[f"{name}.w"], want_w[f"{name}.w"] = grads[4 + 2 * k], _f32(jw[name]["w"]).T
        got_w[f"{name}.b"], want_w[f"{name}.b"] = grads[5 + 2 * k], _f32(jw[name]["b"])
    _weights_bulk(got_w, want_w, "K10-bf16")


def test_k10_bf16_plain_adds_its_residual_in_bf16(inputs, model):
    """K10-bf16's plain forward is the content section of the bf16 kernels,
    then (bf16(f_cc) + fc) + fbar added in bf16, each sum rounded, as the JAX
    kernel adds them (bf16 tensor adds here); it differs from the one-rounding
    sum of K7 / K2 somewhere, and an invalid pair carries fc + fbar."""
    _, tmodel = model
    acts, qmask, _, vmask = inputs
    t = {k: _bf16(acts[k]) for k in UNIT_NAMES}
    q, vm = torch.from_numpy(qmask), torch.from_numpy(vmask)
    weights = layer_weights_for([w.detach() for w in
                                 content_cuda.unit_weights(tmodel.smis[1].content_unit)], BF)
    got = content_cuda.content_unit_forward(weights, t["fc"], t["fm"], t["fw"], t["fs"], q, vm)
    w = dict(zip(smin.BLOCK_WEIGHT_NAMES[:12], weights))
    fbar = smin.gate_bf16(t["fm"].float(), t["fs"].float())
    f_cc = smin.content_bf16(w, t["fc"].float(), t["fw"].float(), t["fs"].float(), q, vm)
    assert torch.equal(got, (f_cc.to(BF) + t["fc"]) + fbar[:, :, None])
    once = (f_cc + t["fc"].float() + fbar.float()[:, :, None]).to(BF)
    assert not torch.equal(got, once)
    bad = vm == 0
    assert bool(bad.any())
    assert torch.equal(got[bad], (t["fc"] + fbar[:, :, None])[bad])
    dcu = torch.from_numpy(np.random.default_rng(1).standard_normal(tuple(got.shape))
                           .astype(np.float32)).to(BF)
    g = content_cuda.content_unit_backward(weights, t["fc"], t["fm"], t["fw"], t["fs"], q, vm,
                                           dcu)
    assert all(x.dtype == BF for x in g[:4]) and all(x.dtype == torch.float32 for x in g[4])


def test_bf16_wrappers_fall_back_to_nothing_off_the_cpu(inputs, model, monkeypatch):
    """A bf16 tensor that is not on the CPU reaches the kernel path of K6,
    K7 and K10 (here a meta tensor, which it refuses): no plain version and
    no fp32 kernel runs for it."""
    _, tmodel = model
    acts, qmask, _, vmask = inputs

    def refuse(*args, **kw):
        raise AssertionError("a plain version ran")

    for module, name in ((proposal_cuda, "proposal_rows_forward_plain_bf16"),
                         (ctc, "content_rows_plain_bf16"),
                         (content_cuda, "content_unit_plain_bf16")):
        monkeypatch.setattr(module, name, refuse)
    meta = {k: _bf16(v).to("meta") for k, v in acts.items()}
    q, vm = torch.from_numpy(qmask).to("meta"), torch.from_numpy(vmask).to("meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        proposal_cuda.proposal_packed_forward(torch.zeros(3, 16, 64, dtype=BF, device="meta"),
                                              torch.ones(3, 8, device="meta"), 8, 4)
    weights = layer_weights_for([w.detach().to("meta") for w in
                                 ctc.content_weights(tmodel.smis[0])], BF)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ctc.content_rows_forward(weights, meta["fc"], meta["fm"], meta["fw"], meta["fs"], q, vm)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        content_cuda.content_unit_forward(weights[:12], meta["fc"], meta["fm"], meta["fw"],
                                          meta["fs"], q, vm)


# --------------------------------------------------------------------------- #
# The train and eval steps
# --------------------------------------------------------------------------- #
STEP_ROUTES = {
    "content_unit_route": (ROWS_SHAPE, {}),
    "compat_fused_content": (STEP_SHAPE, dict(compat_head=True, fused_content=True)),
    "fused_smi_train_false": (STEP_SHAPE, dict(fused_smi_train=False)),
}


@pytest.mark.parametrize("route", list(STEP_ROUTES))
def test_one_bf16_step_matches_jax_make_train_step(route):
    """The loss of one step within rtol 2e-2 of the JAX `make_train_step`'s
    at bf16; every parameter's gradient by the bulk criterion against its
    module's largest, or, for a gradient that cannot meet it, no farther
    from JAX-bf16 than 1.5 times JAX-bf16's distance from JAX-fp32."""
    shape, change = STEP_ROUTES[route]
    shape = dict(shape, **change)
    cfg = ModelConfig(**shape, compute_dtype="bfloat16")
    jcfg16 = JaxModelConfig(**shape, compute_dtype="bfloat16")
    if route == "content_unit_route":          # the default mode, over the row cap
        assert cfg.packed and cfg.fused_smi_train and not cfg.compat_head
        assert not smin.whole_layer_train_admits(cfg)
    params, tmodel = make_model(23, shape)
    batch = make_batch(B=4, seed=1, cfg=cfg, packed_labels=not cfg.compat_head)
    want, gwant = _jax_step_loss_and_grads(jcfg16, params, batch)
    kernels = (ctc.content_rows_forward, content_cuda.content_unit_forward,
               proposal_cuda.proposal_packed_forward)
    before = [k.launches_bf16 for k in kernels]
    got, ggot = _port_value_and_grad(cfg, tmodel, batch)
    assert [k.launches_bf16 for k in kernels] == before            # CPU: plain versions
    np.testing.assert_allclose(got, want, rtol=2e-2)
    assert set(ggot) == set(gwant)
    scales = {}
    for n, w in gwant.items():
        scales[_module_of(n)] = max(scales.get(_module_of(n), 0.0), float(w.abs().max()))
    g32 = None
    for n, w in gwant.items():
        g = ggot[n]
        assert g is not None and g.dtype == torch.float32 and torch.isfinite(g).all(), n
        mean, p98, mx = bulk_distance(g.numpy(), w.numpy(), scales[_module_of(n)])
        if mean < BULK["mean"] and p98 < BULK["p98"] and mx < BULK["max"]:
            continue
        if g32 is None:
            g32 = _jax_step_loss_and_grads(JaxModelConfig(**shape), params, batch)[1]
        ref = bulk_distance(w.numpy(), g32[n].numpy(), scales[_module_of(n)])
        assert mean <= 1.5 * ref[0] and mx <= 1.5 * ref[2], (n, (mean, p98, mx), ref)


@pytest.mark.parametrize("change", [dict(compat_head=True, fused_content=True),
                                    dict(fused_smi=False)],
                         ids=["compat_head", "fused_smi_false"])
def test_bf16_eval_step_off_the_default_route_matches_jax(change):
    """The eval step and the grad-free forward at bf16 through
    `smin_forward` (compat_head: the unit loop with K6 and K10; fused_smi:
    False: the training route's forward) against the JAX `make_eval_step`
    and `smin_forward` at bf16: the loss and the scores within atol 2e-2."""
    shape = dict(STEP_SHAPE, **change)
    cfg = ModelConfig(**shape, compute_dtype="bfloat16")
    jcfg = JaxModelConfig(**shape, compute_dtype="bfloat16")
    params, tmodel = make_model(13, shape)
    batch = make_batch(B=4, seed=4, cfg=cfg, packed_labels=not cfg.compat_head)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jsteps.make_eval_step(jcfg)(jax.tree.map(jnp.asarray, params), jbatch)
    got = make_eval_step(cfg, tmodel, device="cpu")(to_torch(batch))
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), atol=2e-2)
    assert tuple(got["counts"].shape) == tuple(np.asarray(want["counts"]).shape)
    jout = jax.jit(lambda p, *a: j_smin_forward(p, jcfg, *a, None))(
        params, *(jbatch[k] for k in FORWARD_KEYS))
    tb = to_torch(batch)
    tout = smin.smin_forward_inference(tmodel, cfg, *(tb[k] for k in FORWARD_KEYS))
    for a, b in zip(tout, jout):
        assert a.dtype == torch.float32 and tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-2)


def test_k9_and_the_dense_layout_run_at_bf16(monkeypatch):
    """K9 (``VML_SMIN_TRAIN_FUSED_FWD=1``) and the dense layout (K8 and the
    dense blocks) run at bf16: the forward under the variable gives the
    per-layer route's scores bit for bit (the plain K9-bf16 is K2-bf16 per
    layer), the dense one fp32 scores with pm (B, L, L), and neither runs a
    kernel here."""
    cfg = ModelConfig(**STEP_SHAPE, compute_dtype="bfloat16")
    _, tmodel = make_model(3, STEP_SHAPE)
    tb = to_torch(make_batch(B=2, seed=0, cfg=cfg))
    args = [tb[k] for k in FORWARD_KEYS]
    before = (proposal_cuda.proposal_dense_forward.launches_bf16,
              smin_train_cuda.smi_stack_forward.launches_bf16)
    per_layer = smin.smin_forward(tmodel, cfg, *args)
    monkeypatch.setenv("VML_SMIN_TRAIN_FUSED_FWD", "1")
    fused = smin.smin_forward(tmodel, cfg, *args)
    assert all(torch.equal(a, b) for a, b in zip(per_layer, fused))
    monkeypatch.delenv("VML_SMIN_TRAIN_FUSED_FWD")
    dense = dataclasses.replace(cfg, packed=False)
    lm = tb["length_mask"]
    mm = torch.triu(lm[:, :, None] * lm[:, None, :])
    out = smin.smin_forward(tmodel, dense, *args, mm)
    assert tuple(out[0].shape) == (2, cfg.L, cfg.L)
    assert all(o.dtype == torch.float32 and torch.isfinite(o).all() for o in out)
    assert (proposal_cuda.proposal_dense_forward.launches_bf16,
            smin_train_cuda.smi_stack_forward.launches_bf16) == before   # CPU: plain

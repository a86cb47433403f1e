"""bf16 on the dense layout (``packed: False``) and under the all-layers train
forward (``VML_SMIN_TRAIN_FUSED_FWD=1``) of the PyTorch port against the JAX
package, on the CPU. The port runs the plain bf16 versions of K8 and K9
here; the JAX side runs as its own tests run it: K8 and the train kernels
(K9 under the variable) in interpret mode at bf16, the dense units,
`make_train_step` and `smin_forward` on the CPU's XLA path.

* K8-bf16 against `proposal_features_pallas(interpret=True)` at bf16,
  forward and VJP, at K1-bf16's tolerances (tests/test_torch_bf16_train.py:
  rtol 1e-2, atol 1e-3; df also 2^-7 of the summands' magnitude), on a
  moment_mask with fractional values and ones below the diagonal; its plain
  version is the fp32 plain K8 on the bf16 values, rounded once;
* one dense bf16 block and the dense heads against the JAX `smi_block` and
  `localization` at bf16, by the bulk criterion of
  tests/test_smin_train_pallas.py::test_forward_parity_bf16 (mean |diff| <
  0.02, 98th percentile < 0.1, max < 0.5 of the mean |reference| on valid
  positions);
* one dense bf16 train step against the JAX `make_train_step` with
  ``packed=False`` at bf16: the loss at rtol 2e-2, every gradient by the
  bulk criterion against its module's largest, or, for a gradient named
  for it, no farther from JAX-bf16 than 1.5 times JAX-bf16's distance from
  JAX-fp32; the dense bf16 forward within atol 2e-2 of the JAX fp32 one
  (tests/test_dtype_remat.py), and the eval step at atol 2e-2;
* the bf16 stack under ``VML_SMIN_TRAIN_FUSED_FWD=1`` (K9-bf16's plain
  version, then K3-bf16's) against the JAX stack at bf16 in interpret mode
  under the same variable (K9 and K3 at bf16), outputs and gradients by the
  bulk criterion; and equal bit for bit to the stack without the variable.
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
from video_moment_localization_tpu.ops.proposal import proposal_features as j_proposal
from video_moment_localization_tpu.ops.proposal_pallas import proposal_features_pallas as j_k8
from video_moment_localization_tpu.parallel import steps as jsteps
from video_moment_localization_tpu_torch.config import ModelConfig
from video_moment_localization_tpu_torch.models import smin
from video_moment_localization_tpu_torch.ops import proposal_cuda, smin_train_cuda
from video_moment_localization_tpu_torch.parallel.steps import make_eval_step
from video_moment_localization_tpu_torch.train.loss import smin_loss

from _torch_train_common import ACTS, FORWARD_KEYS, make_batch, make_model, to_torch
from test_torch_bf16_content import (
    STEP_SHAPE,
    _bf16,
    _bulk_or_named_fallback,
    _f32,
    _valid_bulk,
    _weights_bulk,
)
from test_torch_bf16_train import (
    BULK,
    JCFG16,
    K1_TOL,
    SHAPE,
    _jax_stack,
    _jax_step_loss_and_grads,
    _layer_inputs,
    _module_of,
    _readout,
    bulk_distance,
)

BF = torch.bfloat16
DENSE = dict(STEP_SHAPE, packed=False)
CFG16 = ModelConfig(**DENSE, compute_dtype="bfloat16")
JCFG16_D, JCFG32_D = (JaxModelConfig(**DENSE, compute_dtype=d) for d in ("bfloat16", "float32"))
# Two frames per snippet and clips of one frame (as ActivityNet's map), and C=3.
GEOMETRIES = [dict(T=16, L=8, C=4, D=32), dict(T=16, L=8, C=3, D=16)]


def _proposal_inputs(geo, B, seed):
    """bf16 f (JAX), a moment_mask with fractional values, ones below the
    diagonal and one short video, and bf16 cotangents of (fc, fm, fb)."""
    rng = np.random.default_rng(seed)
    L, C, D = geo["L"], geo["C"], geo["D"]
    f = jnp.asarray(rng.standard_normal((B, geo["T"], D)), jnp.bfloat16)
    mm = rng.uniform(0.0, 1.0, (B, L, L)).astype(np.float32)
    mm[:, np.tril_indices(L, -1)[0], np.tril_indices(L, -1)[1]] = 1.0
    mm[0, :, L // 2:] = 0.0
    mm[0, L // 2:, :] = 0.0
    cots = [jnp.asarray(rng.standard_normal(s), jnp.bfloat16)
            for s in ((B, L, L, C, D), (B, L, L, D), (B, L, D))]
    return f, mm, cots


# --------------------------------------------------------------------------- #
# K8-bf16
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("geo", GEOMETRIES, ids=lambda g: f"T{g['T']}L{g['L']}C{g['C']}")
def test_k8_bf16_forward_and_vjp_match_the_jax_dense_kernel(geo):
    B, T, L, C = 3, geo["T"], geo["L"], geo["C"]
    f, mm, cots = _proposal_inputs(geo, B, seed=L + C)
    want, vjp = jax.vjp(lambda f_: j_k8(f_, jnp.asarray(mm), L, C, True), f)
    (dwant,) = vjp(tuple(cots))

    before = (proposal_cuda.proposal_dense_forward.launches_bf16,
              proposal_cuda.proposal_dense_backward.launches_bf16)
    ft = _bf16(f).requires_grad_(True)
    got = proposal_cuda.proposal_features_dense_fused(ft, torch.from_numpy(mm), L, C)
    assert all(g.dtype == BF for g in got)
    torch.autograd.backward(got, [_bf16(c) for c in cots])
    assert ft.grad.dtype == BF
    assert (proposal_cuda.proposal_dense_forward.launches_bf16,
            proposal_cuda.proposal_dense_backward.launches_bf16) == before   # CPU: plain
    for g, w, name in zip(got, want, ("fc", "fm", "fb")):
        assert w.dtype == jnp.bfloat16, name
        np.testing.assert_allclose(_f32(g), _f32(w), **K1_TOL, err_msg=name)
    below = torch.ones(L, L).tril(-1).bool()
    assert (got[0][:, below] == 0).all() and (got[1][:, below] == 0).all()
    # df sums clip cotangents that the JAX backward (the XLA VJP of the
    # prefix sums at bf16) rounds one by one: two roundings of each summand,
    # 2^-7 of the summands' magnitude, on top.
    summands = proposal_cuda.proposal_backward_plain(
        torch.from_numpy(mm), T, L, C, *(torch.from_numpy(np.abs(_f32(c))) for c in cots))
    err = np.abs(_f32(ft.grad) - _f32(dwant))
    bound = K1_TOL["atol"] + K1_TOL["rtol"] * np.abs(_f32(dwant)) + 2.0 ** -7 * summands.numpy()
    assert (err <= bound).all(), float((err - bound).max())


def test_k8_bf16_plain_rounds_the_fp32_dense_pooling_once():
    """K8-bf16's plain versions are the fp32 plain K8 on the bf16 values,
    each output (and df) rounded once, bit for bit."""
    geo = GEOMETRIES[0]
    f, mm, cots = _proposal_inputs(geo, 2, seed=3)
    f, mm, cots = _bf16(f), torch.from_numpy(mm), [_bf16(c) for c in cots]
    T, L, C = geo["T"], geo["L"], geo["C"]
    got = proposal_cuda.proposal_dense_forward(f, mm, L, C)
    want = proposal_cuda.proposal_features(f.float(), mm, L, C)
    for g, w in zip(got, want):
        assert g.dtype == BF and torch.equal(g, w.to(BF))
    df = proposal_cuda.proposal_dense_backward(mm, T, L, C, *cots)
    dwant = proposal_cuda.proposal_backward_plain(mm, T, L, C, *(c.float() for c in cots))
    assert df.dtype == BF and torch.equal(df, dwant.to(BF))


# --------------------------------------------------------------------------- #
# The dense blocks and heads at bf16
# --------------------------------------------------------------------------- #
def _dense_block_inputs(B=3, seed=0):
    """bf16 dense layer inputs (JAX) from the JAX XLA dense proposal at bf16,
    a ragged video and queries (one of a single word), and fp32 masks."""
    rng = np.random.default_rng(seed)
    Nq, L, D = CFG16.max_query_length, CFG16.L, CFG16.D
    qmask = np.ones((B, Nq, 1), np.float32)
    qmask[0, 2:] = 0
    qmask[2, 1:] = 0
    lmask = np.ones((B, L), np.float32)
    lmask[1, L // 2:] = 0
    mm = np.triu(lmask[:, :, None] * lmask[:, None, :]).astype(np.float32)
    f = jnp.asarray(rng.standard_normal((B, CFG16.T, D)), jnp.bfloat16)
    fc, fm, fb = j_proposal(f, jnp.asarray(mm), L, CFG16.C)
    acts = dict(fc=fc, fm=fm, fb=fb,
                fw=jnp.asarray(rng.standard_normal((B, Nq, D)) * qmask, jnp.bfloat16),
                fs=jnp.asarray(rng.standard_normal((B, D)), jnp.bfloat16))
    return acts, qmask, lmask, mm


@pytest.mark.parametrize("layer", [0, 1])
def test_dense_bf16_block_and_heads_match_jax(layer):
    params, model = make_model(3, DENSE)
    acts, qmask, lmask, mm = _dense_block_inputs(seed=layer)
    masks = [jnp.asarray(m) for m in (qmask, lmask, mm)]
    want = jax.jit(jsmin.smi_block)(params["smi"][layer], *(acts[k] for k in ACTS), *masks)
    jheads = jax.jit(jsmin.localization)(params["localization"], want[1], want[2], masks[1],
                                         masks[2])
    t = [_bf16(acts[k]) for k in ACTS] + [torch.from_numpy(m) for m in (qmask, lmask, mm)]
    with torch.no_grad():
        got = smin.smi_block(model.smis[layer], *t)
        heads = smin.localization(model.localization, got[1], got[2], t[6], t[7])
    assert all(g.dtype == BF for g in got) and all(h.dtype == torch.float32 for h in heads)
    for g, w, m, name in zip(got, want, (mm[..., None, None], mm[..., None], lmask[..., None]),
                             ("cu", "mu", "bu")):
        assert w.dtype == jnp.bfloat16, name
        _valid_bulk(g, w, m, name)
    for g, w, m, name in zip(heads, jheads, (mm, lmask, lmask, lmask), ("pm", "ps", "pe", "pa")):
        _valid_bulk(g, w, m, name)


def test_dense_bf16_boundary_message_sums_in_fp32():
    """The dense moment -> boundary message sums its L terms in fp32 and
    rounds once, as XLA's bf16 dot (the JAX unit's einsum, on the CPU) does.
    With f_b zero the unit's output is the message alone, over a uniform
    A_b (powers of two: exact); from the same bf16 fbar both packages give
    the same bits, which a running sum in bf16 would not."""
    params, model = make_model(5, DENSE)
    acts, qmask, lmask, _ = _dense_block_inputs(seed=4)
    fb = jnp.zeros_like(acts["fb"])
    fbar = jsmin.moment_gate(acts["fm"], acts["fs"])
    jargs = (fb, acts["fw"], acts["fs"], acts["fm"], jnp.asarray(qmask), jnp.asarray(lmask))
    want = jax.jit(jsmin.boundary_unit)(params["smi"][0]["boundary"], *jargs, fbar=fbar)
    t = [_bf16(a) for a in jargs[:4]] + [torch.from_numpy(qmask), torch.from_numpy(lmask)]
    with torch.no_grad():
        got = smin.boundary_unit(model.smis[0].boundary_unit, *t, fbar=_bf16(fbar))
    assert got.dtype == BF
    np.testing.assert_array_equal(_f32(got), _f32(want))
    # The control: the same terms added one by one in bf16.
    a_b = torch.from_numpy(lmask / lmask.sum(1, keepdims=True))[:, :, None, None] \
        * torch.from_numpy(lmask)[:, :, None, None]
    terms = (a_b * _bf16(fbar).float()).to(BF)
    running = torch.zeros_like(terms[:, :, 0])
    for j in range(terms.shape[2]):
        running = running + terms[:, :, j]
    assert not torch.equal(running, got)


# --------------------------------------------------------------------------- #
# The train and eval steps, and the forward against JAX fp32
# --------------------------------------------------------------------------- #
STEP_FALLBACK = ("smis.0.content_unit.linear_c_hat.bias",)


def _port_value_and_grad(cfg, model, batch):
    tb = to_torch(batch)
    model.zero_grad(set_to_none=True)
    loss, _ = smin_loss(smin.smin_forward(model, cfg, *(tb.get(k) for k in FORWARD_KEYS)), tb)
    loss.backward()
    return float(loss.detach()), {n: p.grad for n, p in model.named_parameters()}


def test_one_dense_bf16_step_matches_jax_make_train_step():
    """The loss of one step within rtol 2e-2 of the JAX `make_train_step`'s
    at bf16 with ``packed=False``; every parameter's gradient by the bulk
    criterion against its module's largest, or, for a gradient named in
    STEP_FALLBACK, no farther from JAX-bf16 than 1.5 times JAX-bf16's
    distance from JAX-fp32. The first layer's c_hat bias gradient sums the
    clip rows of all L * L cells: JAX-bf16 lies 0.13 (max) of the layer's
    largest gradient from JAX-fp32 there, the port 0.0019."""
    params, model = make_model(23, DENSE)
    batch = make_batch(B=4, seed=1, cfg=CFG16, packed_labels=False)
    want, gwant = _jax_step_loss_and_grads(JCFG16_D, params, batch)
    before = (proposal_cuda.proposal_dense_forward.launches_bf16,
              proposal_cuda.proposal_dense_backward.launches_bf16)
    got, ggot = _port_value_and_grad(CFG16, model, batch)
    assert (proposal_cuda.proposal_dense_forward.launches_bf16,
            proposal_cuda.proposal_dense_backward.launches_bf16) == before   # CPU: plain
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
        assert n in STEP_FALLBACK, (n, (mean, p98, mx))
        if g32 is None:
            g32 = _jax_step_loss_and_grads(JCFG32_D, params, batch)[1]
        ref = bulk_distance(w.numpy(), g32[n].numpy(), scales[_module_of(n)])
        assert mean <= 1.5 * ref[0] and mx <= 1.5 * ref[2], (n, (mean, p98, mx), ref)


@pytest.mark.parametrize("inference", [False, True])
def test_dense_bf16_forward_tracks_jax_fp32(inference):
    """tests/test_dtype_remat.py::test_bf16_forward_close_to_fp32_and_outputs_fp32
    on the port's dense layout: the bf16 forward (differentiable, and the
    grad-free one, which takes the same route) within atol 2e-2 of the JAX
    fp32 forward, its outputs fp32 and pm (B, L, L)."""
    params, model = make_model(4, DENSE)
    batch = make_batch(B=4, seed=2, cfg=CFG16, packed_labels=False)
    want = jax.jit(lambda p, *a: j_smin_forward(p, JCFG32_D, *a))(
        params, *(jnp.asarray(batch[k]) for k in FORWARD_KEYS))
    tb = to_torch(batch)
    run = smin.smin_forward_inference if inference else smin.smin_forward
    with torch.no_grad():
        got = run(model, CFG16, *(tb[k] for k in FORWARD_KEYS))
    assert tuple(got[0].shape) == (4, CFG16.L, CFG16.L)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-2)


def test_dense_bf16_eval_step_matches_jax_make_eval_step():
    """The eval step at bf16 on the dense layout against the JAX
    `make_eval_step` at bf16: the loss within atol 2e-2, the counts' shape."""
    params, model = make_model(13, DENSE)
    batch = make_batch(B=4, seed=4, cfg=CFG16, packed_labels=False)
    want = jsteps.make_eval_step(JCFG16_D)(jax.tree.map(jnp.asarray, params),
                                           {k: jnp.asarray(v) for k, v in batch.items()})
    got = make_eval_step(CFG16, model, device="cpu")(to_torch(batch))
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), atol=2e-2)
    assert tuple(got["counts"].shape) == tuple(np.asarray(want["counts"]).shape)


# --------------------------------------------------------------------------- #
# K9-bf16: the all-layers train forward at bf16
# --------------------------------------------------------------------------- #
def _port_stack_grads(model, ins, qmask, lmask, vmask, wm, wb):
    """The port's bf16 stack: outputs and the gradients of a masked fp32
    readout w.r.t. the bf16 inputs and the fp32 weights."""
    B = qmask.shape[0]
    t = {k: _bf16(ins[k]).requires_grad_(True) for k in ACTS}
    model.zero_grad(set_to_none=True)
    fm_o, fb_o = smin_train_cuda.smi_stack_layers(
        model.smis, *(t[k] for k in ACTS), torch.from_numpy(qmask), torch.from_numpy(lmask),
        torch.from_numpy(np.array(vmask)), SHAPE["L"])
    s = ((fm_o.float() * torch.from_numpy(wm * vmask[..., None])).sum()
         + (fb_o.float() * torch.from_numpy(wb * lmask[..., None])).sum()) / B
    s.backward()
    grads = {k: t[k].grad for k in ACTS}
    grads.update({n: p.grad for n, p in model.named_parameters() if n.startswith("smis.")})
    return fm_o, fb_o, grads


def test_fused_fwd_bf16_stack_matches_the_jax_stack(monkeypatch):
    """Under ``VML_SMIN_TRAIN_FUSED_FWD=1`` in both packages: the two-layer
    bf16 stack's outputs and the gradients of a masked readout against the
    JAX train kernels in interpret mode (K9 at bf16 for the forward, K3 at
    bf16 for the backward), by the bulk criterion on valid positions. dfw
    and dfs (as in tests/test_torch_bf16_content.py) and dfm may take the
    fallback against the XLA stack at fp32: dfm's largest values (near 9.3,
    15 times its mean magnitude) lie 0.27 (the port) and 0.10 (JAX-bf16)
    from JAX-fp32 at one pair, 0.61 of the mean apart; over all of dfm the
    port lies as far from JAX-fp32 as JAX-bf16 does (mean 0.0078 against
    0.0072 of the mean magnitude, max 1.13 against 1.03)."""
    from video_moment_localization_tpu.models.smin import smi_block_packed as j_block

    monkeypatch.setenv("VML_SMIN_TRAIN_FUSED_FWD", "1")
    params, model = make_model(11, SHAPE)
    ins, qmask, lmask, vmask = _layer_inputs(seed=7)
    B = qmask.shape[0]
    wm, wb = _readout(B, 0)
    q, lm = jnp.asarray(qmask), jnp.asarray(lmask)
    kernel_stack = _jax_stack(params, JCFG16, qmask, lmask, vmask)

    def xla_stack(p, fc, fm, fb, fw, fs):
        for layer in p["smi"]:
            fc, fm, fb = j_block(layer, fc, fm, fb, fw, fs, q, lm, jnp.asarray(vmask), SHAPE["L"])
        return fm, fb

    def grads_of(stack, dtype):
        def scalar(p, *a):
            fm_o, fb_o = stack(p, *a)
            s = (jnp.sum(fm_o.astype(jnp.float32) * wm * vmask[..., None])
                 + jnp.sum(fb_o.astype(jnp.float32) * wb * lmask[..., None])) / B
            return s, (fm_o, fb_o)
        return jax.jit(jax.value_and_grad(scalar, argnums=tuple(range(6)), has_aux=True))(
            params, *(ins[k].astype(dtype) for k in ACTS))

    (_, outs), g = grads_of(kernel_stack, jnp.bfloat16)
    g32 = grads_of(xla_stack, jnp.float32)[1]
    before = (smin_train_cuda.smi_stack_forward.launches_bf16,
              smin_train_cuda.smi_layer_backward.launches_bf16)
    fm_o, fb_o, grads = _port_stack_grads(model, ins, qmask, lmask, vmask, wm, wb)
    assert (smin_train_cuda.smi_stack_forward.launches_bf16,
            smin_train_cuda.smi_layer_backward.launches_bf16) == before     # CPU: plain
    assert fm_o.dtype == fb_o.dtype == BF
    _valid_bulk(fm_o, outs[0], vmask[..., None], "fm_out")
    _valid_bulk(fb_o, outs[1], lmask[..., None], "fb_out")
    masks = dict(fc=vmask[..., None, None], fm=vmask[..., None], fb=lmask[..., None],
                 fw=qmask, fs=np.ones((B, 1), np.float32))
    for k, w, w32 in zip(ACTS, g[1:], g32[1:]):
        assert grads[k].dtype == BF, k
        _bulk_or_named_fallback(grads[k], w, w32, masks[k], f"d{k}",
                                fallback=("dfm", "dfw", "dfs"))
    from video_moment_localization_tpu_torch.models.port import state_dict_from_jax_params

    sd = state_dict_from_jax_params(jax.tree.map(lambda a: np.asarray(a, np.float32), g[0]))
    for layer in range(SHAPE["num_smi_layers"]):
        names = [n for n in sd if n.startswith(f"smis.{layer}.")]
        _weights_bulk(grads, {n: sd[n].numpy() for n in names}, f"layer {layer}")


def test_fused_fwd_bf16_stack_equals_the_per_layer_stack(monkeypatch):
    """The port's bf16 stack with and without ``VML_SMIN_TRAIN_FUSED_FWD=1``:
    the same outputs and gradients bit for bit (K9-bf16's plain version is
    K2-bf16's per layer)."""
    _, model = make_model(12, SHAPE)
    ins, qmask, lmask, vmask = _layer_inputs(seed=8)
    wm, wb = _readout(qmask.shape[0], 1)
    runs = {}
    for flag in ("0", "1"):
        monkeypatch.setenv("VML_SMIN_TRAIN_FUSED_FWD", flag)
        runs[flag] = _port_stack_grads(model, ins, qmask, lmask, vmask, wm, wb)
    assert torch.equal(runs["0"][0], runs["1"][0]) and torch.equal(runs["0"][1], runs["1"][1])
    assert set(runs["0"][2]) == set(runs["1"][2])
    for n, g in runs["0"][2].items():
        assert g is not None and torch.equal(g, runs["1"][2][n]), n


def test_the_fused_fwd_bf16_step_trains(monkeypatch):
    """One bf16 train step's loss and gradients under the variable equal the
    per-layer route's bit for bit on the CPU, and are finite."""
    cfg = ModelConfig(**SHAPE, compute_dtype="bfloat16")
    batch = make_batch(B=4, seed=5, cfg=cfg)
    out = {}
    for flag in ("0", "1"):
        monkeypatch.setenv("VML_SMIN_TRAIN_FUSED_FWD", flag)
        _, model = make_model(14, SHAPE)
        out[flag] = _port_value_and_grad(cfg, model, batch)
    assert np.isfinite(out["1"][0]) and out["0"][0] == out["1"][0]
    for n, g in out["0"][1].items():
        assert torch.isfinite(g).all() and torch.equal(g, out["1"][1][n]), n


def test_any_other_compute_dtype_is_still_refused():
    for change in (dict(packed=False), dict(), dict(compat_head=True)):
        cfg = dataclasses.replace(CFG16, compute_dtype="float16", **change)
        with pytest.raises(NotImplementedError, match="compute_dtype=float16"):
            smin.check_dtype(cfg)

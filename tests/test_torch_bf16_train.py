"""bf16 training and evaluation on the whole-layer route of the PyTorch port
against the JAX package, on the CPU, at the small config of
tests/test_dtype_remat.py. The port runs the plain bf16 versions of K1, K2
and K3 here (the kernels' arithmetic: bf16 operands and stored values, fp32
sums, gates and softmaxes); the JAX side runs as its own tests run it: the
Pallas train kernels in interpret mode, `make_train_step` / `make_eval_step`
on the CPU's XLA path.

Tolerances:
* K1-bf16 against `proposal_features_rows(interpret=True)` at bf16,
  forward and VJP: rtol 1e-2, atol 1e-3 (two bf16 roundings: the JAX
  kernel rounds its averaging matrix and its store); df, a sum of clip
  cotangents that the JAX backward rounds one by one, also 2^-7 of the
  summands' magnitude (two roundings of each summand);
* K2-bf16 and K3-bf16 against the JAX train kernels at bf16: the bulk
  criterion of tests/test_smin_train_pallas.py::test_forward_parity_bf16
  (mean |diff| < 0.02 scale, 98th percentile < 0.1 scale, max < 0.5 scale,
  scale the mean |reference| on valid positions); weight gradients against
  the layer's largest, as the fp32 tests hold them (a key projection's bias
  has a structurally zero gradient: noise only);
* one whole step: the loss within rtol 2e-2 of JAX's, every gradient by
  the bulk criterion against the layer's (module's) largest, or, where a
  gradient cannot meet it, no farther from JAX-bf16 than 1.5 times
  JAX-bf16's distance from JAX-fp32;
* the eval step: atol 2e-2 (tests/test_dtype_remat.py).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from video_moment_localization_tpu.config import ModelConfig as JaxModelConfig
from video_moment_localization_tpu.models import smin_forward as j_smin_forward
from video_moment_localization_tpu.ops.packing import packed_valid_mask as j_packed_valid_mask
from video_moment_localization_tpu.ops.proposal import proposal_features_packed as j_proposal
from video_moment_localization_tpu.ops.proposal_pallas import (
    proposal_features_rows as j_proposal_rows,
)
from video_moment_localization_tpu.ops.smin_train_pallas import (
    pack_rows as j_pack_rows,
    smin_smi_stack_train,
)
from video_moment_localization_tpu.parallel import steps as jsteps
from video_moment_localization_tpu.train.loss import smin_loss as j_smin_loss
from video_moment_localization_tpu_torch.config import Config, ModelConfig, load_config
from video_moment_localization_tpu_torch.models.port import state_dict_from_jax_params
from video_moment_localization_tpu_torch.models.smin import (
    check_dtype,
    smin_forward,
    smin_forward_inference,
)
from video_moment_localization_tpu_torch.ops import proposal_cuda, smin_train_cuda
from video_moment_localization_tpu_torch.ops.packing import pack_rows
from video_moment_localization_tpu_torch.parallel.steps import (
    build_optimizer,
    make_eval_step,
    make_train_step,
)
from video_moment_localization_tpu_torch.train.loss import smin_loss

from _torch_train_common import ACTS, make_batch, make_model, to_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = dict(T=16, L=8, C=4, D=32, dl=8, num_smi_layers=2, input_video_dim=12,
             max_query_length=6, lstm_hidden_size=16)
SHAPE16 = dict(SHAPE, compute_dtype="bfloat16")
JCFG16, CFG16 = JaxModelConfig(**SHAPE16), ModelConfig(**SHAPE16)
JCFG32 = JaxModelConfig(**SHAPE)
BF = torch.bfloat16
K1_TOL = dict(rtol=1e-2, atol=1e-3)
BULK = dict(mean=0.02, p98=0.1, max=0.5)
FORWARD_KEYS = ("video_features", "video_mask", "query_features", "query_mask", "length_mask")


def bulk_distance(got, want, scale):
    """(mean, 98th percentile, max) of |got - want| over ``scale``."""
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).ravel()
    return d.mean() / scale, np.quantile(d, 0.98) / scale, d.max() / scale


def assert_bulk(got, want, name, scale=None):
    """The bulk criterion; ``scale`` defaults to the mean |want|."""
    scale = float(np.abs(np.asarray(want, np.float64)).mean()) if scale is None else scale
    assert scale > 0, name
    mean, p98, mx = bulk_distance(got, want, scale)
    assert mean < BULK["mean"] and p98 < BULK["p98"] and mx < BULK["max"], \
        (name, dict(mean=mean, p98=p98, max=mx))


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if not isinstance(x, torch.Tensor) \
        else x.detach().float().numpy()


# --------------------------------------------------------------------------- #
# K1-bf16
# --------------------------------------------------------------------------- #
class _UpcastEinsum:
    """jax.numpy with an einsum that multiplies bf16 operands as fp32 when
    fp32 sums are asked for: the same products (a product of two bf16
    values is exact in fp32) and sums. The JAX rows kernel's VJP asks for a
    bf16 x bf16 -> fp32 batched einsum that JAX's CPU backend does not
    implement."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def einsum(spec, *operands, preferred_element_type=None, **kw):
        if preferred_element_type == jnp.float32:
            operands = [o.astype(jnp.float32) for o in operands]
        return jnp.einsum(spec, *operands, preferred_element_type=preferred_element_type, **kw)


@pytest.mark.parametrize("seed", [0, 1])
def test_k1_bf16_forward_and_vjp_match_the_jax_rows_kernel(seed, monkeypatch):
    from video_moment_localization_tpu.ops import proposal_pallas

    monkeypatch.setattr(proposal_pallas, "jnp", _UpcastEinsum())
    rng = np.random.default_rng(seed)
    B, T, L, C, D = 3, 16, 8, 4, 32
    N = L * (L + 1) // 2
    f = jnp.asarray(rng.standard_normal((B, T, D)), jnp.bfloat16)
    lmask = np.ones((B, L), np.float32)
    lmask[1, L // 2:] = 0
    lmask[2, 1:] = 0
    cots = [jnp.asarray(rng.standard_normal(s), jnp.bfloat16)
            for s in ((B, N, C, D), (B, N, D), (B, L, D))]
    want, vjp = jax.vjp(lambda f_: j_proposal_rows(f_, jnp.asarray(lmask), L, C, True), f)
    (dwant,) = vjp((j_pack_rows(cots[0]), cots[1], cots[2]))

    before = (proposal_cuda.proposal_rows_forward.launches_bf16,
              proposal_cuda.proposal_rows_backward.launches_bf16)
    ft = torch.from_numpy(_f32(f).copy()).to(BF).requires_grad_(True)
    got = proposal_cuda.proposal_features_rows(ft, torch.from_numpy(lmask), L, C)
    assert all(g.dtype == BF for g in got)
    torch.autograd.backward(got, [torch.from_numpy(_f32(c)).to(BF) for c in cots])
    assert ft.grad.dtype == BF
    assert (proposal_cuda.proposal_rows_forward.launches_bf16,
            proposal_cuda.proposal_rows_backward.launches_bf16) == before   # CPU: plain
    np.testing.assert_allclose(_f32(pack_rows(got[0])), _f32(want[0]), **K1_TOL)
    np.testing.assert_allclose(_f32(got[1]), _f32(want[1]), **K1_TOL)
    np.testing.assert_allclose(_f32(got[2]), _f32(want[2]), **K1_TOL)
    # df sums up to T/L * L... clip means' cotangents that the JAX backward
    # rounds one by one (its Wc, Wm and Wb and the masked dfm in bf16): two
    # roundings of each summand, 2^-7 of the summands' magnitude, on top.
    summands = proposal_cuda.proposal_backward_plain(
        torch.from_numpy(lmask), T, L, C, *(torch.from_numpy(np.abs(_f32(c))) for c in cots))
    err = np.abs(_f32(ft.grad) - _f32(dwant))
    bound = K1_TOL["atol"] + K1_TOL["rtol"] * np.abs(_f32(dwant)) + 2.0 ** -7 * summands.numpy()
    assert (err <= bound).all(), float((err - bound).max())


def test_k1_bf16_plain_rounds_the_fp32_pooling_once():
    """K1-bf16's plain versions are the fp32 ones on the bf16 values,
    rounded once: the forward's outputs and the backward's df equal the
    fp32 results rounded to bf16, bit for bit."""
    rng = np.random.default_rng(3)
    f = torch.from_numpy(rng.standard_normal((2, 16, 8)).astype(np.float32)).to(BF)
    lmask = torch.ones(2, 8)
    got = proposal_cuda.proposal_rows_forward(f, lmask, 8, 4)
    want = proposal_cuda.proposal_features_packed(f.float(), lmask, 8, 4)
    for g, w in zip(got, want):
        assert torch.equal(g, w.to(BF))
    cots = [torch.from_numpy(rng.standard_normal(tuple(w.shape)).astype(np.float32)).to(BF)
            for w in want]
    df = proposal_cuda.proposal_rows_backward(lmask, 16, 8, 4, *cots)
    dwant = proposal_cuda.proposal_backward_plain(lmask, 16, 8, 4, *(c.float() for c in cots))
    assert df.dtype == BF and torch.equal(df, dwant.to(BF))


# --------------------------------------------------------------------------- #
# K2-bf16 and K3-bf16
# --------------------------------------------------------------------------- #
def _layer_inputs(B=4, seed=0):
    """bf16 layer inputs as JAX arrays: the proposal features of random f,
    ragged masks, one query with a single valid word."""
    rng = np.random.default_rng(seed)
    Nq, L = SHAPE["max_query_length"], SHAPE["L"]
    qmask = np.ones((B, Nq, 1), np.float32)
    qmask[0, 3:] = 0
    qmask[2, 1:] = 0
    lmask = np.ones((B, L), np.float32)
    lmask[1, L // 2:] = 0
    f = jnp.asarray(rng.standard_normal((B, SHAPE["T"], SHAPE["D"])), jnp.bfloat16)
    fc, fm, fb = j_proposal(f, jnp.asarray(lmask), L, SHAPE["C"])
    ins = dict(fc=fc, fm=fm, fb=fb,
               fw=jnp.asarray(rng.standard_normal((B, Nq, SHAPE["D"])) * qmask, jnp.bfloat16),
               fs=jnp.asarray(rng.standard_normal((B, SHAPE["D"])), jnp.bfloat16))
    vmask = np.asarray(j_packed_valid_mask(jnp.asarray(lmask)))
    return ins, qmask, lmask, vmask


def _jax_stack(params, jcfg, qmask, lmask, vmask):
    vm16 = jnp.asarray(vmask).astype(jnp.bfloat16)

    def run(p, fc, fm, fb, fw, fs):
        return smin_smi_stack_train(p, jcfg, fc, fm, fb, fw, fs, jnp.asarray(qmask),
                                    jnp.asarray(lmask), vm16, interpret=True)
    return run


def _torch_stack_outputs(model, ins, qmask, lmask, vmask, requires_grad=False):
    t = {k: torch.from_numpy(_f32(v)).to(BF) for k, v in ins.items()}
    for k in ACTS:
        t[k].requires_grad_(requires_grad)
    fm_o, fb_o = smin_train_cuda.smi_stack_layers(
        model.smis, t["fc"], t["fm"], t["fb"], t["fw"], t["fs"], torch.from_numpy(qmask),
        torch.from_numpy(lmask), torch.from_numpy(vmask), SHAPE["L"])
    return t, fm_o, fb_o


def _assert_valid_bulk(got, want, mask, name):
    got, want = _f32(got), _f32(want)
    keep = np.broadcast_to(mask, want.shape) > 0
    assert_bulk(got[keep], want[keep], name)


@pytest.mark.parametrize("layers", [[0], [1], [0, 1]], ids=["layer0", "layer1", "stack"])
def test_k2_bf16_plain_matches_the_jax_train_kernels(layers):
    """Per layer (a one-layer stack of that layer's weights) and the
    two-layer stack: the outputs (mu, bu of the top layer) on valid
    positions."""
    params, model = make_model(7, SHAPE)
    ins, qmask, lmask, vmask = _layer_inputs(seed=len(layers) + layers[0])
    jparams = dict(params, smi=[params["smi"][k] for k in layers])
    jcfg = dataclasses.replace(JCFG16, num_smi_layers=len(layers))
    want = jax.jit(_jax_stack(jparams, jcfg, qmask, lmask, vmask))(jparams,
                                                                  *(ins[k] for k in ACTS))
    sub = torch.nn.Module()
    sub.smis = torch.nn.ModuleList([model.smis[k] for k in layers])
    before = smin_train_cuda.smi_layer_forward.launches_bf16
    with torch.no_grad():
        _, fm_o, fb_o = _torch_stack_outputs(sub, ins, qmask, lmask, vmask)
    assert smin_train_cuda.smi_layer_forward.launches_bf16 == before     # CPU: plain
    assert fm_o.dtype == fb_o.dtype == BF
    _assert_valid_bulk(fm_o, want[0], vmask[..., None], "mu")
    _assert_valid_bulk(fb_o, want[1], lmask[..., None], "bu")


def _readout(B, seed):
    rng = np.random.default_rng(seed)
    N = SHAPE["L"] * (SHAPE["L"] + 1) // 2
    return (rng.standard_normal((B, N, SHAPE["D"])).astype(np.float32),
            rng.standard_normal((B, SHAPE["L"], SHAPE["D"])).astype(np.float32))


@pytest.mark.parametrize("seed", [0])
def test_k3_bf16_plain_gradients_match_the_jax_stack_vjp(seed):
    """The VJP of the two-layer stack of a masked linear readout: every
    input cotangent by the bulk criterion on valid positions, every weight
    gradient against its layer's largest."""
    params, model = make_model(11 + seed, SHAPE)
    ins, qmask, lmask, vmask = _layer_inputs(seed=5 + seed)
    B = qmask.shape[0]
    wm, wb = _readout(B, seed)
    stack = _jax_stack(params, JCFG16, qmask, lmask, vmask)

    def scalar(p, *acts):
        fm_o, fb_o = stack(p, *acts)
        return (jnp.sum(fm_o.astype(jnp.float32) * wm * vmask[..., None])
                + jnp.sum(fb_o.astype(jnp.float32) * wb * lmask[..., None])) / B

    g = jax.jit(jax.grad(scalar, argnums=tuple(range(6))))(params, *(ins[k] for k in ACTS))
    before = smin_train_cuda.smi_layer_backward.launches_bf16
    model.zero_grad(set_to_none=True)
    t, fm_o, fb_o = _torch_stack_outputs(model, ins, qmask, lmask, vmask, requires_grad=True)
    s = ((fm_o.float() * torch.from_numpy(wm * vmask[..., None])).sum()
         + (fb_o.float() * torch.from_numpy(wb * lmask[..., None])).sum()) / B
    s.backward()
    assert smin_train_cuda.smi_layer_backward.launches_bf16 == before   # CPU: plain
    masks = dict(fc=vmask[..., None, None], fm=vmask[..., None], fb=lmask[..., None],
                 fw=qmask, fs=np.ones((B, 1), np.float32))
    for k, want in zip(ACTS, g[1:]):
        assert t[k].grad.dtype == BF, k
        _assert_valid_bulk(t[k].grad, want, masks[k], f"d{k}")
    sd = state_dict_from_jax_params(jax.tree.map(lambda a: np.asarray(a, np.float32), g[0]))
    named = dict(model.named_parameters())
    for layer in range(SHAPE["num_smi_layers"]):
        names = [n for n in sd if n.startswith(f"smis.{layer}.")]
        scale = max(float(np.abs(sd[n].numpy()).max()) for n in names)
        for n in names:
            assert named[n].grad is not None and named[n].grad.dtype == torch.float32, n
            mean, p98, mx = bulk_distance(named[n].grad.numpy(), sd[n].numpy(), scale)
            assert mean < BULK["mean"] and p98 < BULK["p98"] and mx < BULK["max"], \
                (n, mean, p98, mx)


def test_k3_bf16_plain_rounds_each_stored_gradient_once():
    """The plain K3-bf16's own arithmetic: activation gradients come back in
    bf16 and the 20 weight gradients in fp32; with a zero dcu the top
    layer's backward equals the one given no dcu bit for bit."""
    _, model = make_model(2, SHAPE)
    ins, qmask, lmask, vmask = _layer_inputs(seed=9)
    acts = [torch.from_numpy(_f32(ins[k])).to(BF) for k in ACTS]
    weights = smin_train_cuda.layer_weights_for(
        [w.detach() for w in smin_train_cuda.block_weights(model.smis[0])], BF)
    assert all(w.dtype == (BF if w.dim() >= 2 else torch.float32) for w in weights)
    shared = [torch.from_numpy(m) for m in (qmask, lmask, vmask)]
    out = smin_train_cuda.smi_layer_forward(weights, *acts, *shared, SHAPE["L"])
    rng = np.random.default_rng(0)
    cots = [torch.from_numpy(rng.standard_normal(tuple(o.shape)).astype(np.float32)).to(BF)
            for o in out]
    a = smin_train_cuda.smi_layer_backward(weights, *acts, *shared, SHAPE["L"],
                                           torch.zeros_like(cots[0]), cots[1], cots[2])
    b = smin_train_cuda.smi_layer_backward(weights, *acts, *shared, SHAPE["L"], None, cots[1],
                                           cots[2])
    assert all(x.dtype == BF for x in a[:5]) and all(x.dtype == torch.float32 for x in a[5])
    for x, y in zip(list(a[:5]) + a[5], list(b[:5]) + b[5]):
        assert torch.equal(x, y)


# --------------------------------------------------------------------------- #
# The train and eval steps
# --------------------------------------------------------------------------- #
def _jax_step_loss_and_grads(jcfg, params, batch):
    """The loss and every gradient of one JAX `make_train_step` (the
    gradients as the update of plain SGD at rate 1), under the port's
    parameter names."""
    jparams = jax.tree.map(jnp.asarray, params)
    opt = optax.sgd(1.0)
    new, _, metrics = jsteps.make_train_step(jcfg, opt)(
        jparams, opt.init(jparams), {k: jnp.asarray(v) for k, v in batch.items()})
    # The step donates its parameters: the numpy originals stay.
    grads = jax.tree.map(lambda a, b: np.asarray(a, np.float32) - np.asarray(b, np.float32),
                         params, new)
    return float(metrics["loss"]), state_dict_from_jax_params(grads)


def _port_value_and_grad(cfg, model, batch):
    tb = to_torch(batch)
    model.zero_grad(set_to_none=True)
    loss, _ = smin_loss(smin_forward(model, cfg, *(tb[k] for k in FORWARD_KEYS)), tb)
    loss.backward()
    return float(loss.detach()), {n: p.grad for n, p in model.named_parameters()}


def _module_of(name):
    """The unit a parameter's gradient is held against the largest of: an
    SMI layer, the video encoder, the query encoder or a head."""
    return ".".join(name.split(".")[:2])


def test_one_bf16_step_matches_jax_make_train_step():
    """The loss of one step within rtol 2e-2 of the JAX `make_train_step`'s
    at bf16; every parameter's gradient by the bulk criterion against its
    module's largest, or, for a gradient that cannot meet it, no farther
    from JAX-bf16 than 1.5 times JAX-bf16's distance from JAX-fp32."""
    params, model = make_model(23, SHAPE)
    batch = make_batch(B=4, seed=1, cfg=CFG16)
    want, gwant = _jax_step_loss_and_grads(JCFG16, params, batch)
    got, ggot = _port_value_and_grad(CFG16, model, batch)
    np.testing.assert_allclose(got, want, rtol=2e-2)
    assert set(ggot) == set(gwant)
    scales = {}
    for n, w in gwant.items():
        scales[_module_of(n)] = max(scales.get(_module_of(n), 0.0), float(w.abs().max()))
    g32 = None
    for n, w in gwant.items():
        g = ggot[n]
        assert g is not None and g.dtype == torch.float32 and torch.isfinite(g).all(), n
        scale = scales[_module_of(n)]
        mean, p98, mx = bulk_distance(g.numpy(), w.numpy(), scale)
        if mean < BULK["mean"] and p98 < BULK["p98"] and mx < BULK["max"]:
            continue
        if g32 is None:
            g32 = _jax_step_loss_and_grads(JCFG32, params, batch)[1]
        ref = bulk_distance(w.numpy(), g32[n].numpy(), scale)
        assert mean <= 1.5 * ref[0] and mx <= 1.5 * ref[2], (n, (mean, p98, mx), ref)


def test_bf16_training_is_finite_and_learns():
    """tests/test_dtype_remat.py::test_bf16_training_is_finite_and_learns on
    the port: 25 Adam steps at lr 5e-3 on one batch, every loss finite, the
    last under 0.8 of the first."""
    _, model = make_model(0, SHAPE)
    batch = to_torch(make_batch(B=4, seed=0, cfg=CFG16))
    step = make_train_step(CFG16, model, build_optimizer(Config(model=CFG16, lr=5e-3), model),
                           device="cpu")
    losses = [float(step(batch)["loss"]) for _ in range(25)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.8, losses
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_every_parameter_gets_a_finite_nonzero_gradient_at_bf16():
    """The encoders' weights among them: their bf16 casts in the training
    forward are differentiable (`module_weights`), so no weight is cut off
    from the loss."""
    _, model = make_model(4, SHAPE)
    _, grads = _port_value_and_grad(CFG16, model, make_batch(B=4, seed=2, cfg=CFG16))
    for n, g in grads.items():
        assert g is not None and g.dtype == torch.float32, n
        assert torch.isfinite(g).all(), n
        if not n.endswith("attn_layer.W_k.bias"):     # structurally zero: noise only
            assert bool((g != 0).any()), n
    for prefix in ("backbone.videoencoder.", "backbone.queryencoder."):
        assert any(n.startswith(prefix) and bool((g != 0).any()) for n, g in grads.items())


def test_bf16_step_differs_from_the_fp32_step():
    """A control: the bf16 step's loss and gradients lie farther from the
    fp32 step's than fp32 rounding, so a plain version that silently ran in
    fp32 fails the tests above' premise."""
    params, model = make_model(9, SHAPE)
    _, model32 = make_model(9, SHAPE)
    batch = make_batch(B=4, seed=3, cfg=CFG16)
    l16, g16 = _port_value_and_grad(CFG16, model, batch)
    l32, g32 = _port_value_and_grad(ModelConfig(**SHAPE), model32, batch)
    assert abs(l16 - l32) > 1e-5 * abs(l32)
    worst = max(float((g16[n] - g32[n]).abs().max() / (g32[n].abs().max() + 1e-12))
                for n in g32 if not n.endswith("W_k.bias"))
    assert worst > 1e-3


def test_bf16_eval_step_matches_jax_make_eval_step():
    """The eval step at bf16 (K5-bf16 and K4-bf16's plain versions) against
    the JAX `make_eval_step` at bf16: the loss and the forward's scores
    within atol 2e-2."""
    params, model = make_model(13, SHAPE)
    batch = make_batch(B=4, seed=4, cfg=CFG16)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jsteps.make_eval_step(JCFG16)(jax.tree.map(jnp.asarray, params), jbatch)
    got = make_eval_step(CFG16, model, device="cpu")(to_torch(batch))
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), atol=2e-2)
    assert tuple(got["counts"].shape) == tuple(np.asarray(want["counts"]).shape)
    jout = jax.jit(lambda p, *a: j_smin_forward(p, JCFG16, *a, None))(
        params, *(jbatch[k] for k in FORWARD_KEYS))
    tb = to_torch(batch)
    tout = smin_forward_inference(model, CFG16, *(tb[k] for k in FORWARD_KEYS))
    for a, b in zip(tout, jout):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-2)


# --------------------------------------------------------------------------- #
# Routing
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["charadessta", "tacos"])
def test_whole_layer_configs_train_at_bf16(name):
    cfg = dataclasses.replace(load_config(os.path.join(REPO, "config", f"{name}.yml")).model,
                              compute_dtype="bfloat16")
    check_dtype(cfg)


@pytest.mark.parametrize("change", [dict(config="activitynet"), dict(packed=False),
                                    dict(compat_head=True), dict(fused_smi_train=False)],
                         ids=["activitynet", "packed_false", "compat_head", "fused_smi_train"])
def test_other_bf16_training_routes_are_admitted(change):
    """The other training routes at bf16: the content-unit route
    (ActivityNet) and the unit loop (compat_head, fused_smi_train: False)
    since K6-bf16, K7-bf16 and K10-bf16, and packed: False since K8-bf16 and
    the dense blocks in bf16; any other compute_dtype still raises."""
    change = dict(change)
    name = change.pop("config", "charadessta")
    cfg = dataclasses.replace(load_config(os.path.join(REPO, "config", f"{name}.yml")).model,
                              compute_dtype="bfloat16", **change)
    check_dtype(cfg)
    with pytest.raises(NotImplementedError, match="compute_dtype=float16"):
        check_dtype(dataclasses.replace(cfg, compute_dtype="float16"))


def test_tacos_trains_the_whole_layer_route_at_bf16_only():
    """TACoS (N * C = 2112) takes K1 -> K2 / K3 at bf16 and the content-unit
    kernels at fp32, as in JAX (`whole_layer_train_admits` reads the
    itemsize)."""
    from video_moment_localization_tpu.ops.smin_train_pallas import supports_train
    from video_moment_localization_tpu_torch.models.smin import whole_layer_train_admits

    tacos = load_config(os.path.join(REPO, "config", "tacos.yml")).model
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(tacos, compute_dtype=dtype)
        jcfg = JaxModelConfig(**{f.name: getattr(cfg, f.name)
                                 for f in dataclasses.fields(JaxModelConfig)
                                 if hasattr(cfg, f.name)})
        assert whole_layer_train_admits(cfg) == (dtype == "bfloat16") == supports_train(jcfg)

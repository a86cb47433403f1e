"""K2 / K3's functions in the port (their plain versions, on the CPU) and the
differentiable stack against the JAX package: one SMI layer and the 2-layer
stack vs `smi_block_packed` (the XLA path), and in one small case vs the
per-layer train kernels `smin_smi_stack_train_rows(interpret=True)`: outputs,
and gradients w.r.t. fc, fm, fb, fw, fs and every weight, compared name by
name through the weight bridge (`state_dict_from_jax_params` applied to the
JAX gradient pytree). Tolerances are those of
tests/test_smin_train_pallas.py: forward rtol 2e-5 / atol 2e-5, gradients
rtol 5e-4 / atol 5e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_moment_localization_tpu.models import smin as jsmin
from video_moment_localization_tpu.ops.packing import packed_valid_mask as j_packed_valid_mask
from video_moment_localization_tpu.ops.proposal import proposal_features_packed as j_proposal
from video_moment_localization_tpu.ops.smin_train_pallas import (
    pack_rows as j_pack_rows,
    smin_smi_stack_train_rows,
)
from video_moment_localization_tpu_torch.models.port import state_dict_from_jax_params
from video_moment_localization_tpu_torch.models.smin import block_weights
from video_moment_localization_tpu_torch.ops import smin_train_cuda

from _torch_train_common import (
    ACTS,
    CFG,
    JCFG,
    jax_stack_grads,
    make_model,
    readout,
    torch_stack_grads,
)

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)


def _inputs(B=4, seed=0, single_word=True):
    """Layer inputs as numpy: the proposal features of random f, ragged
    masks, and (optionally) one query with a single valid word."""
    rng = np.random.default_rng(seed)
    Nq = CFG.max_query_length
    f = rng.standard_normal((B, CFG.T, CFG.D)).astype(np.float32)
    fw = rng.standard_normal((B, Nq, CFG.D)).astype(np.float32)
    fs = rng.standard_normal((B, CFG.D)).astype(np.float32)
    qmask = np.ones((B, Nq, 1), np.float32)
    qmask[0, 3:] = 0
    if single_word:
        qmask[2, 1:] = 0
    lmask = np.ones((B, CFG.L), np.float32)
    lmask[1, CFG.L // 2:] = 0
    fw = fw * qmask
    fc, fm, fb = (np.asarray(a) for a in j_proposal(jnp.asarray(f), jnp.asarray(lmask),
                                                    CFG.L, CFG.C))
    vmask = np.asarray(j_packed_valid_mask(jnp.asarray(lmask)))
    return dict(fc=fc, fm=fm, fb=fb, fw=fw, fs=fs, qmask=qmask, lmask=lmask, vmask=vmask)


def _torch_inputs(ins, requires_grad):
    t = {k: torch.from_numpy(v.copy()) for k, v in ins.items()}
    if requires_grad:
        for k in ACTS:
            t[k].requires_grad_(True)
    return t


def _layer_grad_names(layer):
    return [n for n in (
        "content_unit.linear_c_hat", "content_unit.linear_w_hat", "content_unit.linear_s_hat",
        "content_unit.linear_c", "content_unit.attn_layer.W_q", "content_unit.attn_layer.W_k",
        "boundary_unit.attn_layer.W_q", "boundary_unit.attn_layer.W_k",
        "moment_unit.conv_layer_fb", "moment_unit.conv_layer_fc")
            for n in (f"smis.{layer}.{n}.weight", f"smis.{layer}.{n}.bias")]


@pytest.mark.parametrize("has_dcu", [True, False])
@pytest.mark.parametrize("layer", [0, 1])
def test_one_layer_forward_and_backward_match_jax(layer, has_dcu):
    params, model = make_model(5)
    ins = _inputs(seed=layer)
    rng = np.random.default_rng(3)
    cots = [rng.standard_normal(ins[k].shape).astype(np.float32) for k in ("fc", "fm", "fb")]
    if not has_dcu:
        cots[0] = np.zeros_like(cots[0])

    def jfn(p, fc, fm, fb, fw, fs):
        return jsmin.smi_block_packed(p, fc, fm, fb, fw, fs, ins["qmask"], ins["lmask"],
                                      ins["vmask"], CFG.L)

    jargs = (params["smi"][layer], *(jnp.asarray(ins[k]) for k in ACTS))
    want, vjp = jax.vjp(jfn, *jargs)
    gwant = vjp(tuple(jnp.asarray(c) for c in cots))

    weights = [w.detach() for w in block_weights(model.smis[layer])]
    t = _torch_inputs(ins, False)
    args = (t["fc"], t["fm"], t["fb"], t["fw"], t["fs"], t["qmask"], t["lmask"], t["vmask"])
    before = (smin_train_cuda.smi_layer_forward.launches,
              smin_train_cuda.smi_layer_backward.launches)
    got = smin_train_cuda.smi_layer_forward(weights, *args, CFG.L)
    tc = [torch.from_numpy(c) for c in cots]
    ggot = smin_train_cuda.smi_layer_backward(weights, *args, CFG.L,
                                              tc[0] if has_dcu else None, tc[1], tc[2])
    assert (smin_train_cuda.smi_layer_forward.launches,
            smin_train_cuda.smi_layer_backward.launches) == before   # CPU: plain versions

    for g, w, name in zip(got, want, ("cu", "mu", "bu")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FWD_TOL, err_msg=name)
    for g, w, name in zip(ggot[:5], gwant[1:], ACTS):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL, err_msg=name)
    full = jax.tree.map(np.zeros_like, params)
    full["smi"][layer] = jax.tree.map(np.asarray, gwant[0])
    sd = state_dict_from_jax_params(full)
    for g, name in zip(ggot[5], _layer_grad_names(layer)):
        np.testing.assert_allclose(g.numpy(), sd[name].numpy(), **GRAD_TOL, err_msg=name)


def _compare(got, want, ins):
    vm3, lm3 = ins["vmask"][..., None], ins["lmask"][..., None]
    np.testing.assert_allclose(got[0].numpy() * vm3, want[0] * vm3, **FWD_TOL)
    np.testing.assert_allclose(got[1].numpy() * lm3, want[1] * lm3, **FWD_TOL)
    assert set(got[2]) == set(want[2]) and len(got[2]) == 5 + 20 * CFG.num_smi_layers
    for name, w in want[2].items():
        assert got[2][name] is not None, name
        np.testing.assert_allclose(got[2][name].numpy(), w, **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("seed", [0, 1])
def test_stack_outputs_and_all_gradients_match_jax_xla(seed):
    params, model = make_model(7 + seed)
    ins = _inputs(seed=seed)
    wm, wb = readout(CFG, 4, seed)

    def xla_stack(p, fc, fm, fb, fw, fs):
        for layer in p["smi"]:
            fc, fm, fb = jsmin.smi_block_packed(layer, fc, fm, fb, fw, fs, ins["qmask"],
                                                ins["lmask"], ins["vmask"], CFG.L)
        return fm, fb

    _compare(torch_stack_grads(smin_train_cuda.smi_stack_layers, model, CFG, ins, wm, wb),
             jax_stack_grads(xla_stack, params, ins, wm, wb), ins)


def test_stack_matches_jax_train_kernels_in_interpret_mode():
    """Against the per-layer Pallas train kernels (forward and their in-kernel
    VJP) on c-major rows. Every query keeps two or more valid words: with
    none the JAX kernels spread a row's attention over its cell (a finding
    on the JAX side, not followed by the port)."""
    params, model = make_model(11)
    ins = _inputs(seed=2, single_word=False)
    wm, wb = readout(CFG, 4, 2)

    def kernel_stack(p, fc, fm, fb, fw, fs):
        return smin_smi_stack_train_rows(p, JCFG, j_pack_rows(fc), fm, fb, fw, fs,
                                         jnp.asarray(ins["qmask"]), jnp.asarray(ins["lmask"]),
                                         jnp.asarray(ins["vmask"]), interpret=True)

    _compare(torch_stack_grads(smin_train_cuda.smi_stack_layers, model, CFG, ins, wm, wb),
             jax_stack_grads(kernel_stack, params, ins, wm, wb), ins)


def test_stack_saves_only_the_carries_and_inputs():
    """The autograd Function keeps the layer-boundary carries, the shared
    inputs and the weights: no intermediate of a layer."""
    _, model = make_model(1)
    t = _torch_inputs(_inputs(seed=3), True)
    fm_o, _ = smin_train_cuda.smi_stack_layers(
        model.smis, t["fc"], t["fm"], t["fb"], t["fw"], t["fs"], t["qmask"], t["lmask"],
        t["vmask"], CFG.L)
    saved = fm_o.grad_fn.saved_tensors
    n_layers = CFG.num_smi_layers
    assert len(saved) == 3 * n_layers + 5 + 20 * n_layers
    shapes = [tuple(s.shape) for s in saved[:3 * n_layers]]
    assert shapes == [tuple(t[k].shape) for k in ("fc", "fm", "fb")] * n_layers


def test_layer_wrappers_reject_other_devices():
    _, model = make_model(0)
    weights = block_weights(model.smis[0])
    t = {k: v.to("meta") for k, v in _torch_inputs(_inputs(), False).items()}
    args = (t["fc"], t["fm"], t["fb"], t["fw"], t["fs"], t["qmask"], t["lmask"], t["vmask"])
    with pytest.raises(ValueError, match="CPU or CUDA"):
        smin_train_cuda.smi_layer_forward(weights, *args, CFG.L)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        smin_train_cuda.smi_layer_backward(weights, *args, CFG.L, None, t["fm"], t["fb"])

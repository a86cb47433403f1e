"""K7's functions in the port (their plain versions, on the CPU) and the
content-unit stack against the JAX package, at the sizes of
tests/test_content_train_pallas.py:

* `content_rows_train` (forward, dfc, dfbar, dfw, dfs and the 14 weight
  gradients) vs `content_train_pallas.content_rows_train` in interpret mode,
  c-major <-> n-major through ops/packing.py;
* `smi_stack_content_train` vs `ctp.smi_stack_content_train(interpret=True)`
  and vs the XLA stack (`smi_block_packed` per layer): the masked outputs and
  the gradients w.r.t. fc, fm, fb, fw, fs and every weight through a masked
  readout.

Tolerances are those of tests/test_content_train_pallas.py: forward rtol
2e-5 / atol 2e-5, gradients rtol 5e-4 / atol 5e-5, the weight gradients'
absolute part relative to the layer's largest (a key-projection bias has a
structurally zero gradient: only rounding noise is left).

The JAX kernel masks cu once at the end where the port masks f_cc only (as
the XLA unit does): they agree at valid pairs, so the direct comparison masks
the cotangents and compares cu at valid pairs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_moment_localization_tpu.models import smin as jsmin
from video_moment_localization_tpu.ops import content_train_pallas as ctp
from video_moment_localization_tpu.ops.packing import packed_valid_mask as j_packed_valid_mask
from video_moment_localization_tpu.ops.proposal import proposal_features_packed as j_proposal
from video_moment_localization_tpu.ops.smin_pallas import _stack_weights
from video_moment_localization_tpu_torch.config import ModelConfig
from video_moment_localization_tpu_torch.models.port import state_dict_from_jax_params
from video_moment_localization_tpu_torch.models.smin import moment_gate
from video_moment_localization_tpu_torch.ops import content_train_cuda as ctc
from video_moment_localization_tpu_torch.ops.packing import pack_rows

from _torch_train_common import (
    JaxModelConfig,
    jax_stack_grads,
    make_model,
    readout,
    torch_stack_grads,
)

SHAPE = dict(T=16, L=8, C=4, D=64, dl=32, num_smi_layers=2, input_video_dim=12,
             max_query_length=6, lstm_hidden_size=32)
JCFG, CFG = JaxModelConfig(**SHAPE), ModelConfig(**SHAPE)
N = CFG.L * (CFG.L + 1) // 2
FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_RTOL, GRAD_ATOL = 5e-4, 5e-5
CONTENT_NAMES = ("content_unit.linear_c_hat", "content_unit.linear_w_hat",
                 "content_unit.linear_s_hat", "content_unit.linear_c",
                 "content_unit.attn_layer.W_q", "content_unit.attn_layer.W_k",
                 "moment_unit.conv_layer_fc")


def _inputs(B=3, seed=0):
    """Layer inputs as numpy: the proposal features of random f, one video cut
    to L/2 snippets, one query of three words and one of a single word."""
    rng = np.random.default_rng(seed)
    Nq = CFG.max_query_length
    f = rng.standard_normal((B, CFG.T, CFG.D)).astype(np.float32)
    fw = rng.standard_normal((B, Nq, CFG.D)).astype(np.float32)
    fs = rng.standard_normal((B, CFG.D)).astype(np.float32)
    qmask = np.ones((B, Nq, 1), np.float32)
    qmask[0, 3:] = 0
    qmask[2, 1:] = 0
    lmask = np.ones((B, CFG.L), np.float32)
    lmask[1, CFG.L // 2:] = 0
    fw = fw * qmask
    fc, fm, fb = (np.asarray(a) for a in j_proposal(jnp.asarray(f), jnp.asarray(lmask),
                                                    CFG.L, CFG.C))
    vmask = np.asarray(j_packed_valid_mask(jnp.asarray(lmask)))
    return dict(fc=fc, fm=fm, fb=fb, fw=fw, fs=fs, qmask=qmask, lmask=lmask, vmask=vmask)


def _c_major(x):
    """(B, N, C, D) -> the JAX kernel's (B, C, N, D)."""
    t = torch.from_numpy(np.array(x))
    B, n, C, D = t.shape
    return pack_rows(t).reshape(B, C, n, D).numpy()


def _c_major_inverse(x):
    """The JAX kernel's (B, C, N, D) -> (B, N, C, D)."""
    return np.asarray(x).transpose(0, 2, 1, 3)


def _grad_close(got, want, scale, name):
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL * max(scale, 1.0),
                               err_msg=name)


@pytest.mark.parametrize("has_dcu", [True, False])
@pytest.mark.parametrize("layer", [0, 1])
def test_content_rows_forward_and_backward_match_jax_kernel(layer, has_dcu):
    params, model = make_model(5, SHAPE)
    ins = _inputs(seed=layer)
    B, Nq, D, dl = ins["fc"].shape[0], CFG.max_query_length, CFG.D, CFG.dl
    fbar = moment_gate(torch.from_numpy(ins["fm"].copy()),
                       torch.from_numpy(ins["fs"].copy())).numpy()
    rng = np.random.default_rng(3)
    vm = ins["vmask"]
    dcu = rng.standard_normal(ins["fc"].shape).astype(np.float32) * vm[..., None, None]
    if not has_dcu:
        dcu = np.zeros_like(dcu)
    dconv = rng.standard_normal(fbar.shape).astype(np.float32)

    static = (ctp._pick_bn(N, CFG.C, D, 4), CFG.C, N, Nq, D, dl, CFG.L, True)
    qflat = jnp.asarray(ins["qmask"][..., 0][:, None, :])
    lrow = jnp.asarray(ins["lmask"][..., None])

    def jfn(p, fc_cm, fbar_, fw, fs):
        cw, cb, *_ = _stack_weights(p, D, dl, jnp.float32)
        mfc = p["smi"][layer]["moment"]["conv_fc"]
        return ctp.content_rows_train(static, cw[layer], cb[layer], mfc["w"], mfc["b"][None, :],
                                      fc_cm, fbar_, fw, fs[:, None, :], qflat, lrow)

    jargs = (params, jnp.asarray(_c_major(ins["fc"])), jnp.asarray(fbar),
             jnp.asarray(ins["fw"]), jnp.asarray(ins["fs"]))
    (cu_want, conv_want), vjp = jax.vjp(jfn, *jargs)
    gwant = vjp((jnp.asarray(_c_major(dcu)), jnp.asarray(dconv)))

    weights = [w.detach() for w in ctc.content_weights(model.smis[layer])]
    t = {k: torch.from_numpy(v.copy()) for k, v in ins.items()}
    args = (t["fc"], torch.from_numpy(fbar), t["fw"], t["fs"], t["qmask"], t["vmask"])
    before = (ctc.content_rows_forward.launches, ctc.content_rows_backward.launches)
    cu, conv = ctc.content_rows_forward(weights, *args)
    got = ctc.content_rows_backward(weights, *args, torch.from_numpy(dcu) if has_dcu else None,
                                    torch.from_numpy(dconv))
    assert (ctc.content_rows_forward.launches,
            ctc.content_rows_backward.launches) == before     # CPU: plain versions

    vm4 = vm[..., None, None]
    np.testing.assert_allclose(_c_major(cu.numpy() * vm4), np.asarray(cu_want), **FWD_TOL)
    np.testing.assert_allclose(conv.numpy(), np.asarray(conv_want), **FWD_TOL)
    wants = [_c_major_inverse(gwant[1]), gwant[2], gwant[3], gwant[4]]
    for g, w, name in zip(got[:4], wants, ("dfc", "dfbar", "dfw", "dfs")):
        w = np.asarray(w)
        _grad_close(g.numpy(), w, 0.0, name)
    full = jax.tree.map(np.asarray, gwant[0])
    sd = state_dict_from_jax_params(full)
    names = [f"smis.{layer}.{n}.{part}" for n in CONTENT_NAMES for part in ("weight", "bias")]
    scale = max(float(sd[n].abs().max()) for n in names)
    for g, name in zip(got[4], names):
        _grad_close(g.numpy(), sd[name].numpy(), scale, name)


def _compare(got, want, ins):
    vm3, lm3 = ins["vmask"][..., None], ins["lmask"][..., None]
    np.testing.assert_allclose(got[0].numpy() * vm3, want[0] * vm3, **FWD_TOL)
    np.testing.assert_allclose(got[1].numpy() * lm3, want[1] * lm3, **FWD_TOL)
    assert set(got[2]) == set(want[2]) and len(got[2]) == 5 + 20 * CFG.num_smi_layers
    for name, w in want[2].items():
        if name.startswith("smis."):
            continue
        _grad_close(got[2][name].numpy(), w, 0.0, name)
    for layer in range(CFG.num_smi_layers):
        names = [n for n in want[2] if n.startswith(f"smis.{layer}.")]
        assert len(names) == 20
        scale = max(float(np.abs(want[2][n]).max()) for n in names)
        for name in names:
            _grad_close(got[2][name].numpy(), want[2][name], scale, name)


@pytest.mark.parametrize("seed", [0, 1])
def test_stack_outputs_and_all_gradients_match_jax_xla(seed):
    params, model = make_model(7 + seed, SHAPE)
    ins = _inputs(seed=seed)
    wm, wb = readout(CFG, 3, seed)

    def xla_stack(p, fc, fm, fb, fw, fs):
        for layer in p["smi"]:
            fc, fm, fb = jsmin.smi_block_packed(layer, fc, fm, fb, fw, fs, ins["qmask"],
                                                ins["lmask"], ins["vmask"], CFG.L)
        return fm, fb

    _compare(torch_stack_grads(ctc.smi_stack_content_train, model, CFG, ins, wm, wb),
             jax_stack_grads(xla_stack, params, ins, wm, wb), ins)


def test_stack_matches_jax_content_kernel_in_interpret_mode():
    params, model = make_model(11, SHAPE)
    ins = _inputs(seed=2)
    wm, wb = readout(CFG, 3, 2)

    def kernel_stack(p, fc, fm, fb, fw, fs):
        return ctp.smi_stack_content_train(p, JCFG, fc, fm, fb, fw, fs,
                                           jnp.asarray(ins["qmask"]), jnp.asarray(ins["lmask"]),
                                           jnp.asarray(ins["vmask"]), interpret=True)

    _compare(torch_stack_grads(ctc.smi_stack_content_train, model, CFG, ins, wm, wb),
             jax_stack_grads(kernel_stack, params, ins, wm, wb), ins)


def test_function_saves_its_inputs_and_skips_an_unused_cu():
    """The autograd Function keeps its inputs and the weights, no
    intermediate of the unit; a cu without a consumer reaches the backward
    wrapper as ``dcu=None``, not as a tensor of zeros."""
    _, model = make_model(1, SHAPE)
    ins = _inputs(seed=3)
    t = {k: torch.from_numpy(v.copy()) for k, v in ins.items()}
    fc = t["fc"].requires_grad_(True)
    fbar = moment_gate(t["fm"], t["fs"])
    weights = ctc.content_weights(model.smis[0])
    cu, conv = ctc.content_rows_train(weights, fc, fbar, t["fw"], t["fs"], t["qmask"],
                                      t["vmask"])
    saved = conv.grad_fn.saved_tensors
    assert len(saved) == 6 + ctc.WEIGHTS
    assert [tuple(s.shape) for s in saved[:2]] == [tuple(fc.shape), tuple(fbar.shape)]
    seen = []
    plain = ctc.content_rows_backward_plain

    def spy(*args):
        seen.append(args[7])
        return plain(*args)

    ctc.content_rows_backward_plain = spy
    try:
        conv.sum().backward()
    finally:
        ctc.content_rows_backward_plain = plain
    assert seen == [None] and fc.grad is not None


def test_wrappers_reject_other_devices():
    _, model = make_model(0, SHAPE)
    weights = ctc.content_weights(model.smis[0])
    t = {k: torch.from_numpy(v.copy()).to("meta") for k, v in _inputs().items()}
    args = (t["fc"], t["fm"], t["fw"], t["fs"], t["qmask"], t["vmask"])
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ctc.content_rows_forward(weights, *args)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ctc.content_rows_backward(weights, *args, None, t["fm"])

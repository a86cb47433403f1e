"""The port's SMI stack against the JAX package: each SMI unit of a block,
the proposal pooling, and the CPU route of the K4 wrapper `smin_stack_fused`
against JAX `smin_stack_fused(..., interpret=True)` and the packed XLA
pipeline it fuses. Weights are carried across by state_dict_from_jax_params.
Tolerances are those of tests/test_smin_pallas.py (stack) and
tests/test_model.py (blocks)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_moment_localization_tpu.config import ModelConfig as JaxModelConfig
from video_moment_localization_tpu.models import init_smin_params
from video_moment_localization_tpu.models import smin as jsmin
from video_moment_localization_tpu.ops import smin_pallas
from video_moment_localization_tpu.ops.packing import packed_valid_mask as j_packed_valid_mask
from video_moment_localization_tpu.ops.proposal import proposal_features_packed as j_proposal
from video_moment_localization_tpu_torch.config import ModelConfig
from video_moment_localization_tpu_torch.models import smin as tsmin
from video_moment_localization_tpu_torch.models.port import state_dict_from_jax_params
from video_moment_localization_tpu_torch.ops import smin_cuda
from video_moment_localization_tpu_torch.ops.packing import packed_valid_mask
from video_moment_localization_tpu_torch.ops.proposal import proposal_features_packed

SHAPE = dict(T=16, L=8, C=4, D=64, dl=32, num_smi_layers=3, input_video_dim=12,
             max_query_length=6, lstm_hidden_size=32)
JCFG, CFG = JaxModelConfig(**SHAPE), ModelConfig(**SHAPE)
STACK_TOL = dict(rtol=2e-4, atol=2e-5)
BLOCK_TOL = dict(rtol=1e-4, atol=1e-5)


def _model(seed):
    params = jax.tree.map(np.asarray, init_smin_params(jax.random.PRNGKey(seed), JCFG))
    model = tsmin.SMIN(CFG)
    model.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return params, model.eval()


def _inputs(B=4, seed=0, empty_query=False):
    rng = np.random.default_rng(seed)
    Nq = CFG.max_query_length
    f = rng.standard_normal((B, CFG.T, CFG.D)).astype(np.float32)
    fw = rng.standard_normal((B, Nq, CFG.D)).astype(np.float32)
    fs = rng.standard_normal((B, CFG.D)).astype(np.float32)
    qmask = np.ones((B, Nq, 1), np.float32)
    qmask[0, 3:] = 0                       # ragged query
    if empty_query:
        qmask[2] = 0                       # no valid word: uniform word attention
    lmask = np.ones((B, CFG.L), np.float32)
    lmask[1, CFG.L // 2:] = 0              # short video
    lmask[3, 1:] = 0                       # one-snippet video
    fw = fw * qmask                        # LSTM outputs are 0 at padded steps
    return f, fw, fs, qmask, lmask


def _jax_xla_stack(params, f, fw, fs, qmask, lmask):
    """The packed XLA pipeline the JAX kernel fuses (tests/test_smin_pallas.py)."""
    vmask = j_packed_valid_mask(jnp.asarray(lmask))
    fc, fm, fb = j_proposal(jnp.asarray(f), jnp.asarray(lmask), JCFG.L, JCFG.C)
    for p in params["smi"]:
        fc, fm, fb = jsmin.smi_block_packed(p, fc, fm, fb, fw, fs, qmask, lmask, vmask, JCFG.L)
    return jsmin.localization_packed(params["localization"], fm, fb, lmask, vmask, JCFG.L)


def _torch_stack(model, f, fw, fs, qmask, lmask):
    t = [torch.from_numpy(a) for a in (f, fw, fs, qmask, lmask)]
    vmask = packed_valid_mask(t[4])
    with torch.no_grad():
        return smin_cuda.smin_stack_fused(model, CFG, *t, vmask)


@pytest.mark.parametrize("seed", [0, 1])
def test_stack_cpu_route_matches_jax_kernel_and_xla(seed):
    params, model = _model(7 + seed)
    ins = _inputs(seed=seed)
    before = smin_cuda.smin_stack_fused.launches
    got = _torch_stack(model, *ins)
    assert smin_cuda.smin_stack_fused.launches == before   # CPU: the plain route
    vmask = j_packed_valid_mask(jnp.asarray(ins[4]))
    kernel = smin_pallas.smin_stack_fused(params, JCFG, *map(jnp.asarray, ins), vmask,
                                          interpret=True)
    xla = _jax_xla_stack(params, *ins)
    for g, k, x, name in zip(got, kernel, xla, ("pm", "ps", "pe", "pa")):
        np.testing.assert_allclose(g.numpy(), np.asarray(k), **STACK_TOL, err_msg=name)
        np.testing.assert_allclose(g.numpy(), np.asarray(x), **STACK_TOL, err_msg=name)


def test_stack_query_without_valid_word_matches_xla():
    """-1e9 (not -inf) masking: a query with no valid word gives a uniform
    word softmax, finite outputs, and the packed XLA path's values."""
    params, model = _model(3)
    ins = _inputs(seed=5, empty_query=True)
    got = _torch_stack(model, *ins)
    for g, x in zip(got, _jax_xla_stack(params, *ins)):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(x), **STACK_TOL)


def test_proposal_features_packed_matches_jax():
    f, _, _, _, lmask = _inputs(seed=2)
    got = proposal_features_packed(torch.from_numpy(f), torch.from_numpy(lmask), CFG.L, CFG.C)
    want = j_proposal(jnp.asarray(f), jnp.asarray(lmask), CFG.L, CFG.C)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("layer", [0, 2])
def test_smi_block_units_match_jax(layer):
    """cu, mu and bu of one SMI block (content, moment, boundary units)."""
    params, model = _model(11)
    f, fw, fs, qmask, lmask = _inputs(seed=4)
    fc, fm, fb = j_proposal(jnp.asarray(f), jnp.asarray(lmask), CFG.L, CFG.C)
    vmask = j_packed_valid_mask(jnp.asarray(lmask))
    want = jsmin.smi_block_packed(params["smi"][layer], fc, fm, fb, fw, fs, qmask, lmask,
                                  vmask, CFG.L)
    t = lambda a: torch.from_numpy(np.array(a))   # noqa: E731
    with torch.no_grad():
        got = tsmin.smi_block_packed(model.smis[layer], t(fc), t(fm), t(fb), t(fw), t(fs),
                                     t(qmask), t(lmask), t(vmask), CFG.L)
    for g, w, name in zip(got, want, ("cu", "mu", "bu")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **BLOCK_TOL, err_msg=name)


def test_stack_wrapper_rejects_other_devices():
    _, model = _model(0)
    ins = [torch.from_numpy(a).to("meta") for a in _inputs()]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        smin_cuda.smin_stack_fused(model, CFG, *ins, packed_valid_mask(ins[4]))


@pytest.mark.parametrize("grouped", [False, True])
def test_backbone_matches_jax(grouped):
    """Video encoder, query encoder (last valid forward state, backward
    state at t=0, through the CPU route of the K5 wrapper) and the Hadamard
    fusion; grouped encodes unique videos once and gathers them to pairs."""
    params, model = _model(13)
    rng = np.random.default_rng(6)
    B, Nq = 4, CFG.max_query_length
    vf = rng.standard_normal((B, CFG.T, CFG.input_video_dim)).astype(np.float32)
    vm = np.ones((B, CFG.T, 1), np.float32)
    vm[1, 5:] = 0
    vidx = np.array([0, 1, 0, 1])
    if grouped:
        vf, vm = vf[vidx], vm[vidx]
    qf = rng.standard_normal((B, Nq, CFG.word_dim)).astype(np.float32)
    qm = (np.arange(Nq)[None, :] < np.array([[1], [Nq], [3], [0]])).astype(np.float32)[..., None]
    want = jsmin.backbone(params, JCFG, vf, vm, qf, qm)
    t = torch.from_numpy
    video = (None, None) if grouped else (t(vf), t(vm))
    group = (t(vf[:2]), t(vm[:2]), t(vidx)) if grouped else None
    with torch.no_grad():
        got = tsmin.backbone(model.backbone, CFG, *video, t(qf), t(qm), video_group=group)
    for g, w, name in zip(got, want, ("f", "fs", "fw")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5, err_msg=name)

"""The reference-compat modes of the port against the JAX package, from
shared weights and numpy inputs on the CPU:

* K10's function: `ops.content_cuda.content_unit_fused` (its plain version
  and plain backward through the autograd Function) vs the JAX
  `content_unit_fused(..., interpret=True)` and its custom VJP, at
  tests/test_content_pallas.py's tolerances (forward rtol / atol 2e-5,
  gradients rtol 1e-4 / atol 1e-5);
* the K9 route (``VML_SMIN_TRAIN_FUSED_FWD=1``): the stack's outputs and
  every gradient equal to the per-layer route's at the JAX test's rtol 1e-5
  / atol 1e-7 (tests/test_smin_train_pallas.py::
  test_fused_fwd_stack_matches_per_layer), through the K9 entry and no K2,
  and against the JAX package's fused-forward stack in interpret mode;
* ``compat_head`` with ``fused_content``: the forward (dense pm), the loss
  and every gradient, three Adam steps and an eval step vs the JAX package;
* `MomentLocalizer` in the compat and dense modes vs the JAX localizer:
  the same top-k, ties to the lower flat index.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_moment_localization_tpu.data.glove import WordEmbedding as JaxWordEmbedding
from video_moment_localization_tpu.inference import MomentLocalizer as JaxLocalizer
from video_moment_localization_tpu.models import smin as jsmin
from video_moment_localization_tpu.ops.content_pallas import content_unit_fused as j_fused
from video_moment_localization_tpu.ops.smin_train_pallas import smin_smi_stack_train
from video_moment_localization_tpu_torch.data.glove import WordEmbedding
from video_moment_localization_tpu_torch.inference import MomentLocalizer
from video_moment_localization_tpu_torch.models import smin
from video_moment_localization_tpu_torch.ops import content_cuda, smin_train_cuda

from _torch_train_common import (
    CFG,
    FORWARD_KEYS,
    JCFG,
    SHAPE,
    assert_loss_and_gradients_match_jax,
    assert_steps_match_jax,
    jax_stack_grads,
    make_batch,
    make_model,
    mode_configs,
    readout,
    to_torch,
    torch_stack_grads,
)

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
UNIT_GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
STACK_GRAD_TOL = dict(rtol=5e-4, atol=5e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-5)
JCFG_C, CFG_C = mode_configs("compat")
N = CFG.L * (CFG.L + 1) // 2
UNIT_NAMES = ("fc", "fw", "fs", "fm")


def _unit_inputs(B=3, seed=0):
    """Numpy content-unit inputs: a ragged query, one query of one word and
    a short video (its invalid pairs masked)."""
    rng = np.random.default_rng(seed)
    Nq, D, C = CFG.max_query_length, CFG.D, CFG.C
    fc = rng.standard_normal((B, N, C, D)).astype(np.float32)
    fw = rng.standard_normal((B, Nq, D)).astype(np.float32)
    fs = rng.standard_normal((B, D)).astype(np.float32)
    fm = rng.standard_normal((B, N, D)).astype(np.float32)
    qmask = np.ones((B, Nq, 1), np.float32)
    qmask[0, 3:] = 0
    qmask[2, 1:] = 0
    vmask = np.ones((B, N), np.float32)
    vmask[1, N // 2:] = 0
    return dict(fc=fc, fw=fw, fs=fs, fm=fm, qmask=qmask, vmask=vmask)


@pytest.mark.parametrize("layer", [0, 1])
def test_k10_forward_and_gradients_match_jax_kernel(layer):
    params, model = make_model(6)
    ins = _unit_inputs(seed=layer)
    p = params["smi"][layer]["content"]
    qmask, vmask = jnp.asarray(ins["qmask"]), jnp.asarray(ins["vmask"])

    def jfn(p_, fc, fw, fs, fm):
        return j_fused(p_, fc, fw, fs, fm, qmask, vmask, True)

    @jax.jit
    def value_and_vjp(args, dcu):
        out, vjp = jax.vjp(jfn, *args)
        return out, vjp(dcu)

    dcu = np.random.default_rng(9).standard_normal(ins["fc"].shape).astype(np.float32)
    want, gwant = value_and_vjp((p, *(jnp.asarray(ins[k]) for k in UNIT_NAMES)),
                                jnp.asarray(dcu))

    unit = model.smis[layer].content_unit
    t = {k: torch.from_numpy(v).requires_grad_(k in UNIT_NAMES) for k, v in ins.items()}
    before = (content_cuda.content_unit_forward.launches,
              content_cuda.content_unit_backward.launches)
    got = content_cuda.content_unit_fused(unit, t["fc"], t["fw"], t["fs"], t["fm"], t["qmask"],
                                          t["vmask"])
    weights = content_cuda.unit_weights(unit)
    grads = torch.autograd.grad(got, [t[k] for k in UNIT_NAMES] + weights, torch.from_numpy(dcu))
    assert (content_cuda.content_unit_forward.launches,
            content_cuda.content_unit_backward.launches) == before   # CPU: plain versions

    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD_TOL)
    for g, w, name in zip(grads, gwant[1:], UNIT_NAMES):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **UNIT_GRAD_TOL, err_msg=name)
    # The weight gradients, through the weight bridge (JAX (in, out) layout).
    jw = gwant[0]
    for g, (unit_name, key) in zip(grads[4:][::2], (
            ("c_hat", "w"), ("w_hat", "w"), ("s_hat", "w"), ("c_out", "w"),
            ("attn_q", "w"), ("attn_k", "w"))):
        np.testing.assert_allclose(g.numpy(), np.asarray(jw[unit_name][key]).T,
                                   **UNIT_GRAD_TOL, err_msg=unit_name)
    for g, unit_name in zip(grads[5:][::2], ("c_hat", "w_hat", "s_hat", "c_out", "attn_q",
                                              "attn_k")):
        np.testing.assert_allclose(g.numpy(), np.asarray(jw[unit_name]["b"]),
                                   **UNIT_GRAD_TOL, err_msg=unit_name + " bias")
    # An invalid pair carries fc + fbar: the mask multiplies f_cc only.
    fbar = smin.moment_gate(t["fm"], t["fs"]).detach()
    bad = t["vmask"] == 0
    torch.testing.assert_close(got.detach()[bad], (t["fc"].detach() + fbar[:, :, None])[bad])


def test_k10_plain_backward_and_wrapper_guards():
    _, model = make_model(2)
    ins = _unit_inputs(seed=4)
    t = {k: torch.from_numpy(v) for k, v in ins.items()}
    weights = [w.detach() for w in content_cuda.unit_weights(model.smis[0].content_unit)]
    args = (t["fc"], t["fm"], t["fw"], t["fs"], t["qmask"], t["vmask"])
    dcu = torch.randn(t["fc"].shape, generator=torch.Generator().manual_seed(0))
    got = content_cuda.content_unit_backward(weights, *args, dcu)
    leaves = [a.clone().requires_grad_(True) for a in args[:4]] + [
        w.clone().requires_grad_(True) for w in weights]
    cu = content_cuda.content_unit_forward(leaves[4:], *leaves[:4], t["qmask"], t["vmask"])
    want = torch.autograd.grad(cu, leaves, dcu)
    for g, w in zip(list(got[:4]) + got[4], want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        content_cuda.content_unit_forward(weights, *meta)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        content_cuda.content_unit_backward(weights, *meta, dcu.to("meta"))


def _stack_inputs(seed=3):
    """Layer inputs of the JAX fused-forward test's kind: random f through
    the proposal, a ragged query, a short video."""
    from video_moment_localization_tpu.ops.packing import packed_valid_mask
    from video_moment_localization_tpu.ops.proposal import proposal_features_packed

    rng = np.random.default_rng(seed)
    B, Nq = 4, CFG.max_query_length
    f = rng.standard_normal((B, CFG.T, CFG.D)).astype(np.float32)
    fw = rng.standard_normal((B, Nq, CFG.D)).astype(np.float32)
    fs = rng.standard_normal((B, CFG.D)).astype(np.float32)
    qmask = np.ones((B, Nq, 1), np.float32)
    qmask[0, 3:] = 0
    lmask = np.ones((B, CFG.L), np.float32)
    lmask[1, CFG.L // 2:] = 0
    fc, fm, fb = (np.asarray(a) for a in proposal_features_packed(
        jnp.asarray(f), jnp.asarray(lmask), CFG.L, CFG.C))
    vmask = np.asarray(packed_valid_mask(jnp.asarray(lmask)))
    return dict(fc=fc, fm=fm, fb=fb, fw=fw * qmask, fs=fs, qmask=qmask, lmask=lmask,
                vmask=vmask)


def test_k9_route_matches_the_per_layer_route(monkeypatch):
    """``VML_SMIN_TRAIN_FUSED_FWD=1`` sends the stack's forward through the
    K9 entry (read at call time) and no K2; outputs and every gradient equal
    the per-layer route's (the JAX test's rtol 1e-5 / atol 1e-7), and the
    saved carries are those the per-layer forward saves."""
    _, model = make_model(2)
    ins = _stack_inputs()
    wm, wb = readout(CFG, 4, 11)
    calls = []
    for fn in ("smi_stack_forward", "smi_layer_forward"):
        real = getattr(smin_train_cuda, fn)
        monkeypatch.setattr(smin_train_cuda, fn,
                            lambda *a, _real=real, _fn=fn, **k: (calls.append(_fn),
                                                                  _real(*a, **k))[1])
    runs = {}
    for flag in ("0", "1"):
        monkeypatch.setenv("VML_SMIN_TRAIN_FUSED_FWD", flag)
        del calls[:]
        runs[flag] = torch_stack_grads(smin_train_cuda.smi_stack_layers, model, CFG, ins, wm, wb)
        want = (["smi_stack_forward"] if flag == "1"
                else ["smi_layer_forward"] * CFG.num_smi_layers)
        assert calls == want
    for a, b in zip(runs["0"][:2], runs["1"][:2]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5, atol=1e-7)
    for name, g in runs["0"][2].items():
        np.testing.assert_allclose(runs["1"][2][name].numpy(), g.numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=name)


def test_k9_plain_returns_every_layers_carry():
    _, model = make_model(3)
    t = {k: torch.from_numpy(v.copy()) for k, v in _stack_inputs(seed=5).items()}
    weights = [w.detach() for b in model.smis for w in smin.block_weights(b)]
    shared = (t["fw"], t["fs"], t["qmask"], t["lmask"], t["vmask"])
    fm, fb, carries = smin_train_cuda.smi_stack_forward(weights, t["fc"], t["fm"], t["fb"],
                                                        *shared, CFG.L)
    assert len(carries) == CFG.num_smi_layers
    assert all(torch.equal(a, b) for a, b in zip(carries[0], (t["fc"], t["fm"], t["fb"])))
    want = smin_train_cuda.smi_layer_plain(weights[:20], t["fc"], t["fm"], t["fb"], *shared,
                                           CFG.L)
    for a, b in zip(carries[1], want):
        assert torch.equal(a, b)
    last = smin_train_cuda.smi_layer_plain(weights[20:], *carries[1], *shared, CFG.L)
    assert torch.equal(fm, last[1]) and torch.equal(fb, last[2])
    with pytest.raises(ValueError, match="CPU or CUDA"):
        smin_train_cuda.smi_stack_forward(
            weights, *(x.to("meta") for x in (t["fc"], t["fm"], t["fb"], *shared)), CFG.L)


def test_k9_route_matches_jax_fused_forward_stack(monkeypatch):
    """Against the JAX package's stack with its all-layers forward kernel
    (interpret mode) under the same variable; every query keeps two or more
    valid words (tests/test_torch_smin_train.py says why)."""
    monkeypatch.setenv("VML_SMIN_TRAIN_FUSED_FWD", "1")
    params, model = make_model(2)
    ins = _stack_inputs()
    wm, wb = readout(CFG, 4, 11)

    def kernel_stack(p, fc, fm, fb, fw, fs):
        return smin_smi_stack_train(p, JCFG, fc, fm, fb, fw, fs, jnp.asarray(ins["qmask"]),
                                    jnp.asarray(ins["lmask"]), jnp.asarray(ins["vmask"]),
                                    interpret=True)

    got = torch_stack_grads(smin_train_cuda.smi_stack_layers, model, CFG, ins, wm, wb)
    want = jax_stack_grads(kernel_stack, params, ins, wm, wb)
    vm3, lm3 = ins["vmask"][..., None], ins["lmask"][..., None]
    np.testing.assert_allclose(got[0].numpy() * vm3, want[0] * vm3, **FWD_TOL)
    np.testing.assert_allclose(got[1].numpy() * lm3, want[1] * lm3, **FWD_TOL)
    for name, w in want[2].items():
        np.testing.assert_allclose(got[2][name].numpy(), w, **STACK_GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("inference", [False, True])
def test_compat_forward_matches_jax(inference):
    params, model = make_model(8)
    batch = make_batch(B=4, seed=3, packed_labels=False)
    want = jax.jit(lambda p, *a: jsmin.smin_forward(p, JCFG_C, *a))(
        params, *(jnp.asarray(batch[k]) for k in FORWARD_KEYS))
    tb = to_torch(batch)
    run = smin.smin_forward_inference if inference else smin.smin_forward
    with torch.no_grad():
        got = run(model, CFG_C, *(tb[k] for k in FORWARD_KEYS))
    assert tuple(got[0].shape) == (4, CFG.L, CFG.L)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **MODEL_TOL)


def test_compat_routes_through_the_unit_loop(monkeypatch):
    """compat_head + fused_content: K6 and `content_unit_fused` per layer,
    neither whole-layer stack."""
    from video_moment_localization_tpu_torch.ops import content_train_cuda, proposal_cuda

    called = []
    for module, fn in ((smin_train_cuda, "smi_stack_layers"),
                       (content_train_cuda, "smi_stack_content_train"),
                       (content_cuda, "content_unit_fused"),
                       (proposal_cuda, "proposal_features_packed_fused")):
        real = getattr(module, fn)
        monkeypatch.setattr(module, fn, lambda *a, _real=real, _fn=fn: (called.append(_fn),
                                                                         _real(*a))[1])
    _, model = make_model(1)
    tb = to_torch(make_batch(B=2, seed=0, packed_labels=False))
    with torch.no_grad():
        smin.smin_forward(model, CFG_C, *(tb[k] for k in FORWARD_KEYS))
    assert called == (["proposal_features_packed_fused"]
                      + ["content_unit_fused"] * CFG.num_smi_layers)


@pytest.mark.parametrize("seed", [0, 1])
def test_compat_loss_and_every_gradient_match_jax(seed):
    params, model = make_model(50 + seed)
    assert_loss_and_gradients_match_jax(JCFG_C, CFG_C, params, model,
                                        make_batch(B=4, seed=seed, packed_labels=False))


def test_three_compat_train_steps_and_eval_step_match_jax():
    params, model = make_model(51)
    before = (content_cuda.content_unit_forward.launches,
              content_cuda.content_unit_backward.launches)
    batches = [make_batch(B=4, seed=30 + k, packed_labels=False) for k in range(3)]
    assert_steps_match_jax(JCFG_C, CFG_C, params, model, batches)
    assert (content_cuda.content_unit_forward.launches,
            content_cuda.content_unit_backward.launches) == before   # CPU: plain versions


WORDS = ["person", "opens", "the", "door", "sits", "down", "a", "cup"]
QUERIES = ["person opens the door", "someone sits down", "a cup", "the door"]


@pytest.mark.parametrize("use_nms", [False, True])
@pytest.mark.parametrize("mode", ["compat", "dense"])
def test_localizer_matches_jax(mode, use_nms):
    jcfg, cfg = mode_configs(mode)
    params, model = make_model(5)
    jloc = JaxLocalizer(jcfg, params, JaxWordEmbedding.synthetic(WORDS, dim=300, seed=1),
                        serve_batch=4, use_nms=use_nms)
    tloc = MomentLocalizer(cfg, model, WordEmbedding.synthetic(WORDS, dim=300, seed=1),
                           serve_batch=4, use_nms=use_nms, device="cpu")
    rng = np.random.default_rng(4)
    vids = [rng.standard_normal((int(n), SHAPE["input_video_dim"])).astype(np.float32)
            for n in (5, 16, 40)]
    # Six rows on three videos (a bucket of 4 and one of 2; the second
    # chunk's repeated video takes the grouped path); the 5-frame video has
    # fewer than k valid moments: zero-score ties in flat-index order.
    reqs = [(vids[k % 3], QUERIES[k % 4], 12.0 + k) for k in range(4)]
    reqs += [(vids[0], QUERIES[1], 9.0), (vids[0], QUERIES[2], 9.0)]
    got, want = tloc.localize_batch(reqs, top_k=6), jloc.localize_batch(reqs, top_k=6)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [(m.start, m.end) for m in g] == [(m.start, m.end) for m in w]
        np.testing.assert_allclose([m.score for m in g], [m.score for m in w], rtol=0,
                                   atol=1e-5)

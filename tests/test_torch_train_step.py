"""The train slice of the port as a whole against the JAX package, from
shared weights on the CPU:

(a) the loss and every parameter's gradient of `smin_forward` + `smin_loss`
    vs jax.value_and_grad of the JAX `smin_forward` (gradients: the train
    kernel tests' rtol 5e-4 / atol 5e-5);
(b) Adam alone: the same gradients fed to `build_optimizer`'s
    torch.optim.Adam and to optax.adam give the same parameters;
(c) three full steps of `make_train_step` vs the JAX `make_train_step`: the
    loss sequence and the recall counts; and `make_eval_step` vs the JAX one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from video_moment_localization_tpu.models import smin_forward as j_smin_forward
from video_moment_localization_tpu.parallel import steps as jsteps
from video_moment_localization_tpu.train.loss import smin_loss as j_smin_loss
from video_moment_localization_tpu_torch.config import Config
from video_moment_localization_tpu_torch.models.port import state_dict_from_jax_params
from video_moment_localization_tpu_torch.models.smin import smin_forward
from video_moment_localization_tpu_torch.ops import proposal_cuda, smin_train_cuda
from video_moment_localization_tpu_torch.parallel.steps import (
    build_optimizer,
    make_eval_step,
    make_train_step,
)
from video_moment_localization_tpu_torch.train.loss import smin_loss

from _torch_train_common import CFG, JCFG, make_batch, make_model, to_torch

GRAD_TOL = dict(rtol=5e-4, atol=5e-5)
FORWARD_KEYS = ("video_features", "video_mask", "query_features", "query_mask", "length_mask")
EXPERIMENT = Config(model=CFG)


def _jax_loss(params, jbatch):
    outputs = j_smin_forward(params, JCFG, *(jbatch[k] for k in FORWARD_KEYS), None)
    return j_smin_loss(outputs, jbatch)[0]


@pytest.mark.parametrize("seed", [0, 1])
def test_loss_and_every_parameter_gradient_match_jax(seed):
    params, model = make_model(20 + seed)
    batch = make_batch(B=4, seed=seed)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want, gwant = jax.value_and_grad(_jax_loss)(params, jbatch)

    tb = to_torch(batch)
    loss, _ = smin_loss(smin_forward(model, CFG, *(tb[k] for k in FORWARD_KEYS)), tb)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    sd = state_dict_from_jax_params(jax.tree.map(np.asarray, gwant))
    named = dict(model.named_parameters())
    assert set(sd) == set(named)
    for name, p in named.items():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        np.testing.assert_allclose(p.grad.numpy(), sd[name].numpy(), **GRAD_TOL, err_msg=name)


def test_adam_update_equals_optax_on_the_same_gradients():
    """Three updates from identical gradient sequences: the optimizers'
    arithmetic alone. fp32 elementwise math: rtol 1e-6 / atol 1e-7."""
    params, model = make_model(3)
    rng = np.random.default_rng(0)
    opt = build_optimizer(EXPERIMENT, model)
    assert opt.defaults["lr"] == EXPERIMENT.lr == 5e-4
    jopt = optax.adam(EXPERIMENT.lr)
    state = jopt.init(params)
    for _ in range(3):
        grads = jax.tree.map(
            lambda p: (rng.standard_normal(p.shape) * 10.0 ** rng.uniform(-6, 0))
            .astype(np.float32), params)
        updates, state = jopt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        sd = state_dict_from_jax_params(grads)
        for name, p in model.named_parameters():
            p.grad = sd[name].clone()
        opt.step()
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, params))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=name)


def test_three_train_steps_and_eval_step_match_jax():
    """Loss after each of three Adam steps. Tolerance rtol 2e-4: Adam's first
    update is about lr * g / (|g| + 1e-8), which turns rounding noise in a
    near-zero gradient into a full +-lr step of that weight, so the
    parameters (and the later losses) agree only to a few 1e-5 relative;
    the first loss, before any update, agrees to 1e-5."""
    params, model = make_model(31)
    batches = [make_batch(B=4, seed=10 + k) for k in range(3)]
    jopt = optax.adam(EXPERIMENT.lr)
    jstep = jsteps.make_train_step(JCFG, jopt)
    jparams = jax.tree.map(jnp.asarray, params)
    state = jopt.init(jparams)
    want = []
    for b in batches:
        jparams, state, metrics = jstep(jparams, state, {k: jnp.asarray(v) for k, v in b.items()})
        want.append((float(metrics["loss"]), np.asarray(metrics["counts"])))

    launches = (proposal_cuda.proposal_rows_forward.launches,
                smin_train_cuda.smi_layer_backward.launches)
    step = make_train_step(CFG, model, build_optimizer(EXPERIMENT, model), device="cpu")
    got = [step(to_torch(b)) for b in batches]
    assert launches == (proposal_cuda.proposal_rows_forward.launches,
                        smin_train_cuda.smi_layer_backward.launches)   # CPU: plain versions
    assert isinstance(got[0]["loss"], torch.Tensor) and got[0]["loss"].dim() == 0
    np.testing.assert_allclose(float(got[0]["loss"]), want[0][0], rtol=1e-5)
    np.testing.assert_allclose([float(g["loss"]) for g in got], [w[0] for w in want], rtol=2e-4)
    np.testing.assert_array_equal(got[0]["counts"].numpy(), want[0][1])
    assert want[2][0] < want[0][0] or want[1][0] != want[0][0]   # the steps did move the loss

    # Eval through the serving forward on the updated weights of each side.
    jeval = jsteps.make_eval_step(JCFG)(jparams, {k: jnp.asarray(v) for k, v in
                                                  batches[0].items()})
    teval = make_eval_step(CFG, model, device="cpu")(to_torch(batches[0]))
    np.testing.assert_allclose(float(teval["loss"]), float(jeval["loss"]), rtol=2e-4)
    assert teval["counts"].shape == (2, 4)


def test_train_step_updates_every_parameter_and_padded_sample_has_no_weight():
    _, model = make_model(2)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = make_train_step(CFG, model, build_optimizer(EXPERIMENT, model), device="cpu")
    batch = make_batch(B=4, seed=5)
    loss = float(step(to_torch(batch))["loss"])
    for n, p in model.named_parameters():
        # A key-projection bias shifts every logit of a softmax row alike: its
        # gradient is structurally zero and Adam leaves it (nearly) in place.
        if not n.endswith("attn_layer.W_k.bias"):
            assert not torch.equal(p.detach(), before[n]), n
    # The padded last sample (sample_mask 0) does not enter the loss.
    _, model2 = make_model(2)
    batch["video_features"][-1] = 7.0
    step2 = make_train_step(CFG, model2, build_optimizer(EXPERIMENT, model2), device="cpu")
    assert float(step2(to_torch(batch))["loss"]) == pytest.approx(loss, rel=1e-6)

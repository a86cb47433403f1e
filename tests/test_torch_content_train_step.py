"""The content-unit train slice of the port as a whole against the JAX
package, from shared weights on the CPU, and the routing that selects it.

The routing copies the JAX package's admission rule
(`smin_train_pallas.supports_train`): Charades trains through the whole-layer
kernels, TACoS at fp32 and ActivityNet through the content-unit kernels. The
step test uses a narrow config whose map (L=32, C=9: N * C = 4752 clip rows)
is over that rule's row cap, so `smin_forward` takes the content-unit route
by itself: the loss, every parameter's gradient and the weights after one
Adam step vs the JAX `make_train_step` (tolerances of
tests/test_torch_train_step.py: gradients rtol 5e-4 / atol 5e-5, the first
loss rtol 1e-5)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from video_moment_localization_tpu.config import load_config as j_load_config
from video_moment_localization_tpu.models import smin_forward as j_smin_forward
from video_moment_localization_tpu.ops import smin_train_pallas
from video_moment_localization_tpu.parallel import steps as jsteps
from video_moment_localization_tpu.train.loss import smin_loss as j_smin_loss
from video_moment_localization_tpu_torch.config import Config, ModelConfig, load_config
from video_moment_localization_tpu_torch.models import smin
from video_moment_localization_tpu_torch.models.port import state_dict_from_jax_params
from video_moment_localization_tpu_torch.ops import content_train_cuda, smin_train_cuda
from video_moment_localization_tpu_torch.parallel.steps import build_optimizer, make_train_step
from video_moment_localization_tpu_torch.train.loss import smin_loss

from _torch_train_common import JaxModelConfig, make_batch, make_model, to_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = dict(T=32, L=32, C=9, D=16, dl=8, num_smi_layers=2, input_video_dim=6,
             max_query_length=4, lstm_hidden_size=8)
JCFG, CFG = JaxModelConfig(**SHAPE), ModelConfig(**SHAPE)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)
FORWARD_KEYS = ("video_features", "video_mask", "query_features", "query_mask", "length_mask")


@pytest.mark.parametrize("name,whole_layer", [("charadessta", True), ("tacos", False),
                                              ("activitynet", False)])
def test_shipped_configs_take_the_jax_route(name, whole_layer):
    path = os.path.join(REPO, "config", f"{name}.yml")
    cfg = load_config(path).model
    assert smin.whole_layer_train_admits(cfg) is whole_layer
    assert smin_train_pallas.supports_train(j_load_config(path).model) is whole_layer
    smin.check_dtype(cfg)
    # The JAX rule admits TACoS at bf16, and so the port trains it there on
    # the whole-layer route; ActivityNet trains at bf16 on the content-unit
    # route (K6-bf16, K7-bf16).
    bf16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    assert smin.whole_layer_train_admits(bf16) is (name != "activitynet")
    smin.check_dtype(bf16)


def test_forward_routes_by_the_rule(monkeypatch):
    """`smin_forward` calls the stack the rule names, and no other."""
    called = []
    for module, fn in ((smin_train_cuda, "smi_stack_layers"),
                       (content_train_cuda, "smi_stack_content_train")):
        real = getattr(module, fn)
        monkeypatch.setattr(module, fn, lambda *a, _real=real, _fn=fn: (called.append(_fn),
                                                                         _real(*a))[1])
    assert not smin.whole_layer_train_admits(CFG)
    for shape, want in ((SHAPE, "smi_stack_content_train"),
                        (dict(SHAPE, L=8, T=16, C=4), "smi_stack_layers")):
        cfg = ModelConfig(**shape)
        _, model = make_model(0, shape)
        tb = to_torch(make_batch(B=2, seed=0, cfg=cfg))
        del called[:]
        with torch.no_grad():
            smin.smin_forward(model, cfg, *(tb[k] for k in FORWARD_KEYS))
        assert called == [want]


def test_loss_gradients_and_adam_step_match_jax():
    params, model = make_model(23, SHAPE)
    batch = make_batch(B=2, seed=4, cfg=CFG)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def jax_loss(p):
        outputs = j_smin_forward(p, JCFG, *(jbatch[k] for k in FORWARD_KEYS), None)
        return j_smin_loss(outputs, jbatch)[0]

    want, gwant = jax.value_and_grad(jax_loss)(params)
    experiment = Config(model=CFG)
    jopt = optax.adam(experiment.lr)
    jparams = jax.tree.map(jnp.asarray, params)
    jparams, _, jmetrics = jsteps.make_train_step(JCFG, jopt)(jparams, jopt.init(jparams), jbatch)

    tb = to_torch(batch)
    loss, _ = smin_loss(smin.smin_forward(model, CFG, *(tb[k] for k in FORWARD_KEYS)), tb)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    sd = state_dict_from_jax_params(jax.tree.map(np.asarray, gwant))
    named = dict(model.named_parameters())
    assert set(sd) == set(named)
    for name, p in named.items():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        np.testing.assert_allclose(p.grad.numpy(), sd[name].numpy(), **GRAD_TOL, err_msg=name)

    before = (content_train_cuda.content_rows_forward.launches,
              content_train_cuda.content_rows_backward.launches)
    step = make_train_step(CFG, model, build_optimizer(experiment, model), device="cpu")
    got = step(tb)
    assert before == (content_train_cuda.content_rows_forward.launches,
                      content_train_cuda.content_rows_backward.launches)  # CPU: plain versions
    np.testing.assert_allclose(float(got["loss"]), float(jmetrics["loss"]), rtol=1e-5)
    np.testing.assert_array_equal(got["counts"].numpy(), np.asarray(jmetrics["counts"]))
    # One Adam step moves a weight by about lr * g / (|g| + 1e-8): rounding
    # noise in a near-zero gradient becomes up to a full +-lr of that weight.
    after = state_dict_from_jax_params(jax.tree.map(np.asarray, jparams))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), after[name].numpy(), rtol=1e-5,
                                   atol=2 * experiment.lr, err_msg=name)


def test_train_step_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    _, model = make_model(0, SHAPE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(CFG, model, build_optimizer(Config(model=CFG), model))

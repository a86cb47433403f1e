"""Shared pieces of the sequence-parallel tests of the PyTorch port
(tests/test_torch_seq_*.py): the small widths of tests/test_seq_packed.py
and tests/test_model_parallel.py in both packages, seeded NumPy batches,
the spawn of the port's gloo ranks (tests/_torch_seq_workers.py) and the
JAX side on a mesh of the 8 virtual CPU devices."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
from jax.sharding import Mesh

import _torch_seq_workers
from _torch_train_common import make_batch
from video_moment_localization_tpu.config import ModelConfig as JaxModelConfig
from video_moment_localization_tpu.models import init_smin_params
from video_moment_localization_tpu.parallel import model_parallel as jmp
from video_moment_localization_tpu.train.loss import smin_loss as j_smin_loss
from video_moment_localization_tpu_torch.config import ModelConfig
from video_moment_localization_tpu_torch.models.port import state_dict_from_jax_params
from video_moment_localization_tpu_torch.parallel import mesh

# tests/test_seq_packed.py's widths (packed) and tests/test_model_parallel.py's
# (dense: T=32).
PACKED = dict(T=16, L=8, C=4, D=32, dl=8, num_smi_layers=2, input_video_dim=12,
              max_query_length=6, lstm_hidden_size=16)
DENSE = dict(PACKED, T=32, packed=False)
COMPAT = dict(PACKED, compat_head=True)
LR = 1e-3
TIMEOUT_S = 240
# tests/test_seq_packed.py:97 (packed) and tests/test_train_2d.py:63 (dense).
PARAM_TOL = {"packed": dict(rtol=3e-4, atol=3e-5), "dense": dict(rtol=5e-4, atol=5e-5)}


def configs(shape):
    """(JAX ModelConfig, port ModelConfig) of a shape."""
    return JaxModelConfig(**shape, use_pallas=False), ModelConfig(**shape)


def init(shape, seed):
    """(JAX params as NumPy, the port's state_dict of the same weights)."""
    params = jax.tree.map(np.asarray, init_smin_params(jax.random.PRNGKey(seed),
                                                       configs(shape)[0]))
    return params, state_dict_from_jax_params(params)


def batch(shape, B, seed):
    """A seeded NumPy batch at ``shape``: packed labels on the packed
    layout, dense labels and the moment mask on the dense one and under
    ``compat_head`` (tests/_torch_train_common.py's `make_batch`)."""
    cfg = ModelConfig(**shape)
    return make_batch(B=B, seed=seed, cfg=cfg, packed_labels=cfg.packed and not cfg.compat_head)


def spawn(tmp_path, world, cases):
    """The cases on ``world`` gloo ranks on the CPU; each rank's results."""
    pattern = str(tmp_path / "rank%d.pt")
    mesh.spawn(_torch_seq_workers.run_cases, world, ["cpu"] * world, "gloo",
               args=(cases, pattern), timeout_s=TIMEOUT_S)
    return [torch.load(pattern % r, weights_only=False) for r in range(world)]


def seq_mesh(n):
    """The JAX package's 1-D ``seq`` mesh of n devices."""
    return Mesh(np.asarray(jax.devices()[:n]), ("seq",))


def jax_2d(shape, params, batches, nd, seq, evaluate=False):
    """The JAX 2-D train step (`make_train_step_2d`, optax Adam at LR) over
    ``batches`` on an (nd x seq) mesh: each step's loss and counts, the
    parameters after the last step, the step-1 gradients (of the same loss,
    `_seq_forward` + `smin_loss`) under the port's names, and with
    ``evaluate`` `make_eval_step_2d` on the first batch before the steps."""
    jcfg = configs(shape)[0]
    mesh2 = Mesh(np.asarray(jax.devices()[:nd * seq]).reshape(nd, seq), ("data", "seq"))
    put = [jmp.put_batch_2d(b, mesh2) for b in batches]
    out = {}
    if evaluate:
        ev = jmp.make_eval_step_2d(jcfg, mesh2)(jax.tree.map(jnp.asarray, params), put[0])
        out["eval"] = (float(ev["loss"]), np.asarray(ev["counts"]))

    def loss_fn(p, b):
        return j_smin_loss(jmp._seq_forward(jcfg, mesh2, p, b), b)[0]

    grads = jax.jit(jax.grad(loss_fn))(jax.tree.map(jnp.asarray, params), put[0])
    out["grads"] = state_dict_from_jax_params(jax.tree.map(np.asarray, grads))
    opt = optax.adam(LR)
    step = jmp.make_train_step_2d(jcfg, opt, mesh2)
    p = jax.tree.map(jnp.array, params)
    state = opt.init(p)
    out["loss"], out["counts"] = [], []
    for b in put:
        p, state, m = step(p, state, b)
        out["loss"].append(float(m["loss"]))
        out["counts"].append(np.asarray(m["counts"]))
    out["params"] = state_dict_from_jax_params(jax.tree.map(np.asarray, p))
    return out


def assert_grads(got, want, tol):
    assert set(got) == set(want)
    for name, g in got.items():
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), np.asarray(want[name]), **tol, err_msg=name)


def assert_equal_across_ranks(results, name):
    """Each step's parameters bit for bit rank 0's on every rank."""
    first = results[0][name]["params"]
    for r, res in enumerate(results[1:], 1):
        assert len(res[name]["params"]) == len(first)
        for step, (a, b) in enumerate(zip(first, res[name]["params"])):
            for key, p in a.items():
                assert torch.equal(p, b[key]), (name, r, step, key)

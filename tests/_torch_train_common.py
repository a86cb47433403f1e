"""Shared fixtures of the train-slice tests of the PyTorch port: a small
config in both packages, weights carried across, a seeded synthetic batch
built with the port's label generators, and the gradients of a masked
readout through an SMI stack of either package."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from video_moment_localization_tpu.config import ModelConfig as JaxModelConfig
from video_moment_localization_tpu.models import init_smin_params
from video_moment_localization_tpu_torch.config import ModelConfig
from video_moment_localization_tpu_torch.data import labels
from video_moment_localization_tpu_torch.models.port import state_dict_from_jax_params
from video_moment_localization_tpu_torch.models.smin import SMIN

SHAPE = dict(T=16, L=8, C=4, D=32, dl=16, num_smi_layers=2, input_video_dim=12,
             max_query_length=5, lstm_hidden_size=16)
JCFG, CFG = JaxModelConfig(**SHAPE), ModelConfig(**SHAPE)
N = CFG.L * (CFG.L + 1) // 2


def load_jax_native(timeout=120.0):
    """Load the JAX package's native library, retrying while another test
    worker builds it: that binding compiles in place, so a process that
    loads the file mid-build fails and would take the NumPy path for the
    rest of its life, and its batches would no longer equal the port's
    native ones bit for bit."""
    import time

    from video_moment_localization_tpu.data import native as jn

    deadline = time.time() + timeout
    while jn.get_lib() is None:
        if time.time() > deadline:
            raise RuntimeError("the JAX package's native library did not load")
        jn._tried = False
        time.sleep(0.5)


# The config of the trainer and CLI tests: tests/test_cli.py's TINY_CFG with a
# batch of 3, so that the fixtures' splits end in a padded batch.
TINY_CFG = """
model:              "SMIN"
checkpoint_path:    "{ckpt}"
resume_training:    {resume}
T:                  16
L:                  8
C:                  4
d:                  32
input_video_dim:    32
dl:                 8
max_query_length:   6
lstm_hidden_size:   16
num_smi_layers:     2
dataset:            "charadessta"
data_dir:           "{data}"
batch_size:         3
num_workers:        2
seed:               43
optimizer:          "Adam"
lr:                 0.001
num_epochs:         2
"""


def make_model(seed, shape=None):
    """(JAX params as numpy, the port's model with the same weights), at
    ``shape`` (keyword arguments of both packages' ModelConfig; default SHAPE)."""
    jcfg, cfg = (JCFG, CFG) if shape is None else (JaxModelConfig(**shape), ModelConfig(**shape))
    params = jax.tree.map(np.asarray, init_smin_params(jax.random.PRNGKey(seed), jcfg))
    model = SMIN(cfg)
    model.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return params, model


def make_batch(B=4, seed=0, cfg=CFG, packed_labels=True):
    """Numpy batch: ragged videos and queries, one query with a single valid
    word, random GT spans, the last sample padded (sample_mask 0). The IoU
    map and its labels are packed (B, N), or with ``packed_labels=False``
    dense (B, L, L) beside the ``moment_mask`` (the dense layout and
    ``compat_head``); the same draws either way."""
    rng = np.random.default_rng(seed)
    Nq, L, T = cfg.max_query_length, cfg.L, cfg.T
    nfeats = rng.integers(3, T + 1, size=B)
    nfeats[0] = T
    qlen = rng.integers(2, Nq + 1, size=B)
    qlen[1 % B] = 1
    batch = {k: [] for k in ("video_mask", "length_mask", "ym", "sm", "ys", "ss", "ye", "se",
                             "ya", "moment_mask")}
    for b in range(B):
        vm, lm, mm = labels.build_masks(int(nfeats[b]), T, L)
        duration = float(rng.uniform(5.0, 40.0))
        s = float(rng.uniform(0.0, 0.6 * duration))
        e = float(rng.uniform(s + 0.1 * duration, duration))
        sm = labels.iou_target_map(s, e, duration, L)
        if packed_labels:
            sm = labels.pack_triu(sm)
        batch["moment_mask"].append(mm)
        ss, se = labels.boundary_penalties(s, e, duration, L)
        batch["video_mask"].append(vm)
        batch["length_mask"].append(lm)
        batch["sm"].append(sm)
        batch["ym"].append((sm > 0.5).astype(np.float32))
        batch["ss"].append(ss)
        batch["ys"].append((ss > 0.5).astype(np.float32))
        batch["se"].append(se)
        batch["ye"].append((se > 0.5).astype(np.float32))
        batch["ya"].append(labels.snippet_labels(s, e, duration, L))
    batch = {k: np.stack(v) for k, v in batch.items()}
    if packed_labels:
        del batch["moment_mask"]
    batch["video_features"] = (rng.standard_normal((B, T, cfg.input_video_dim))
                               .astype(np.float32) * batch["video_mask"])
    qmask = (np.arange(Nq)[None, :] < qlen[:, None]).astype(np.float32)[..., None]
    batch["query_mask"] = qmask
    batch["query_features"] = (rng.standard_normal((B, Nq, cfg.word_dim)).astype(np.float32)
                               * qmask)
    sample_mask = np.ones(B, np.float32)
    sample_mask[-1] = 0.0
    batch["sample_mask"] = sample_mask
    return batch


def to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


ACTS = ("fc", "fm", "fb", "fw", "fs")


def readout(cfg, B, seed):
    """Random weights (wm (B, N, D), wb (B, L, D)) of a linear readout."""
    rng = np.random.default_rng(seed)
    n = cfg.L * (cfg.L + 1) // 2
    return (rng.standard_normal((B, n, cfg.D)).astype(np.float32),
            rng.standard_normal((B, cfg.L, cfg.D)).astype(np.float32))


def torch_stack_grads(stack_fn, model, cfg, ins, wm, wb):
    """Outputs of ``stack_fn(model.smis, fc, fm, fb, fw, fs, qmask, lmask,
    vmask, L)`` on the numpy inputs ``ins`` and the gradients of the masked
    readout w.r.t. ACTS and every parameter of the stack, by name."""
    B = ins["fc"].shape[0]
    t = {k: torch.from_numpy(v.copy()) for k, v in ins.items()}
    for k in ACTS:
        t[k].requires_grad_(True)
    model.zero_grad()
    fm_o, fb_o = stack_fn(model.smis, t["fc"], t["fm"], t["fb"], t["fw"], t["fs"], t["qmask"],
                          t["lmask"], t["vmask"], cfg.L)
    s = ((fm_o * torch.from_numpy(wm) * t["vmask"][..., None]).sum()
         + (fb_o * torch.from_numpy(wb) * t["lmask"][..., None]).sum()) / B
    s.backward()
    grads = {k: t[k].grad for k in ACTS}
    grads.update({n: p.grad for n, p in model.named_parameters() if n.startswith("smis.")})
    return fm_o.detach(), fb_o.detach(), grads


def jax_stack_grads(stack_fn, params, ins, wm, wb):
    """The same through ``stack_fn(params, fc, fm, fb, fw, fs)`` of the JAX
    package, the weight gradients under the port's parameter names."""
    B = ins["fc"].shape[0]
    vmask, lmask = jnp.asarray(ins["vmask"]), jnp.asarray(ins["lmask"])

    def scalar(p, fc, fm, fb, fw, fs):
        fm_o, fb_o = stack_fn(p, fc, fm, fb, fw, fs)
        s = (jnp.sum(fm_o * wm * vmask[..., None]) + jnp.sum(fb_o * wb * lmask[..., None])) / B
        return s, (fm_o, fb_o)

    args = (params, *(jnp.asarray(ins[k]) for k in ACTS))
    (_, outs), g = jax.value_and_grad(scalar, argnums=tuple(range(6)), has_aux=True)(*args)
    grads = dict(zip(ACTS, (np.asarray(a) for a in g[1:])))
    grads.update({n: v.numpy() for n, v in state_dict_from_jax_params(
        jax.tree.map(np.asarray, g[0])).items() if n.startswith("smis.")})
    return np.asarray(outs[0]), np.asarray(outs[1]), grads


# The reference-compat modes: the dense layout, and the packed unit loop with
# the dense head and the fused content unit.
MODES = {"dense": dict(packed=False), "compat": dict(compat_head=True, fused_content=True)}
FORWARD_KEYS = ("video_features", "video_mask", "query_features", "query_mask", "length_mask",
                "moment_mask")
# The train kernel tests' gradient tolerance.
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)


def mode_configs(mode, shape=None):
    """(JAX ModelConfig, port ModelConfig) of ``shape`` (default SHAPE) in a
    mode of MODES."""
    kw = dict(SHAPE if shape is None else shape, **MODES[mode])
    return JaxModelConfig(**kw), ModelConfig(**kw)


def assert_loss_and_gradients_match_jax(jcfg, cfg, params, model, batch):
    """The loss of the port's `smin_forward` + `smin_loss` and every
    parameter's gradient against jax.value_and_grad of the JAX package's,
    on one numpy batch."""
    from video_moment_localization_tpu.models import smin_forward as j_smin_forward
    from video_moment_localization_tpu.train.loss import smin_loss as j_smin_loss
    from video_moment_localization_tpu_torch.models.smin import smin_forward
    from video_moment_localization_tpu_torch.train.loss import smin_loss

    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(p):
        return j_smin_loss(j_smin_forward(p, jcfg, *(jbatch.get(k) for k in FORWARD_KEYS)),
                           jbatch)[0]

    want, gwant = jax.jit(jax.value_and_grad(jloss))(params)
    tb = to_torch(batch)
    model.zero_grad(set_to_none=True)
    loss, _ = smin_loss(smin_forward(model, cfg, *(tb.get(k) for k in FORWARD_KEYS)), tb)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    sd = state_dict_from_jax_params(jax.tree.map(np.asarray, gwant))
    named = dict(model.named_parameters())
    assert set(sd) == set(named)
    for name, p in named.items():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        np.testing.assert_allclose(p.grad.numpy(), sd[name].numpy(), **GRAD_TOL, err_msg=name)


def assert_steps_match_jax(jcfg, cfg, params, model, batches, lr=5e-4):
    """`make_train_step` on the CPU against the JAX `make_train_step` (optax
    Adam) over ``batches``: the first loss within 1e-5, the later ones within
    2e-4 (Adam turns rounding noise in a near-zero gradient into a full
    +-lr step), the first step's recall counts equal; then `make_eval_step`
    on the updated weights of each side: loss within 2e-4, counts of the
    first batch. Returns the port's step metrics."""
    import optax

    from video_moment_localization_tpu.parallel import steps as jsteps
    from video_moment_localization_tpu_torch.config import Config
    from video_moment_localization_tpu_torch.parallel.steps import (
        build_optimizer,
        make_eval_step,
        make_train_step,
    )

    jopt = optax.adam(lr)
    jstep = jsteps.make_train_step(jcfg, jopt)
    jparams = jax.tree.map(jnp.asarray, params)
    state = jopt.init(jparams)
    want = []
    for b in batches:
        jparams, state, metrics = jstep(jparams, state, {k: jnp.asarray(v) for k, v in b.items()})
        want.append((float(metrics["loss"]), np.asarray(metrics["counts"])))
    step = make_train_step(cfg, model, build_optimizer(Config(model=cfg, lr=lr), model),
                           device="cpu")
    got = [step(to_torch(b)) for b in batches]
    np.testing.assert_allclose(float(got[0]["loss"]), want[0][0], rtol=1e-5)
    np.testing.assert_allclose([float(g["loss"]) for g in got], [w[0] for w in want], rtol=2e-4)
    np.testing.assert_array_equal(got[0]["counts"].numpy(), want[0][1])

    jeval = jsteps.make_eval_step(jcfg)(jparams, {k: jnp.asarray(v) for k, v in
                                                  batches[0].items()})
    teval = make_eval_step(cfg, model, device="cpu")(to_torch(batches[0]))
    np.testing.assert_allclose(float(teval["loss"]), float(jeval["loss"]), rtol=2e-4)
    assert teval["counts"].shape == (2, 4)
    return got

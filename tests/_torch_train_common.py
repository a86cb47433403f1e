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


def make_model(seed, shape=None):
    """(JAX params as numpy, the port's model with the same weights), at
    ``shape`` (keyword arguments of both packages' ModelConfig; default SHAPE)."""
    jcfg, cfg = (JCFG, CFG) if shape is None else (JaxModelConfig(**shape), ModelConfig(**shape))
    params = jax.tree.map(np.asarray, init_smin_params(jax.random.PRNGKey(seed), jcfg))
    model = SMIN(cfg)
    model.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return params, model


def make_batch(B=4, seed=0, cfg=CFG):
    """Numpy batch: ragged videos and queries, one query with a single valid
    word, random GT spans, the last sample padded (sample_mask 0)."""
    rng = np.random.default_rng(seed)
    Nq, L, T = cfg.max_query_length, cfg.L, cfg.T
    nfeats = rng.integers(3, T + 1, size=B)
    nfeats[0] = T
    qlen = rng.integers(2, Nq + 1, size=B)
    qlen[1 % B] = 1
    batch = {k: [] for k in ("video_mask", "length_mask", "ym", "sm", "ys", "ss", "ye", "se",
                             "ya")}
    for b in range(B):
        vm, lm, _ = labels.build_masks(int(nfeats[b]), T, L)
        duration = float(rng.uniform(5.0, 40.0))
        s = float(rng.uniform(0.0, 0.6 * duration))
        e = float(rng.uniform(s + 0.1 * duration, duration))
        sm = labels.pack_triu(labels.iou_target_map(s, e, duration, L))
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

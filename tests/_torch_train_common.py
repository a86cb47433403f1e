"""Shared fixtures of the train-slice tests of the PyTorch port: a small
config in both packages, weights carried across, and a seeded synthetic
batch built with the port's label generators."""

import jax
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


def make_model(seed):
    """(JAX params as numpy, the port's model with the same weights)."""
    params = jax.tree.map(np.asarray, init_smin_params(jax.random.PRNGKey(seed), JCFG))
    model = SMIN(CFG)
    model.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return params, model


def make_batch(B=4, seed=0):
    """Numpy batch: ragged videos and queries, one query with a single valid
    word, random GT spans, the last sample padded (sample_mask 0)."""
    rng = np.random.default_rng(seed)
    Nq, L, T = CFG.max_query_length, CFG.L, CFG.T
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
    batch["video_features"] = (rng.standard_normal((B, T, CFG.input_video_dim))
                               .astype(np.float32) * batch["video_mask"])
    qmask = (np.arange(Nq)[None, :] < qlen[:, None]).astype(np.float32)[..., None]
    batch["query_mask"] = qmask
    batch["query_features"] = (rng.standard_normal((B, Nq, CFG.word_dim)).astype(np.float32)
                               * qmask)
    sample_mask = np.ones(B, np.float32)
    sample_mask[-1] = 0.0
    batch["sample_mask"] = sample_mask
    return batch


def to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}

"""The program under test, built from a cell's configuration and the seed's weights.

The only place the harness reaches into the port
(``video_moment_localization_tpu_torch``): its configuration reader, its
model's module tree (loaded strictly from the benchmark's weights), its
word table, its kernel build, and the entries the drivers time.
"""

from __future__ import annotations

import gc
from typing import Dict

import numpy as np
import torch

from video_moment_localization_tpu_torch.config import Config, config_from_dict
from video_moment_localization_tpu_torch.data.glove import WordEmbedding
from video_moment_localization_tpu_torch.models.smin import SMIN

SOURCES = ("content_attn", "content_train", "gemm", "lstm", "proposal_rows", "smin_stack",
           "smin_train")
ROUTE_KEYS = ("compute_dtype", "packed", "fused_smi", "fused_smi_train", "fused_lstm",
              "compat_head", "fused_content", "remat_smi")


def config(cfg: Dict) -> Config:
    """The program's configuration from the file's reference-schema keys
    and route keys."""
    conf = config_from_dict(cfg, experiment=cfg["dataset"])
    for key in ROUTE_KEYS:
        if key in cfg and getattr(conf.model, key) != cfg[key]:
            raise ValueError(f"the program read {key}={getattr(conf.model, key)!r}, "
                             f"the configuration states {cfg[key]!r}")
    if conf.model.word_dim != cfg["word_dim"]:
        raise ValueError(f"the program's word width is {conf.model.word_dim}, the "
                         f"configuration's {cfg['word_dim']}")
    return conf


def build_kernels(device: torch.device) -> None:
    """Compile the port's CUDA sources that have no library yet, all at once
    (only a checkout's first run compiles; later runs find the libraries)."""
    if device.type == "cuda":
        from video_moment_localization_tpu_torch.ops import cuda_build

        cuda_build.build(SOURCES)


def model(conf: Config, weights: Dict[str, torch.Tensor], device: torch.device) -> SMIN:
    """The program's SMIN with the seed's weights (copies: the program may
    update its own)."""
    with torch.device("meta"):
        net = SMIN(conf.model)
    net = net.to_empty(device=device)
    net.load_state_dict({k: v.detach().clone() for k, v in weights.items()}, strict=True)
    return net


def embedding(words, vectors: np.ndarray) -> WordEmbedding:
    return WordEmbedding(vectors, {w: i for i, w in enumerate(words)})


def free(state: Dict, *names: str) -> None:
    """Drop the program's objects from a driver's state before the
    reference runs, and hand their device memory back."""
    for name in names:
        state.pop(name, None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()

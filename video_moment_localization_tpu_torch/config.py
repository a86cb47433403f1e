"""Experiment configuration.

Counterpart of ``video_moment_localization_tpu/config.py``: reads the exact
20-key YAML schema of the reference configs so the files in ``config/`` load
unmodified, and validates them into typed dataclasses.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

import yaml

# The exact key set of the reference YAML schema (reference config/*.yml).
REQUIRED_KEYS = (
    "model",
    "checkpoint_path",
    "resume_training",
    "T",
    "L",
    "C",
    "d",
    "input_video_dim",
    "dl",
    "max_query_length",
    "lstm_hidden_size",
    "num_smi_layers",
    "dataset",
    "data_dir",
    "batch_size",
    "num_workers",
    "seed",
    "optimizer",
    "lr",
    "num_epochs",
)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static shape/hyperparameter config for the SMIN model."""

    T: int = 64                  # sampled clips per video
    L: int = 16                  # snippets; proposal map is L x L
    C: int = 4                   # sub-clips per moment
    D: int = 512                 # model feature dim ("d" in YAML)
    dl: int = 128                # content-word interaction dim
    num_smi_layers: int = 3
    input_video_dim: int = 1024
    max_query_length: int = 13
    lstm_hidden_size: int = 256
    word_dim: int = 300          # GloVe dimensionality
    # The keys below are the JAX package's modes, and the forwards of
    # models/smin.py take each of its routes; ``use_pallas`` is read by
    # neither (the port has one kernel per route), and bfloat16 runs on
    # every route (models/smin.py `check_dtype`).
    compute_dtype: str = "float32"
    use_pallas: bool = True
    packed: bool = True
    remat_smi: bool = False
    fused_content: bool = False
    fused_smi: bool = True
    fused_smi_train: bool = True
    fused_lstm: bool = True
    compat_head: bool = False

    def __post_init__(self):
        if self.T % self.L != 0:
            raise ValueError(f"T ({self.T}) must be a multiple of L ({self.L})")
        if self.D != 2 * self.lstm_hidden_size:
            # Hadamard fusion of video features with the biLSTM sentence
            # feature requires D == 2*hidden (reference models.py:81).
            raise ValueError(
                f"d ({self.D}) must equal 2*lstm_hidden_size "
                f"({2 * self.lstm_hidden_size}) for cross-modal fusion"
            )


@dataclasses.dataclass
class Config:
    """Full experiment config: model shape + data + training."""

    model: ModelConfig
    model_name: str = "SMIN"
    checkpoint_path: str = "checkpoints/"
    resume_training: bool = False
    dataset: str = "charadessta"
    data_dir: str = "data/charades"
    batch_size: int = 64
    num_workers: int = 4
    seed: int = 43
    optimizer: str = "Adam"
    lr: float = 5e-4
    num_epochs: int = 100
    experiment: str = "charadessta"
    nms: bool = False            # soft-NMS at eval
    nms_sigma: float = 0.5
    num_devices: Optional[int] = None
    seq_devices: int = 1
    profile_dir: Optional[str] = None
    save_best: Optional[str] = None
    eval_every: int = 1


def config_from_dict(params: Dict[str, Any], experiment: str = "experiment") -> Config:
    """Build a Config from a reference-schema dict (validating key presence)."""
    missing = [k for k in REQUIRED_KEYS if k not in params]
    if missing:
        raise KeyError(f"config missing required keys: {missing}")
    # Only SMIN exists — same raise-on-unknown semantics (and error shape)
    # as reference main.py:68-75 get_model().
    if str(params["model"]) != "SMIN":
        raise ValueError(f'Model {params["model"]} is not a valid model!')
    model = ModelConfig(
        T=int(params["T"]),
        L=int(params["L"]),
        C=int(params["C"]),
        D=int(params["d"]),
        dl=int(params["dl"]),
        num_smi_layers=int(params["num_smi_layers"]),
        input_video_dim=int(params["input_video_dim"]),
        max_query_length=int(params["max_query_length"]),
        lstm_hidden_size=int(params["lstm_hidden_size"]),
        compute_dtype=str(params.get("compute_dtype", "float32")),
        use_pallas=bool(params.get("use_pallas", True)),
        packed=bool(params.get("packed", True)),
        remat_smi=bool(params.get("remat_smi", False)),
        fused_content=bool(params.get("fused_content", False)),
        fused_smi=bool(params.get("fused_smi", True)),
        fused_smi_train=bool(params.get("fused_smi_train", True)),
        fused_lstm=bool(params.get("fused_lstm", True)),
        compat_head=bool(params.get("compat_head", False)),
    )
    return Config(
        model=model,
        model_name=str(params["model"]),
        checkpoint_path=str(params["checkpoint_path"]),
        resume_training=bool(params["resume_training"]),
        dataset=str(params["dataset"]),
        data_dir=str(params["data_dir"]),
        batch_size=int(params["batch_size"]),
        num_workers=int(params["num_workers"]),
        seed=int(params["seed"]),
        optimizer=str(params["optimizer"]),
        lr=float(params["lr"]),
        num_epochs=int(params["num_epochs"]),
        experiment=experiment,
        nms=bool(params.get("nms", False)),
        nms_sigma=float(params.get("nms_sigma", 0.5)),
        seq_devices=int(params.get("seq_devices", 1)),
        save_best=params.get("save_best"),
        eval_every=int(params.get("eval_every", 1)),
    )


def load_config(config_path: str, num_epochs_override: int = 0) -> Config:
    """Load a YAML config file; the experiment name is the file's stem
    (reference main.py:13-28), and a nonzero ``num_epochs_override`` replaces
    the YAML value."""
    with open(config_path, "r") as f:
        params = yaml.load(f, Loader=yaml.SafeLoader)
    experiment = os.path.splitext(os.path.basename(config_path))[0]
    cfg = config_from_dict(params, experiment=experiment)
    if num_epochs_override != 0:
        cfg.num_epochs = int(num_epochs_override)
    return cfg

"""Checkpoints in the reference's format.

One file per experiment at ``{checkpoint_path}/{experiment}_model.ckpt``
(reference main.py:213-218), a ``torch.save`` of {"epoch", "model",
"optimizer"} whose "model" is the SMIN state_dict. It is what the reference
writes, and what ``scripts/port_checkpoint.py --reverse`` writes from a JAX
checkpoint.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import torch


def checkpoint_paths(checkpoint_path: str, experiment: str) -> Tuple[str, str]:
    """(model checkpoint path, stats json path) for an experiment."""
    prefix = os.path.join(checkpoint_path, f"{experiment}_")
    return prefix + "model.ckpt", prefix + "stats.json"


def load_checkpoint(path: str) -> Optional[Dict[str, Any]]:
    """{epoch, model, optimizer} from ``path`` on the CPU, or None if absent."""
    if not os.path.exists(path):
        return None
    return torch.load(path, map_location="cpu", weights_only=True)

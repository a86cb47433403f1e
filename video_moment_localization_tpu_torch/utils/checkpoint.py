"""Checkpoints in the reference's format.

One file per experiment at ``{checkpoint_path}/{experiment}_model.ckpt``
(reference main.py:213-218), a ``torch.save`` of {"epoch", "model",
"optimizer"} whose "model" is the SMIN state_dict and "optimizer" the
optimizer's state_dict. It is what the reference writes, what
``scripts/port_checkpoint.py --reverse`` writes from a JAX checkpoint, and
what the port's trainer writes (`save_checkpoint`).
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Dict, Optional, Tuple

import torch


def checkpoint_paths(checkpoint_path: str, experiment: str) -> Tuple[str, str]:
    """(model checkpoint path, stats json path) for an experiment."""
    prefix = os.path.join(checkpoint_path, f"{experiment}_")
    return prefix + "model.ckpt", prefix + "stats.json"


def save_checkpoint(path: str, epoch: int, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer) -> None:
    """Write {epoch, model, optimizer} to ``path`` in the reference format.

    The file is written under a temporary name in the same directory and
    renamed over ``path``, so a process killed mid-save leaves the previous
    checkpoint whole. The optimizer's state (Adam's step and moments) is
    saved as it is, so a resumed run continues exactly."""
    directory = os.path.dirname(path) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".", suffix=".tmp",
                               dir=directory)
    try:
        with os.fdopen(fd, "wb") as fh:
            torch.save({"epoch": int(epoch), "model": model.state_dict(),
                        "optimizer": optimizer.state_dict()}, fh)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_checkpoint(path: str) -> Optional[Dict[str, Any]]:
    """{epoch, model, optimizer} from ``path`` on the CPU, or None if absent."""
    if not os.path.exists(path):
        return None
    return torch.load(path, map_location="cpu", weights_only=True)

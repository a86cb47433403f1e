"""Masked multi-layer bidirectional LSTM in plain PyTorch.

Counterpart of ``video_moment_localization_tpu/models/lstm.py``. Ragged
sequences are handled by a mask-carried state instead of
``pack_padded_sequence``:

* forward direction: the (h, c) carry only advances where the step is valid,
  and outputs at padded steps are zero;
* backward direction: the recurrence runs over reversed time; padding sits at
  the end of each sequence, so the zero carry stays zero until the last real
  step, reproducing the packed sequence's per-sample start at t = len-1.

Per layer/direction the weights are torch's own ``w_ih (4H, in)``,
``w_hh (4H, H)``, ``b_ih``, ``b_hh`` with gate order (input, forget, cell,
output).
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
from torch import nn

Layers = List[Dict[str, Dict[str, torch.Tensor]]]


class BiLSTMParams(nn.Module):
    """The parameters of a bidirectional ``nn.LSTM``, under its names
    (``weight_ih_l0``, ..., ``bias_hh_l1_reverse``) and with its default
    init U(-1/sqrt(H), 1/sqrt(H)), so a reference state_dict loads strictly.
    It is not an ``nn.LSTM``: moving one to the card flattens its weights
    through cuDNN, and the port runs its own recurrence."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int):
        super().__init__()
        self.num_layers = num_layers
        H = hidden_size
        bound = 1.0 / math.sqrt(H)
        for k in range(num_layers):
            in_dim = input_size if k == 0 else 2 * H
            for suffix in ("", "_reverse"):
                for name, shape in (("weight_ih", (4 * H, in_dim)), ("weight_hh", (4 * H, H)),
                                    ("bias_ih", (4 * H,)), ("bias_hh", (4 * H,))):
                    param = nn.Parameter(torch.empty(shape).uniform_(-bound, bound))
                    self.register_parameter(f"{name}_l{k}{suffix}", param)


def lstm_layers(lstm: BiLSTMParams) -> Layers:
    """The per-layer {fwd|bwd: {w_ih, w_hh, b_ih, b_hh}} view of the
    parameters (the module is only a parameter container)."""
    layers = []
    for k in range(lstm.num_layers):
        directions = {}
        for direction, suffix in (("fwd", ""), ("bwd", "_reverse")):
            directions[direction] = {
                name: getattr(lstm, f"{pname}_l{k}{suffix}")
                for name, pname in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
                                    ("b_ih", "bias_ih"), ("b_hh", "bias_hh"))
            }
        layers.append(directions)
    return layers


def lstm_step(gates: torch.Tensor, m: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
    """Masked cell update from pre-activations (B, 4H), validity m (B, 1)."""
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    h = m * h_new + (1.0 - m) * h
    c = m * c_new + (1.0 - m) * c
    return h, c


def _lstm_direction(x: torch.Tensor, mask: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One direction over (B, S, in) with validity mask (B, S) -> (B, S, H)."""
    B, S, _ = x.shape
    H = p["w_hh"].shape[1]
    x_proj = x @ p["w_ih"].t() + (p["b_ih"] + p["b_hh"])          # (B, S, 4H)
    h = x.new_zeros((B, H))
    c = x.new_zeros((B, H))
    ys = []
    for t in range(S):
        m = mask[:, t : t + 1]
        h, c = lstm_step(x_proj[:, t] + h @ p["w_hh"].t(), m, h, c)
        ys.append(h * m)
    return torch.stack(ys, dim=1)


def bilstm(x: torch.Tensor, mask: torch.Tensor, layers: Layers) -> torch.Tensor:
    """Multi-layer biLSTM: (B, S, in), mask (B, S) -> (B, S, 2H)."""
    h = x
    mask = mask.to(x.dtype)
    for p in layers:
        fwd = _lstm_direction(h, mask, p["fwd"])
        bwd = _lstm_direction(h.flip(1), mask.flip(1), p["bwd"]).flip(1)
        h = torch.cat([fwd, bwd], dim=-1)
    return h

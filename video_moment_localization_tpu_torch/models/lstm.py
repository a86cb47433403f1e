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
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
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


def lstm_layers(lstm: BiLSTMParams, tensors: Optional[Dict[str, torch.Tensor]] = None) -> Layers:
    """The per-layer {fwd|bwd: {w_ih, w_hh, b_ih, b_hh}} view of the
    parameters (the module is only a parameter container), or of
    ``tensors``, a {parameter name: tensor} map of the same names (the bf16
    cast of serving, models/smin.py::cast_weights)."""
    layers = []
    for k in range(lstm.num_layers):
        directions = {}
        for direction, suffix in (("fwd", ""), ("bwd", "_reverse")):
            directions[direction] = {
                name: (tensors[f"{pname}_l{k}{suffix}"] if tensors is not None
                       else getattr(lstm, f"{pname}_l{k}{suffix}"))
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
    """One direction over (B, S, in) with validity mask (B, S) -> (B, S, H),
    in x's dtype: the weights and the summed bias are cast to it (no-ops in
    fp32), as the JAX scan casts them (`_lstm_scan`)."""
    B, S, _ = x.shape
    H = p["w_hh"].shape[1]
    w_ih, w_hh = p["w_ih"].to(x.dtype), p["w_hh"].to(x.dtype)
    x_proj = x @ w_ih.t() + (p["b_ih"] + p["b_hh"]).to(x.dtype)    # (B, S, 4H)
    h = x.new_zeros((B, H))
    c = x.new_zeros((B, H))
    ys = []
    for t in range(S):
        m = mask[:, t : t + 1]
        h, c = lstm_step(x_proj[:, t] + h @ w_hh.t(), m, h, c)
        ys.append(h * m)
    return torch.stack(ys, dim=1)


def _lstm_direction_bf16(xp: torch.Tensor, mask: torch.Tensor, w_hh: torch.Tensor,
                         b_hh: torch.Tensor) -> torch.Tensor:
    """One direction at bf16 from its input projection xp (B, S, 4H) bf16
    (b_ih included): gates in fp32 as xp + h W_hh^T + b_hh, the product over
    h rounded to bf16 and W_hh in bf16 with fp32 sums, (h, c) carried in
    fp32, outputs h * m stored in bf16 -> (B, S, H)."""
    B, S, _ = xp.shape
    H = w_hh.shape[1]
    w = w_hh.to(torch.bfloat16).float().t()
    h = xp.new_zeros((B, H), dtype=torch.float32)
    c = torch.zeros_like(h)
    ys = []
    for t in range(S):
        m = mask[:, t : t + 1]
        gates = h.to(torch.bfloat16).float() @ w + xp[:, t].float() + b_hh.float()
        h, c = lstm_step(gates, m, h, c)
        ys.append((h * m).to(torch.bfloat16))
    return torch.stack(ys, dim=1)


def bilstm_bf16(x: torch.Tensor, mask: torch.Tensor, layers: Layers) -> torch.Tensor:
    """The 2-layer biLSTM at bf16: x (B, S, in) bf16 -> (B, S, 2H) bf16,
    with the arithmetic of the JAX package's fused bf16 biLSTM
    (ops/lstm_pallas.py: bf16 operands and stored activations, fp32 gates),
    which the bf16 variant of K5 (ops/lstm_cuda.py) follows: layer 1's input
    projection is the library's bf16 product with the bf16 b_ih, layer 2's
    bf16 products of h1 and W_ih with fp32 sums and the fp32 b_ih, rounded
    to bf16; b_hh is added to the gates in fp32. Matrices may come as fp32
    or already cast: they are rounded to bf16 here either way."""
    bf = torch.bfloat16
    mask = mask.to(torch.float32)
    h = x
    for k, p in enumerate(layers):
        outs = []
        for direction in ("fwd", "bwd"):
            d = p[direction]
            w_ih = d["w_ih"].to(bf)
            if k == 0:
                xp = F.linear(h, w_ih, d["b_ih"].to(bf))
            else:
                xp = (h.float() @ w_ih.float().t() + d["b_ih"].float()).to(bf)
            if direction == "fwd":
                outs.append(_lstm_direction_bf16(xp, mask, d["w_hh"], d["b_hh"]))
            else:
                outs.append(_lstm_direction_bf16(xp.flip(1), mask.flip(1), d["w_hh"],
                                                 d["b_hh"]).flip(1))
        h = torch.cat(outs, dim=-1)
    return h


def bilstm(x: torch.Tensor, mask: torch.Tensor, layers: Layers) -> torch.Tensor:
    """Multi-layer biLSTM under autograd: (B, S, in), mask (B, S) -> (B, S,
    2H), the recurrence in x's dtype: the plain biLSTM of both packages,
    in training and (``fused_lstm: False``) serving alike. At bf16 it is
    the JAX XLA scan's (models/lstm.py `_lstm_scan`: the matrices and b_ih +
    b_hh cast to bf16, gates, cell and state in bf16), not the serving
    kernel's, whose gates are fp32 (`bilstm_bf16`)."""
    h = x
    mask = mask.to(x.dtype)
    for p in layers:
        fwd = _lstm_direction(h, mask, p["fwd"])
        bwd = _lstm_direction(h.flip(1), mask.flip(1), p["bwd"]).flip(1)
        h = torch.cat([fwd, bwd], dim=-1)
    return h

"""Carry JAX parameters into the port's reference-keyed state_dict.

The port's own copy of ``video_moment_localization_tpu/models/port.py::
torch_state_dict_from_params``: the JAX pytree (numpy arrays) becomes a
state_dict with the reference's key names, which `models.smin.SMIN` loads
with ``strict=True``. Layout conversions:

* Linear: JAX w (in, out) -> weight (out, in)
* 1x1 Conv2d / Conv1d: w (in, out) -> weight (out, in, 1, 1) / (out, in, 1)
* LSTM weights and the positional embedding: as they are
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, order="C", copy=True))


def _linear(sd, prefix: str, p) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(p["w"]).T)
    sd[f"{prefix}.bias"] = _t(p["b"])


def _conv1x1(sd, prefix: str, p, conv2d: bool) -> None:
    w = np.asarray(p["w"], np.float32).T                      # (out, in)
    sd[f"{prefix}.weight"] = _t(w[..., None, None] if conv2d else w[..., None])
    sd[f"{prefix}.bias"] = _t(p["b"])


def state_dict_from_jax_params(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX SMIN parameter pytree -> reference-keyed state_dict of tensors."""
    sd: Dict[str, torch.Tensor] = {}
    _linear(sd, "backbone.videoencoder.ve", params["video_encoder"]["ve"])
    sd["backbone.videoencoder.pe.weight"] = _t(params["video_encoder"]["pe"])
    for layer, directions in enumerate(params["query_encoder"]):
        for direction, suffix in (("fwd", ""), ("bwd", "_reverse")):
            for key in ("w_ih", "w_hh", "b_ih", "b_hh"):
                torch_key = key.replace("w_", "weight_").replace("b_", "bias_")
                sd[f"backbone.queryencoder.lstm.{torch_key}_l{layer}{suffix}"] = _t(
                    directions[direction][key])
    for i, layer in enumerate(params["smi"]):
        pre = f"smis.{i}"
        c = layer["content"]
        _linear(sd, f"{pre}.content_unit.linear_c_hat", c["c_hat"])
        _linear(sd, f"{pre}.content_unit.linear_w_hat", c["w_hat"])
        _linear(sd, f"{pre}.content_unit.linear_s_hat", c["s_hat"])
        _linear(sd, f"{pre}.content_unit.linear_c", c["c_out"])
        _linear(sd, f"{pre}.content_unit.attn_layer.W_q", c["attn_q"])
        _linear(sd, f"{pre}.content_unit.attn_layer.W_k", c["attn_k"])
        _linear(sd, f"{pre}.boundary_unit.attn_layer.W_q", layer["boundary"]["attn_q"])
        _linear(sd, f"{pre}.boundary_unit.attn_layer.W_k", layer["boundary"]["attn_k"])
        _conv1x1(sd, f"{pre}.moment_unit.conv_layer_fb", layer["moment"]["conv_fb"], True)
        _conv1x1(sd, f"{pre}.moment_unit.conv_layer_fc", layer["moment"]["conv_fc"], True)
    loc = params["localization"]
    _conv1x1(sd, "localization.conv_layer_pm", loc["pm"], True)
    for head in ("ps", "pe", "pa"):
        _conv1x1(sd, f"localization.conv_layer_{head}", loc[head], False)
    return sd

"""K5: the fused 2-layer biLSTM of the serving path (csrc/lstm.cu).

Counterpart of ``video_moment_localization_tpu/ops/lstm_pallas.py::
bilstm_fused``. The layer-1 input projection ``x @ W_ih^T + b_ih`` runs
here, outside the kernel, as it does in the JAX wrapper; the kernel runs the
recurrence of both layers and directions and the layer-2 input projection.

On a CPU tensor the wrapper runs the plain version, ``models/lstm.py::
bilstm`` (imported here as `bilstm_plain`); on a CUDA tensor it launches the
kernel or raises. ``bilstm_fused.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from video_moment_localization_tpu_torch.models.lstm import Layers
from video_moment_localization_tpu_torch.models.lstm import bilstm as bilstm_plain
from video_moment_localization_tpu_torch.ops.cuda_build import (
    MAX_SMEM_BYTES,
    check,
    load_library,
    ptr,
    stream_of,
)

_WEIGHTS = ("w_ih", "w_hh", "b_ih", "b_hh")


def _library() -> ctypes.CDLL:
    lib = load_library("lstm")
    lib.vml_lstm_layer_smem_bytes.argtypes = [ctypes.c_int]
    lib.vml_lstm_layer_smem_bytes.restype = ctypes.c_size_t
    fn = lib.vml_bilstm2_f32
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 19
    fn.restype = ctypes.c_int
    return lib


def _check_inputs(x: torch.Tensor, mask: torch.Tensor, layers: Layers) -> int:
    if x.device.type != "cuda":
        raise ValueError(f"bilstm_fused takes CPU or CUDA tensors, got {x.device}")
    if x.dtype != torch.float32 or x.dim() != 3:
        raise ValueError(f"x must be float32 (B, S, in), got {x.dtype} {tuple(x.shape)}")
    if mask.shape != x.shape[:2] or mask.device != x.device:
        raise ValueError(f"mask must be (B, S) on {x.device}, got {tuple(mask.shape)}")
    if len(layers) != 2:
        raise ValueError(f"the fused biLSTM has 2 layers, got {len(layers)}")
    H = layers[0]["fwd"]["w_hh"].shape[1]
    if H % 32 or H > 256:
        raise ValueError(f"hidden size {H} must be a multiple of 32 and at most 256")
    for k, layer in enumerate(layers):
        in_dim = x.shape[2] if k == 0 else 2 * H
        shapes = {"w_ih": (4 * H, in_dim), "w_hh": (4 * H, H), "b_ih": (4 * H,), "b_hh": (4 * H,)}
        for direction in ("fwd", "bwd"):
            for name in _WEIGHTS:
                w = layer[direction][name]
                if (tuple(w.shape) != shapes[name] or w.dtype != torch.float32
                        or w.device != x.device or not w.is_contiguous()):
                    raise ValueError(
                        f"layer {k} {direction} {name}: want contiguous float32 "
                        f"{shapes[name]} on {x.device}, got {w.dtype} "
                        f"{tuple(w.shape)} on {w.device}")
    return H


@torch.no_grad()
def bilstm_fused(x: torch.Tensor, mask: torch.Tensor, layers: Layers) -> torch.Tensor:
    """Fused 2-layer biLSTM forward: x (B, S, in), mask (B, S) -> (B, S, 2H).

    ``layers`` is `models.lstm.lstm_layers`' view of the weights, in torch's
    layout (w_ih (4H, in), w_hh (4H, H), gate order i, f, g, o)."""
    if x.device.type == "cpu":
        return bilstm_plain(x, mask, layers)
    H = _check_inputs(x, mask, layers)
    lib = _library()
    smem = lib.vml_lstm_layer_smem_bytes(H)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"hidden size {H} needs {smem} B of shared memory per block")
    B, S, _ = x.shape
    p1, p2 = layers
    x = x.contiguous()
    maskf = mask.to(torch.float32).contiguous()
    xp1f = F.linear(x, p1["fwd"]["w_ih"], p1["fwd"]["b_ih"])
    xp1b = F.linear(x, p1["bwd"]["w_ih"], p1["bwd"]["b_ih"])
    h1 = torch.empty((B, S, 2 * H), device=x.device, dtype=torch.float32)
    xp2f = torch.empty((B, S, 4 * H), device=x.device, dtype=torch.float32)
    xp2b = torch.empty_like(xp2f)
    out = torch.empty_like(h1)
    with torch.cuda.device(x.device):
        err = lib.vml_bilstm2_f32(
            stream_of(x), B, S, H, ptr(xp1f), ptr(xp1b), ptr(maskf),
            ptr(p1["fwd"]["w_hh"]), ptr(p1["bwd"]["w_hh"]),
            ptr(p1["fwd"]["b_hh"]), ptr(p1["bwd"]["b_hh"]),
            ptr(p2["fwd"]["w_ih"]), ptr(p2["bwd"]["w_ih"]),
            ptr(p2["fwd"]["b_ih"]), ptr(p2["bwd"]["b_ih"]),
            ptr(p2["fwd"]["w_hh"]), ptr(p2["bwd"]["w_hh"]),
            ptr(p2["fwd"]["b_hh"]), ptr(p2["bwd"]["b_hh"]),
            ptr(h1), ptr(xp2f), ptr(xp2b), ptr(out))
    check(lib, "vml_bilstm2_f32", err)
    bilstm_fused.launches += 1
    return out


bilstm_fused.launches = 0

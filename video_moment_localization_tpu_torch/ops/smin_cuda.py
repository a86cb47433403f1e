"""K4: the fused SMI stack of the serving path (csrc/smin_stack.cu).

Counterpart of ``video_moment_localization_tpu/ops/smin_pallas.py::
smin_stack_fused``: proposal pooling, the SMI layers and the sigmoid heads,
from the backbone outputs to pm (B, N) in triu order and ps/pe/pa (B, L),
all fp32.

`smin_stack_plain` is the plain PyTorch version: the packed pipeline of
models/smin.py (proposal_features_packed -> smi_block_packed per layer ->
localization_packed). The wrapper runs it for CPU tensors; for CUDA tensors
it launches the kernels or raises. ``smin_stack_fused.launches`` counts the
launches (one per call: the C entry point sequences all the kernels).
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from video_moment_localization_tpu_torch.config import ModelConfig
from video_moment_localization_tpu_torch.models.smin import (
    SMIN,
    localization_packed,
    smi_block_packed,
)
from video_moment_localization_tpu_torch.ops.cuda_build import (
    MAX_SMEM_BYTES,
    check,
    load_library,
    ptr,
    stream_of,
)
from video_moment_localization_tpu_torch.ops.proposal import proposal_features_packed

Scores = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def smin_stack_plain(model: SMIN, cfg: ModelConfig, f, fw, fs, query_mask,
                     length_mask, vmask) -> Scores:
    """The plain version: the packed XLA-path pipeline of the JAX package."""
    fc, fm, fb = proposal_features_packed(f, length_mask, cfg.L, cfg.C)
    for block in model.smis:
        fc, fm, fb = smi_block_packed(block, fc, fm, fb, fw, fs, query_mask,
                                      length_mask, vmask, cfg.L)
    return localization_packed(model.localization, fm, fb, length_mask, vmask, cfg.L)


def _library() -> ctypes.CDLL:
    lib = load_library("smin_stack")
    lib.vml_smin_workspace_floats.argtypes = [ctypes.c_int] * 6
    lib.vml_smin_workspace_floats.restype = ctypes.c_size_t
    lib.vml_smin_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.vml_smin_smem_bytes.restype = ctypes.c_size_t
    fn = lib.vml_smin_stack_f32
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 6
                   + [ctypes.POINTER(ctypes.c_void_p)] * 2 + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    return lib


def _layer_weights(model: SMIN) -> List[torch.Tensor]:
    """The 20 tensors per layer, in the order vml_smin_stack_f32 reads."""
    out = []
    for block in model.smis:
        cu, bu, mu = block.content_unit, block.boundary_unit, block.moment_unit
        for layer in (cu.linear_c_hat, cu.linear_w_hat, cu.linear_s_hat, cu.linear_c,
                      cu.attn_layer.W_q, cu.attn_layer.W_k, bu.attn_layer.W_q,
                      bu.attn_layer.W_k, mu.conv_layer_fb, mu.conv_layer_fc):
            out += [layer.weight, layer.bias]
    return out


def _head_weights(model: SMIN) -> List[torch.Tensor]:
    loc = model.localization
    out = []
    for layer in (loc.conv_layer_pm, loc.conv_layer_ps, loc.conv_layer_pe, loc.conv_layer_pa):
        out += [layer.weight, layer.bias]
    return out


def _pointer_array(tensors: List[torch.Tensor]):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _check_inputs(model: SMIN, cfg: ModelConfig, tensors) -> None:
    f = tensors["f"]
    if f.device.type != "cuda":
        raise ValueError(f"smin_stack_fused takes CPU or CUDA tensors, got {f.device}")
    B, T, D = f.shape
    Nq = tensors["fw"].shape[1]
    N = cfg.L * (cfg.L + 1) // 2
    want = {"f": (B, cfg.T, cfg.D), "fw": (B, Nq, cfg.D), "fs": (B, cfg.D),
            "query_mask": (B, Nq, 1), "length_mask": (B, cfg.L), "vmask": (B, N)}
    for name, t in tensors.items():
        if (tuple(t.shape) != want[name] or t.dtype != torch.float32
                or t.device != f.device or not t.is_contiguous()):
            raise ValueError(f"{name}: want contiguous float32 {want[name]} on {f.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if len(model.smis) != cfg.num_smi_layers or any(
            tuple(b.content_unit.linear_c_hat.weight.shape) != (cfg.dl, cfg.D)
            for b in model.smis):
        raise ValueError(f"model ({len(model.smis)} SMI layers) does not match the config "
                         f"({cfg.num_smi_layers} layers, D={cfg.D}, dl={cfg.dl})")
    for w in _layer_weights(model) + _head_weights(model):
        if w.dtype != torch.float32 or w.device != f.device or not w.is_contiguous():
            raise ValueError(f"weights must be contiguous float32 on {f.device}, "
                             f"got {w.dtype} on {w.device}")


@torch.no_grad()
def smin_stack_fused(model: SMIN, cfg: ModelConfig, f, fw, fs, query_mask,
                     length_mask, vmask) -> Scores:
    """Proposal pooling + SMI stack + heads. f (B, T, D), fw (B, Nq, D),
    fs (B, D), query_mask (B, Nq, 1), length_mask (B, L), vmask (B, N) ->
    (pm (B, N), ps, pe, pa (B, L)) in fp32."""
    if f.device.type == "cpu":
        return smin_stack_plain(model, cfg, f, fw, fs, query_mask, length_mask, vmask)
    tensors = {"f": f, "fw": fw, "fs": fs, "query_mask": query_mask,
               "length_mask": length_mask, "vmask": vmask}
    _check_inputs(model, cfg, tensors)
    lib = _library()
    B, T, D = f.shape
    L, C, dl, Nq = cfg.L, cfg.C, cfg.dl, fw.shape[1]
    N = L * (L + 1) // 2
    smem = lib.vml_smin_smem_bytes(L, C, Nq, D, dl)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"L={L}, Nq={Nq}, D={D} need {smem} B of shared memory per block")
    ws = torch.empty(lib.vml_smin_workspace_floats(B, L, C, Nq, D, dl),
                     device=f.device, dtype=torch.float32)
    pm = torch.empty((B, N), device=f.device, dtype=torch.float32)
    pb = torch.empty((3, B, L), device=f.device, dtype=torch.float32)
    layer_w = _layer_weights(model)
    head_w = _head_weights(model)
    with torch.cuda.device(f.device):
        err = lib.vml_smin_stack_f32(
            stream_of(f), B, T, L, C, Nq, D, dl, cfg.num_smi_layers,
            ptr(f), ptr(fw), ptr(fs), ptr(query_mask), ptr(length_mask), ptr(vmask),
            _pointer_array(layer_w), _pointer_array(head_w), ptr(ws), ptr(pm), ptr(pb))
    check(lib, "vml_smin_stack_f32", err)
    smin_stack_fused.launches += 1
    return pm, pb[0], pb[1], pb[2]


smin_stack_fused.launches = 0

"""K4: the fused SMI stack of the serving path (csrc/smin_stack.cu).

Counterpart of ``video_moment_localization_tpu/ops/smin_pallas.py::
smin_stack_fused``: proposal pooling, the SMI layers and the sigmoid heads,
from the backbone outputs to pm (B, N) in triu order and ps/pe/pa (B, L),
all fp32.

`smin_stack_plain` is the plain PyTorch version: the packed pipeline of
models/smin.py (proposal_features_packed -> smi_block_packed per layer ->
localization_packed). The wrapper runs it for CPU tensors; for CUDA tensors
it launches the kernels or raises. ``smin_stack_fused.launches`` counts the
fp32 variant's launches and ``smin_stack_fused.launches_bf16`` the bf16
variant's (one per call: the C entry point sequences all the kernels).

The kernels have an fp32 and a bf16 variant, chosen by ``f.dtype`` (the
JAX kernel's production dtype is bf16): at bf16 f, fw and fs are bf16, the
layer weights are the model's bf16 cast (models/smin.py::cast_weights, made
once per model and kept until a parameter changes), biases, heads, masks
and the outputs fp32; the plain version is models/smin.py::smin_stack_bf16.
Any other type raises: the wrapper casts no input.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from video_moment_localization_tpu_torch.config import ModelConfig
from video_moment_localization_tpu_torch.models.smin import (
    SMIN,
    block_weights,
    cast_weights,
    localization_packed,
    smi_block_packed,
    smin_stack_bf16,
)
from video_moment_localization_tpu_torch.ops.cuda_build import (
    MAX_SMEM_BYTES,
    check,
    load_library,
    pointer_array,
    ptr,
    refuse_grad,
    stream_of,
)
from video_moment_localization_tpu_torch.ops.proposal import proposal_features_packed
from video_moment_localization_tpu_torch.ops.proposal_cuda import check_smem

Scores = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def smin_stack_plain(model: SMIN, cfg: ModelConfig, f, fw, fs, query_mask,
                     length_mask, vmask) -> Scores:
    """The plain version: the packed XLA-path pipeline of the JAX package;
    at bf16 (``f.dtype``) `models.smin.smin_stack_bf16`."""
    if f.dtype == torch.bfloat16:
        return smin_stack_bf16(model, cfg, f, fw, fs, query_mask, length_mask, vmask)
    fc, fm, fb = proposal_features_packed(f, length_mask, cfg.L, cfg.C)
    for block in model.smis:
        fc, fm, fb = smi_block_packed(block, fc, fm, fb, fw, fs, query_mask,
                                      length_mask, vmask, cfg.L)
    return localization_packed(model.localization, fm, fb, length_mask, vmask, cfg.L)


def _library() -> ctypes.CDLL:
    lib = load_library("smin_stack")
    lib.vml_smin_workspace_bytes.argtypes = [ctypes.c_int] * 7
    lib.vml_smin_workspace_bytes.restype = ctypes.c_size_t
    lib.vml_smin_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.vml_smin_smem_bytes.restype = ctypes.c_size_t
    for name in ("vml_smin_stack_f32", "vml_smin_stack_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 6
                       + [ctypes.POINTER(ctypes.c_void_p)] * 2 + [ctypes.c_void_p] * 3)
        fn.restype = ctypes.c_int
    return lib


def _layer_weights(model: SMIN, dtype: torch.dtype = torch.float32) -> List[torch.Tensor]:
    """The 20 tensors per layer, in the order vml_smin_stack_f32 reads; at
    bf16 the block's bf16 cast of its matrices, its biases fp32."""
    if dtype == torch.float32:
        return [w for block in model.smis for w in block_weights(block)]
    cast = cast_weights(model.smis, dtype)
    memo = model.__dict__.get("_stack_weights_cast")
    if memo is None or memo[0] is not cast:     # the cast was made anew: order it once
        names = {id(p): n for n, p in model.smis.named_parameters()}
        memo = (cast, [cast[names[id(w)]] for block in model.smis for w in block_weights(block)])
        model.__dict__["_stack_weights_cast"] = memo
    return memo[1]


def _head_weights(model: SMIN) -> List[torch.Tensor]:
    loc = model.localization
    out = []
    for layer in (loc.conv_layer_pm, loc.conv_layer_ps, loc.conv_layer_pe, loc.conv_layer_pa):
        out += [layer.weight, layer.bias]
    return out


def _check_inputs(model: SMIN, cfg: ModelConfig, tensors) -> None:
    f = tensors["f"]
    if f.device.type != "cuda":
        raise ValueError(f"smin_stack_fused takes CPU or CUDA tensors, got {f.device}")
    B, T, D = f.shape
    Nq = tensors["fw"].shape[1]
    N = cfg.L * (cfg.L + 1) // 2
    if f.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"f: the kernels take float32 or bfloat16, got {f.dtype}")
    want = {"f": (B, cfg.T, cfg.D), "fw": (B, Nq, cfg.D), "fs": (B, cfg.D),
            "query_mask": (B, Nq, 1), "length_mask": (B, cfg.L), "vmask": (B, N)}
    for name, t in tensors.items():
        dtype = f.dtype if name in ("f", "fw", "fs") else torch.float32
        if (tuple(t.shape) != want[name] or t.dtype != dtype
                or t.device != f.device or not t.is_contiguous()):
            raise ValueError(f"{name}: want contiguous {dtype} {want[name]} on {f.device}, "
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


def smin_stack_fused(model: SMIN, cfg: ModelConfig, f, fw, fs, query_mask,
                     length_mask, vmask) -> Scores:
    """Proposal pooling + SMI stack + heads. f (B, T, D), fw (B, Nq, D),
    fs (B, D) in fp32 or bf16 (the variant), query_mask (B, Nq, 1),
    length_mask (B, L), vmask (B, N) in fp32 -> (pm (B, N), ps, pe, pa
    (B, L)) in fp32. Grad-free: on CUDA tensors that would record a graph
    it raises (the differentiable stack is ops/smin_train_cuda.py)."""
    if f.device.type == "cpu":
        with torch.no_grad():
            return smin_stack_plain(model, cfg, f, fw, fs, query_mask, length_mask, vmask)
    tensors = {"f": f, "fw": fw, "fs": fs, "query_mask": query_mask,
               "length_mask": length_mask, "vmask": vmask}
    _check_inputs(model, cfg, tensors)
    bf16 = f.dtype == torch.bfloat16
    layer_w = _layer_weights(model, f.dtype)
    head_w = _head_weights(model)
    refuse_grad("smin_stack_fused", [*tensors.values(), *layer_w, *head_w])
    lib = _library()
    B, T, D = f.shape
    L, C, dl, Nq = cfg.L, cfg.C, cfg.dl, fw.shape[1]
    N = L * (L + 1) // 2
    smem = lib.vml_smin_smem_bytes(L, C, Nq, D, dl)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"L={L}, Nq={Nq}, D={D} need {smem} B of shared memory per block")
    check_smem("smin_stack_fused", T, L, C, False, f.dtype)   # the pooling phase
    ws = torch.empty(lib.vml_smin_workspace_bytes(B, L, C, Nq, D, dl, int(bf16)),
                     device=f.device, dtype=torch.uint8)
    pm = torch.empty((B, N), device=f.device, dtype=torch.float32)
    pb = torch.empty((3, B, L), device=f.device, dtype=torch.float32)
    entry = "vml_smin_stack_bf16" if bf16 else "vml_smin_stack_f32"
    with torch.cuda.device(f.device):
        err = getattr(lib, entry)(
            stream_of(f), B, T, L, C, Nq, D, dl, cfg.num_smi_layers,
            ptr(f), ptr(fw), ptr(fs), ptr(query_mask), ptr(length_mask), ptr(vmask),
            pointer_array(layer_w), pointer_array(head_w), ptr(ws), ptr(pm), ptr(pb))
    check(lib, entry, err)
    if bf16:
        smin_stack_fused.launches_bf16 += 1
    else:
        smin_stack_fused.launches += 1
    return pm, pb[0], pb[1], pb[2]


smin_stack_fused.launches = 0          # the fp32 variant's launches
smin_stack_fused.launches_bf16 = 0     # the bf16 variant's

"""K1: packed proposal features for training, forward and backward
(csrc/proposal_rows.cu).

Counterpart of ``video_moment_localization_tpu/ops/proposal_pallas.py::
proposal_features_rows`` and its custom VJP (`_rows_fwd` / `_rows_bwd`):
from the fused backbone features f (B, T, D) to the clip means fc, their
mean over clips fm and the snippet window means fb. The JAX kernel emits fc
in c-major rows (B, C*N, D), a layout chosen for the TPU's tiling; this
port keeps fc n-major, (B, N, C, D), the layout of every other kernel and
plain function of the package (`ops.packing.pack_rows` converts).

`proposal_features_rows` is the differentiable entry (an autograd Function
that saves its inputs). `proposal_rows_forward` / `proposal_rows_backward`
are the two kernel wrappers: on a CPU tensor each runs its plain version
(`ops.proposal.proposal_features_packed`, and autograd through it), on a
CUDA tensor it launches its kernel or raises. ``.launches`` on each counts
the launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from video_moment_localization_tpu_torch.ops.cuda_build import check, load_library, ptr, stream_of
from video_moment_localization_tpu_torch.ops.packing import packed_valid_mask
from video_moment_localization_tpu_torch.ops.proposal import proposal_features_packed

Features = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _library() -> ctypes.CDLL:
    lib = load_library("proposal_rows")
    lib.vml_proposal_rows_fwd_f32.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 5
                                              + [ctypes.c_void_p] * 5)
    lib.vml_proposal_rows_fwd_f32.restype = ctypes.c_int
    lib.vml_proposal_rows_bwd_f32.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 5
                                              + [ctypes.c_void_p] * 5)
    lib.vml_proposal_rows_bwd_f32.restype = ctypes.c_int
    return lib


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if (tuple(t.shape) != tuple(shape) or t.dtype != torch.float32 or t.device != device
            or not t.is_contiguous()):
        raise ValueError(f"{name}: want contiguous float32 {tuple(shape)} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _check_device(fn: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{fn} takes CPU or CUDA tensors, got {t.device}")


def _check_geometry(T: int, L: int, C: int) -> None:
    if T % L != 0 or C < 1:
        raise ValueError(f"T ({T}) must be a multiple of L ({L}) and C ({C}) positive")


def proposal_rows_backward_plain(length_mask, T: int, L: int, C: int, dfc, dfm, dfb):
    """The plain backward: the pooling is linear in f, so its transpose is
    autograd through `proposal_features_packed` at any f."""
    B, D = dfc.shape[0], dfc.shape[-1]
    with torch.enable_grad():
        f = torch.zeros((B, T, D), dtype=dfc.dtype, device=dfc.device, requires_grad=True)
        out = proposal_features_packed(f, length_mask, L, C)
        return torch.autograd.grad(out, f, (dfc, dfm, dfb))[0]


def proposal_rows_forward(f: torch.Tensor, length_mask: torch.Tensor, L: int,
                          C: int) -> Features:
    """f (B, T, D), length_mask (B, L) -> fc (B, N, C, D) masked by the pair
    validity, fm (B, N, D) = mean over C, fb (B, L, D) window means."""
    if f.device.type == "cpu":
        return proposal_features_packed(f, length_mask, L, C)
    _check_device("proposal_rows_forward", f)
    B, T, D = f.shape
    _check_geometry(T, L, C)
    N = L * (L + 1) // 2
    _check("f", f, (B, T, D), f.device)
    _check("length_mask", length_mask, (B, L), f.device)
    vmask = packed_valid_mask(length_mask).contiguous()
    lib = _library()
    fc = torch.empty((B, N, C, D), device=f.device, dtype=torch.float32)
    fm = torch.empty((B, N, D), device=f.device, dtype=torch.float32)
    fb = torch.empty((B, L, D), device=f.device, dtype=torch.float32)
    with torch.cuda.device(f.device):
        err = lib.vml_proposal_rows_fwd_f32(stream_of(f), B, T, L, C, D, ptr(f), ptr(vmask),
                                            ptr(fc), ptr(fm), ptr(fb))
    check(lib, "vml_proposal_rows_fwd_f32", err)
    proposal_rows_forward.launches += 1
    return fc, fm, fb


def proposal_rows_backward(length_mask: torch.Tensor, T: int, L: int, C: int,
                           dfc: torch.Tensor, dfm: torch.Tensor,
                           dfb: torch.Tensor) -> torch.Tensor:
    """Cotangents of (fc, fm, fb) -> df (B, T, D)."""
    if dfc.device.type == "cpu":
        return proposal_rows_backward_plain(length_mask, T, L, C, dfc, dfm, dfb)
    _check_device("proposal_rows_backward", dfc)
    B, N, _, D = dfc.shape
    _check_geometry(T, L, C)
    _check("dfc", dfc, (B, L * (L + 1) // 2, C, D), dfc.device)
    _check("dfm", dfm, (B, N, D), dfc.device)
    _check("dfb", dfb, (B, L, D), dfc.device)
    _check("length_mask", length_mask, (B, L), dfc.device)
    vmask = packed_valid_mask(length_mask).contiguous()
    lib = _library()
    df = torch.empty((B, T, D), device=dfc.device, dtype=torch.float32)
    with torch.cuda.device(dfc.device):
        err = lib.vml_proposal_rows_bwd_f32(stream_of(dfc), B, T, L, C, D, ptr(vmask),
                                            ptr(dfc), ptr(dfm), ptr(dfb), ptr(df))
    check(lib, "vml_proposal_rows_bwd_f32", err)
    proposal_rows_backward.launches += 1
    return df


proposal_rows_forward.launches = 0
proposal_rows_backward.launches = 0


class _ProposalRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f, length_mask, L, C):
        ctx.save_for_backward(f, length_mask)
        ctx.geometry = (L, C)
        return proposal_rows_forward(f, length_mask, L, C)

    @staticmethod
    def backward(ctx, dfc, dfm, dfb):
        f, length_mask = ctx.saved_tensors
        L, C = ctx.geometry
        df = proposal_rows_backward(length_mask, f.shape[1], L, C, dfc.contiguous(),
                                    dfm.contiguous(), dfb.contiguous())
        return df, None, None, None


def proposal_features_rows(f: torch.Tensor, length_mask: torch.Tensor, L: int,
                           C: int) -> Features:
    """Differentiable (fc (B, N, C, D), fm (B, N, D), fb (B, L, D)) of
    f (B, T, D); no gradient flows to ``length_mask``."""
    return _ProposalRows.apply(f, length_mask, L, C)

"""K1 and K6: packed proposal features for training, forward and backward
(csrc/proposal_rows.cu).

Counterparts of two kernels of ``video_moment_localization_tpu/ops/
proposal_pallas.py``, each with its custom VJP: `proposal_features_rows`
(K1: `_rows_fwd` / `_rows_bwd`), which feeds the whole-layer train kernels,
and `proposal_features_packed_pallas` (K6: `_packed_fwd` / `_packed_bwd`),
which feeds the content-unit train path. Both map the fused backbone
features f (B, T, D) to the clip means fc, their mean over clips fm and the
snippet window means fb. The JAX kernels multiply by a dense averaging
matrix and differ in the layout of fc: K1 emits c-major rows (B, C*N, D) for
the TPU's tiling, K6 n-major (B, N, C, D). This port keeps fc n-major
everywhere (`ops.packing.pack_rows` converts), and what both kernels compute
is a mean over a closed-form run of frames per (pair, clip), so on the card
K1 and K6 are one pair of C entry points of csrc/proposal_rows.cu (a
segment-mean forward, a gather backward) behind two Python entries, each
with its own launch counters.

`proposal_features_rows` (K1) and `proposal_features_packed_fused` (K6) are
the differentiable entries (autograd Functions that save their inputs).
`proposal_rows_forward` / `proposal_rows_backward` and
`proposal_packed_forward` / `proposal_packed_backward` are the kernel
wrappers: on a CPU tensor each runs its plain version
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


def _launch_forward(fn: str, f: torch.Tensor, length_mask: torch.Tensor, L: int,
                    C: int) -> Features:
    _check_device(fn, f)
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
    return fc, fm, fb


def _launch_backward(fn: str, length_mask: torch.Tensor, T: int, L: int, C: int,
                     dfc: torch.Tensor, dfm: torch.Tensor, dfb: torch.Tensor) -> torch.Tensor:
    _check_device(fn, dfc)
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
    return df


def _forward_wrapper(name: str, doc: str):
    """A kernel wrapper of the forward entry point with its own counter."""
    def run(f: torch.Tensor, length_mask: torch.Tensor, L: int, C: int) -> Features:
        if f.device.type == "cpu":
            return proposal_features_packed(f, length_mask, L, C)
        out = _launch_forward(name, f, length_mask, L, C)
        run.launches += 1
        return out

    run.__name__ = run.__qualname__ = name
    run.__doc__ = doc
    run.launches = 0
    return run


def _backward_wrapper(name: str, doc: str):
    """A kernel wrapper of the backward entry point with its own counter."""
    def run(length_mask: torch.Tensor, T: int, L: int, C: int, dfc: torch.Tensor,
            dfm: torch.Tensor, dfb: torch.Tensor) -> torch.Tensor:
        if dfc.device.type == "cpu":
            return proposal_rows_backward_plain(length_mask, T, L, C, dfc, dfm, dfb)
        df = _launch_backward(name, length_mask, T, L, C, dfc, dfm, dfb)
        run.launches += 1
        return df

    run.__name__ = run.__qualname__ = name
    run.__doc__ = doc
    run.launches = 0
    return run


proposal_rows_forward = _forward_wrapper(
    "proposal_rows_forward",
    """K1 forward. f (B, T, D), length_mask (B, L) -> fc (B, N, C, D) masked
    by the pair validity, fm (B, N, D) = mean over C, fb (B, L, D) window
    means.""")
proposal_rows_backward = _backward_wrapper(
    "proposal_rows_backward",
    """K1 backward. (length_mask, T, L, C, dfc, dfm, dfb): cotangents of
    (fc, fm, fb) -> df (B, T, D).""")
proposal_packed_forward = _forward_wrapper(
    "proposal_packed_forward",
    """K6 forward: the same function and device code as `proposal_rows_forward`
    (the two JAX kernels differ only in fc's layout, which this port does
    not carry over), counted on its own.""")
proposal_packed_backward = _backward_wrapper(
    "proposal_packed_backward",
    """K6 backward: cotangents of (fc, fm, fb) -> df (B, T, D), counted on its
    own.""")


class _Proposal(torch.autograd.Function):
    """Differentiable over one pair of kernel wrappers; saves its inputs."""

    @staticmethod
    def forward(ctx, f, length_mask, L, C, run_forward, run_backward):
        ctx.save_for_backward(f, length_mask)
        ctx.geometry = (L, C)
        ctx.run_backward = run_backward
        return run_forward(f, length_mask, L, C)

    @staticmethod
    def backward(ctx, dfc, dfm, dfb):
        f, length_mask = ctx.saved_tensors
        L, C = ctx.geometry
        df = ctx.run_backward(length_mask, f.shape[1], L, C, dfc.contiguous(),
                              dfm.contiguous(), dfb.contiguous())
        return df, None, None, None, None, None


def proposal_features_rows(f: torch.Tensor, length_mask: torch.Tensor, L: int,
                           C: int) -> Features:
    """K1, differentiable: (fc (B, N, C, D), fm (B, N, D), fb (B, L, D)) of
    f (B, T, D); no gradient flows to ``length_mask``."""
    return _Proposal.apply(f, length_mask, L, C, proposal_rows_forward, proposal_rows_backward)


def proposal_features_packed_fused(f: torch.Tensor, length_mask: torch.Tensor, L: int,
                                   C: int) -> Features:
    """K6, differentiable: the same three features, for the content-unit
    train path."""
    return _Proposal.apply(f, length_mask, L, C, proposal_packed_forward,
                           proposal_packed_backward)

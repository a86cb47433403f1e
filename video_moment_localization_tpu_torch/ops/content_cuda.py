"""K10: the fused ContentUnit of the packed unit loop, forward and
hand-written backward (csrc/content_train.cu, the K10 section).

Counterpart of ``video_moment_localization_tpu/ops/content_pallas.py``:
`content_unit_fused` with `_content_unit_fused` (K10) as its forward and the
VJP of the XLA unit as its backward. It is the content unit of
`models.smin.smi_block_packed` under ``fused_content``, in the packed loop
that ``compat_head`` and ``fused_smi_train: False`` take. The output is
``c_out(f_cc_hat) * vmask + f_c + fbar`` with the moment gate fbar =
sigmoid(f_m * f_s) * f_m computed inside; the pair mask multiplies f_cc only,
as in the JAX kernel and the XLA unit, so an invalid pair carries f_c + fbar.
The backward kernel recomputes the unit from the saved inputs (as the JAX
VJP does) and computes the same gradients by hand: the content section of
the K3 / K7 backward with no conv_fc cotangent, then the gate's derivative
into dfm and dfs. Weight gradients are fp32.

`content_unit_forward` / `content_unit_backward` are the kernel wrappers: on
a CPU tensor each runs its plain version (`models.smin.content_unit_packed`,
and ``torch.autograd.grad`` through it), on a CUDA tensor it launches its
kernel or raises. ``.launches`` on each counts the launches (one per layer:
the C entry point sequences the unit's kernels).

K10 has a bf16 variant (K10-bf16, `vml_content_unit_{fwd,bwd}_bf16`), taken
when fc is bf16, with the types of K7-bf16 (`_ContentUnit` casts the
matrices once per layer). Its forward is the JAX kernel's arithmetic at
bf16: the content section of the bf16 layer kernels (fp32 inside, each
stored value rounded once), then f_cc rounded to bf16 and the residuals
fc and fbar (the gate in fp32, stored in bf16) added in bf16, as the JAX
kernel adds them; its backward rounds each stored value's gradient once, as
K3-bf16 does. Its plain version, `content_unit_plain_bf16` and autograd
through it, rounds where the kernel rounds, so the two differ by the order
of their fp32 sums only; the JAX package's backward, the VJP of the XLA
unit at bf16, rounds every op and is held to it on the CPU. ``.launches_bf16``
counts it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from video_moment_localization_tpu_torch.models.smin import (
    BLOCK_WEIGHT_NAMES,
    ContentUnit,
    content_bf16,
    content_unit_packed,
    gate_bf16,
)
from video_moment_localization_tpu_torch.ops.content_train_cuda import (
    Workspace,
    as_unit,
    check_inputs,
    entry,
)
from video_moment_localization_tpu_torch.ops.content_train_cuda import _library as _rows_library
from video_moment_localization_tpu_torch.ops.cuda_build import (
    check,
    pointer_array,
    ptr,
    stream_of,
)
from video_moment_localization_tpu_torch.ops.smin_train_cuda import layer_weights_for

WEIGHTS = 12   # weight and bias of c_hat, w_hat, s_hat, c_out, attn W_q, W_k

# The moment gate's backward (csrc/content_bwd.cuh `gate_bwd_kernel`, K10's
# and K3's): blocks of GATE_THREADS threads, a thread per 4 columns (per
# column where D or a pointer does not allow 16-byte rows), an element's
# pairs cut into `gate_bwd_splits` contiguous ranges, about four blocks per
# SM in all. Mirrors of the C code; change both together.
GATE_THREADS = 128
GATE_MAX_SPLITS = 32
SMS = 132


def gate_bwd_splits(B: int, N: int, cols: int) -> int:
    """Splits of an element's N pairs for B elements of ``cols`` column
    groups (`vml::gate_bwd_splits`)."""
    col_blocks = -(-cols // GATE_THREADS)
    splits = -(-4 * SMS // (B * col_blocks))
    return min(max(splits, 1), GATE_MAX_SPLITS, N)


def gate_bwd_ranges(N: int, splits: int):
    """The [begin, end) pair range of each split, in the order its share of
    dfs is added; a range may be empty."""
    per = -(-N // splits)
    return [(k * per, min(N, (k + 1) * per)) for k in range(splits)]


def unit_weights(unit: ContentUnit):
    """The 12 tensors the kernel reads: the first 12 of
    `ops.content_train_cuda.content_weights`."""
    out = []
    for layer in (unit.linear_c_hat, unit.linear_w_hat, unit.linear_s_hat, unit.linear_c,
                  unit.attn_layer.W_q, unit.attn_layer.W_k):
        out += [layer.weight, layer.bias]
    return out


def content_unit_plain(weights, fc, fm, fw, fs, query_mask, vmask):
    """The plain version of the forward: cu (B, N, C, D); on a bf16 fc,
    `content_unit_plain_bf16`."""
    if fc.dtype == torch.bfloat16:
        return content_unit_plain_bf16(weights, fc, fm, fw, fs, query_mask, vmask)
    return content_unit_packed(as_unit(weights), fc, fw, fs, fm, query_mask, vmask)


def content_unit_plain_bf16(weights, fc, fm, fw, fs, query_mask, vmask):
    """The plain version of K10-bf16's forward on bf16 fc, fm, fw, fs and
    `unit_weights` (matrices rounded to bf16, biases fp32): fbar =
    `models.smin.gate_bf16`, f_cc = `models.smin.content_bf16`, then cu =
    (bf16(f_cc) + fc) + fbar with each sum rounded to bf16 (the JAX kernel's
    residual, content_pallas.py's `out`). Each input is read back in fp32
    once (fs by the gate and s_hat both), so autograd rounds each input's
    gradient once, as the kernel stores it."""
    bf = torch.bfloat16
    w = dict(zip(BLOCK_WEIGHT_NAMES[:WEIGHTS], weights))
    fc32, fs32 = fc.float(), fs.float()
    fbar = gate_bf16(fm.float(), fs32)
    f_cc = content_bf16(w, fc32, fw.float(), fs32, query_mask.float(), vmask.float())
    cu = (f_cc.to(bf).float() + fc32).to(bf)
    return (cu.float() + fbar.float()[:, :, None]).to(bf)


def content_unit_backward_plain(weights, fc, fm, fw, fs, query_mask, vmask, dcu):
    """The plain version of the backward (of K10-bf16 on a bf16 fc):
    recompute under autograd and take the VJP. Returns (dfc, dfm, dfw, dfs,
    [12 weight gradients]), the weight gradients fp32 at either type."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (fc, fm, fw, fs)]
        leaves += [w.detach().float().requires_grad_(True) for w in weights]
        cu = content_unit_plain(leaves[4:], *leaves[:4], query_mask, vmask)
        grads = torch.autograd.grad(cu, leaves, dcu)
    return (*grads[:4], list(grads[4:]))


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """K7's library (its workspace queries are K10's too) with K10's entries,
    their argument types set once."""
    lib = _rows_library()
    lib.vml_gate_bwd_splits.argtypes = [ctypes.c_int] * 3
    lib.vml_gate_bwd_splits.restype = ctypes.c_int
    pointers = ctypes.POINTER(ctypes.c_void_p)
    for suffix in ("f32", "bf16"):
        fwd = getattr(lib, f"vml_content_unit_fwd_{suffix}")
        fwd.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 6
                        + [pointers] + [ctypes.c_void_p] * 2)
        fwd.restype = ctypes.c_int
        bwd = getattr(lib, f"vml_content_unit_bwd_{suffix}")
        bwd.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 6
                        + [pointers] + [ctypes.c_void_p] * 6 + [pointers])
        bwd.restype = ctypes.c_int
    return lib


def card_gate_bwd_splits(B: int, N: int, cols: int) -> int:
    """`gate_bwd_splits` as the library computes it (needs the CUDA build)."""
    return _library().vml_gate_bwd_splits(B, N, cols)


def _check(fn: str, weights, fc, fm, fw, fs, query_mask, vmask, cotangents=()):
    return check_inputs(fn, weights, fc, fm, fw, fs, query_mask, vmask, cotangents,
                        n_weights=WEIGHTS, fbar_name="fm")


def content_unit_forward(weights, fc, fm, fw, fs, query_mask, vmask,
                         workspace: Optional[Workspace] = None) -> torch.Tensor:
    """fc (B, N, C, D), fm (B, N, D), fw (B, Nq, D), fs (B, D), query_mask
    (B, Nq, 1), vmask (B, N) and `unit_weights` -> cu (B, N, C, D).
    ``workspace`` is an optional scratch to reuse over layers."""
    if fc.device.type == "cpu":
        return content_unit_plain(weights, fc, fm, fw, fs, query_mask, vmask)
    name = entry("unit_fwd", fc.dtype)
    dims = _check("content_unit_forward", weights, fc, fm, fw, fs, query_mask, vmask)
    lib = _library()
    ws = (workspace or Workspace()).get(lib, fc, dims, False)
    cu = torch.empty_like(fc)
    with torch.cuda.device(fc.device):
        err = getattr(lib, name)(
            stream_of(fc), *dims, ptr(fc), ptr(fm), ptr(fw), ptr(fs), ptr(query_mask),
            ptr(vmask), pointer_array(weights), ptr(ws), ptr(cu))
    check(lib, name, err)
    if fc.dtype == torch.bfloat16:
        content_unit_forward.launches_bf16 += 1
    else:
        content_unit_forward.launches += 1
    return cu


def content_unit_backward(weights, fc, fm, fw, fs, query_mask, vmask, dcu,
                          workspace: Optional[Workspace] = None):
    """Recompute the unit from its inputs and backpropagate dcu through it.
    Returns (dfc, dfm, dfw, dfs, [12 fp32 weight gradients in `unit_weights`
    order])."""
    if fc.device.type == "cpu":
        return content_unit_backward_plain(weights, fc, fm, fw, fs, query_mask, vmask, dcu)
    name = entry("unit_bwd", fc.dtype)
    dims = _check("content_unit_backward", weights, fc, fm, fw, fs, query_mask, vmask,
                  [("dcu", dcu, fc.shape)])
    lib = _library()
    ws = (workspace or Workspace()).get(lib, fc, dims, True)
    dfc, dfm = torch.empty_like(fc), torch.empty_like(fm)
    dfw, dfs = torch.empty_like(fw), torch.empty_like(fs)
    dweights = [torch.empty_like(w, dtype=torch.float32) for w in weights]
    with torch.cuda.device(fc.device):
        err = getattr(lib, name)(
            stream_of(fc), *dims, ptr(fc), ptr(fm), ptr(fw), ptr(fs), ptr(query_mask),
            ptr(vmask), pointer_array(weights), ptr(dcu), ptr(ws), ptr(dfc), ptr(dfm),
            ptr(dfw), ptr(dfs), pointer_array(dweights))
    check(lib, name, err)
    if fc.dtype == torch.bfloat16:
        content_unit_backward.launches_bf16 += 1
    else:
        content_unit_backward.launches += 1
    return dfc, dfm, dfw, dfs, dweights


content_unit_forward.launches = content_unit_forward.launches_bf16 = 0
content_unit_backward.launches = content_unit_backward.launches_bf16 = 0


class _ContentUnit(torch.autograd.Function):
    """Saves its inputs and the weights as the kernel reads them (at bf16
    their bf16 cast); the backward kernel recomputes the unit."""

    @staticmethod
    def forward(ctx, fc, fm, fw, fs, query_mask, vmask, *weights):
        weights = layer_weights_for(weights, fc.dtype)
        ctx.save_for_backward(fc, fm, fw, fs, query_mask, vmask, *weights)
        return content_unit_forward(weights, fc, fm, fw, fs, query_mask, vmask)

    @staticmethod
    def backward(ctx, dcu):
        fc, fm, fw, fs, query_mask, vmask, *weights = ctx.saved_tensors
        dfc, dfm, dfw, dfs, dweights = content_unit_backward(
            weights, fc, fm, fw, fs, query_mask, vmask, dcu.contiguous())
        return (dfc, dfm, dfw, dfs, None, None, *dweights)


def content_unit_fused(unit: ContentUnit, f_c, f_w, f_s, f_m, query_mask, vmask):
    """Differentiable fused ContentUnit with the contract of
    `models.smin.content_unit_packed` (the gate computed from f_m inside),
    in f_c's dtype (fp32 or bf16); the parameters get fp32 gradients; no
    gradient flows to the masks (fp32)."""
    return _ContentUnit.apply(f_c.contiguous(), f_m.contiguous(), f_w.contiguous(),
                              f_s.contiguous(), query_mask.float().contiguous(),
                              vmask.float().contiguous(), *unit_weights(unit))

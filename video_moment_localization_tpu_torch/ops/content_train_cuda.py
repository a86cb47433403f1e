"""K7: the ContentUnit of an SMI layer with the moment unit's conv_fc half
folded in, forward and hand-written backward, and the differentiable stack
around it (csrc/content_train.cu).

Counterpart of ``video_moment_localization_tpu/ops/content_train_pallas.py``:
`content_rows_train` with `_fwd_call` / `_bwd_vjp` (K7) and
`smi_stack_content_train`, the training path of the maps whose whole layer
the JAX package does not train in one kernel (TACoS at fp32, ActivityNet;
see `models.smin.whole_layer_train_admits`). Per layer the moment gate, the
boundary unit and the moment unit's boundary half are PyTorch ops under
autograd, as they are XLA ops in the JAX package; the content unit over the
B * N * C clip rows and conv_fc of its clip mean are the kernel. As in the
JAX package the Function saves its inputs and the backward kernel recomputes
the unit before differentiating it; weight gradients are fp32.

Two things differ from the JAX kernel, both its TPU tiling. fc stays
n-major, (B, N, C, D), as everywhere in this package (the JAX kernel carries
it c-major). And the pair mask multiplies f_cc only, as in the plain unit
`models.smin.content_unit_packed`, where the JAX kernel masks cu once at the
end: the two agree at valid pairs, and nothing downstream reads an invalid
pair unmasked.

`content_rows_forward` / `content_rows_backward` are the kernel wrappers: on
a CPU tensor each runs its plain version (`content_unit_packed` followed by
conv_fc of the clip mean, and ``torch.autograd.grad`` through it), on a CUDA
tensor it launches its kernel or raises. ``.launches`` on each counts the
launches (one per layer: the C entry point sequences the unit's kernels).
"""

from __future__ import annotations

import ctypes
import types
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from video_moment_localization_tpu_torch.models.smin import (
    SMI,
    _linear,
    block_weights,
    boundary_unit_packed,
    content_unit_packed,
    moment_gate,
)
from video_moment_localization_tpu_torch.ops.cuda_build import (
    MAX_SMEM_BYTES,
    check,
    check_tensors,
    load_library,
    pointer_array,
    ptr,
    stream_of,
)
from video_moment_localization_tpu_torch.ops.packing import pair_index

WEIGHTS = 14   # the content unit's 12 tensors and conv_fc's 2


def content_weights(block: SMI) -> List[torch.Tensor]:
    """The 14 tensors the kernel reads, in `block_weights` order: weight and
    bias of c_hat, w_hat, s_hat, c_out, the content attention's W_q and W_k,
    then of the moment unit's conv_fc."""
    w = block_weights(block)
    return w[:12] + w[18:20]


def as_unit(weights: Sequence[torch.Tensor]):
    """The content unit's 12 tensors (the first 12 of `content_weights`) as
    the attribute tree that `content_unit_packed` reads."""
    ns = types.SimpleNamespace
    c_hat, w_hat, s_hat, c_out, cq, ck = [
        ns(weight=weights[k], bias=weights[k + 1]) for k in range(0, 12, 2)]
    return ns(linear_c_hat=c_hat, linear_w_hat=w_hat, linear_s_hat=s_hat, linear_c=c_out,
              attn_layer=ns(W_q=cq, W_k=ck))


def _as_units(weights: Sequence[torch.Tensor]):
    """The 14 tensors as the attribute trees that `content_unit_packed` and
    `_linear` read: (content unit, conv_fc)."""
    return as_unit(weights), types.SimpleNamespace(weight=weights[12], bias=weights[13])


def content_rows_plain(weights, fc, fbar, fw, fs, query_mask, vmask):
    """The plain version of the forward: (cu (B, N, C, D), convfc (B, N, D))."""
    unit, conv_fc = _as_units(weights)
    cu = content_unit_packed(unit, fc, fw, fs, None, query_mask, vmask, fbar=fbar)
    return cu, _linear(conv_fc, cu.mean(dim=2)) * vmask[..., None]


def content_rows_backward_plain(weights, fc, fbar, fw, fs, query_mask, vmask, dcu, dconvfc):
    """The plain version of the backward: recompute under autograd and take
    the VJP. ``dcu=None`` is the zero cotangent. Returns
    (dfc, dfbar, dfw, dfs, [14 weight gradients])."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (fc, fbar, fw, fs, *weights)]
        cu, convfc = content_rows_plain(leaves[4:], *leaves[:4], query_mask, vmask)
        outs, cots = [convfc], [dconvfc]
        if dcu is not None:
            outs.append(cu)
            cots.append(dcu)
        grads = torch.autograd.grad(outs, leaves, cots)
    return (*grads[:4], list(grads[4:]))


def _library() -> ctypes.CDLL:
    lib = load_library("content_train")
    lib.vml_content_rows_workspace_floats.argtypes = [ctypes.c_int] * 7
    lib.vml_content_rows_workspace_floats.restype = ctypes.c_size_t
    lib.vml_content_rows_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.vml_content_rows_smem_bytes.restype = ctypes.c_size_t
    pointers = ctypes.POINTER(ctypes.c_void_p)
    fwd = lib.vml_content_rows_fwd_f32
    fwd.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 6
                    + [pointers] + [ctypes.c_void_p] * 3)
    fwd.restype = ctypes.c_int
    bwd = lib.vml_content_rows_bwd_f32
    bwd.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 6
                    + [pointers] + [ctypes.c_void_p] * 7 + [pointers])
    bwd.restype = ctypes.c_int
    return lib


def _weight_shapes(D: int, dl: int):
    return [(dl, D), (dl,)] * 3 + [(D, dl), (D,)] + [(dl, dl), (dl,)] * 2 + [(D, D), (D,)]


def check_inputs(fn: str, weights, fc, fbar, fw, fs, query_mask, vmask, cotangents=(),
                 n_weights: int = WEIGHTS, fbar_name: str = "fbar"):
    """Shapes, dtype, device and contiguity of everything the C entry reads:
    the first ``n_weights`` of `content_weights` (12: the unit alone), and a
    (B, N, D) ``fbar`` (or, by ``fbar_name``, what takes its place). Returns
    (B, N, C, Nq, D, dl)."""
    if fc.device.type != "cuda":
        raise ValueError(f"{fn} takes CPU or CUDA tensors, got {fc.device}")
    if fc.dim() != 4 or len(weights) != n_weights:
        raise ValueError(f"{fn}: want fc (B, N, C, D) and {n_weights} weight tensors, got "
                         f"{tuple(fc.shape)} and {len(weights)}")
    B, N, C, D = fc.shape
    Nq, dl = fw.shape[1], weights[0].shape[0]
    want = [("fc", fc, (B, N, C, D)), (fbar_name, fbar, (B, N, D)), ("fw", fw, (B, Nq, D)),
            ("fs", fs, (B, D)), ("query_mask", query_mask, (B, Nq, 1)),
            ("vmask", vmask, (B, N))]
    want += [(f"weight {k}", w, s) for k, (w, s) in
             enumerate(zip(weights, _weight_shapes(D, dl)))]
    check_tensors(fn, fc.device, want + list(cotangents))
    return B, N, C, Nq, D, dl


class Workspace:
    """The device scratch of one pass over the layers: one buffer for the
    forward kernels and one for the backward kernels, each allocated at its
    first use and reused by the other layers."""

    def __init__(self) -> None:
        self._buffers: Dict[bool, torch.Tensor] = {}

    def get(self, lib, fc, dims, backward: bool) -> torch.Tensor:
        B, N, C, Nq, D, dl = dims
        smem = lib.vml_content_rows_smem_bytes(C, Nq, dl)
        if smem > MAX_SMEM_BYTES:
            raise ValueError(f"C={C}, Nq={Nq}, dl={dl} need {smem} B of shared memory per block")
        floats = lib.vml_content_rows_workspace_floats(B, N, C, Nq, D, dl, int(backward))
        ws = self._buffers.get(backward)
        if ws is None or ws.numel() < floats or ws.device != fc.device:
            ws = self._buffers[backward] = torch.empty(floats, device=fc.device,
                                                       dtype=torch.float32)
        return ws


def content_rows_forward(weights, fc, fbar, fw, fs, query_mask, vmask,
                         workspace: Optional[Workspace] = None):
    """fc (B, N, C, D), fbar (B, N, D), fw (B, Nq, D), fs (B, D), query_mask
    (B, Nq, 1), vmask (B, N) and `content_weights` -> (cu (B, N, C, D),
    convfc (B, N, D) = conv_fc(mean_c cu) * vmask). ``workspace`` is an
    optional scratch to reuse over layers."""
    if fc.device.type == "cpu":
        return content_rows_plain(weights, fc, fbar, fw, fs, query_mask, vmask)
    dims = check_inputs("content_rows_forward", weights, fc, fbar, fw, fs, query_mask, vmask)
    lib = _library()
    ws = (workspace or Workspace()).get(lib, fc, dims, False)
    cu, convfc = torch.empty_like(fc), torch.empty_like(fbar)
    with torch.cuda.device(fc.device):
        err = lib.vml_content_rows_fwd_f32(
            stream_of(fc), *dims, ptr(fc), ptr(fbar), ptr(fw), ptr(fs), ptr(query_mask),
            ptr(vmask), pointer_array(weights), ptr(ws), ptr(cu), ptr(convfc))
    check(lib, "vml_content_rows_fwd_f32", err)
    content_rows_forward.launches += 1
    return cu, convfc


def content_rows_backward(weights, fc, fbar, fw, fs, query_mask, vmask,
                          dcu: Optional[torch.Tensor], dconvfc,
                          workspace: Optional[Workspace] = None):
    """Recompute the unit from its inputs and backpropagate (dcu, dconvfc)
    through it; ``dcu=None`` is the zero cotangent of a top layer's cu.
    Returns (dfc, dfbar, dfw, dfs, [14 fp32 weight gradients in
    `content_weights` order])."""
    if fc.device.type == "cpu":
        return content_rows_backward_plain(weights, fc, fbar, fw, fs, query_mask, vmask,
                                           dcu, dconvfc)
    cots = [("dconvfc", dconvfc, fbar.shape)]
    if dcu is not None:
        cots.append(("dcu", dcu, fc.shape))
    dims = check_inputs("content_rows_backward", weights, fc, fbar, fw, fs, query_mask,
                         vmask, cots)
    lib = _library()
    ws = (workspace or Workspace()).get(lib, fc, dims, True)
    dfc, dfbar = torch.empty_like(fc), torch.empty_like(fbar)
    dfw, dfs = torch.empty_like(fw), torch.empty_like(fs)
    dweights = [torch.empty_like(w) for w in weights]
    with torch.cuda.device(fc.device):
        err = lib.vml_content_rows_bwd_f32(
            stream_of(fc), *dims, ptr(fc), ptr(fbar), ptr(fw), ptr(fs), ptr(query_mask),
            ptr(vmask), pointer_array(weights), ptr(dcu) if dcu is not None else None,
            ptr(dconvfc), ptr(ws), ptr(dfc), ptr(dfbar), ptr(dfw), ptr(dfs),
            pointer_array(dweights))
    check(lib, "vml_content_rows_bwd_f32", err)
    content_rows_backward.launches += 1
    return dfc, dfbar, dfw, dfs, dweights


content_rows_forward.launches = 0
content_rows_backward.launches = 0


class _ContentRows(torch.autograd.Function):
    """Saves its inputs; the backward kernel recomputes the unit."""

    @staticmethod
    def forward(ctx, workspace, fc, fbar, fw, fs, query_mask, vmask, *weights):
        ctx.save_for_backward(fc, fbar, fw, fs, query_mask, vmask, *weights)
        ctx.workspace = workspace
        ctx.set_materialize_grads(False)    # an unused cu gives dcu=None, not zeros
        return content_rows_forward(weights, fc, fbar, fw, fs, query_mask, vmask, workspace)

    @staticmethod
    def backward(ctx, dcu, dconvfc):
        fc, fbar, fw, fs, query_mask, vmask, *weights = ctx.saved_tensors
        none = (None,) * (7 + WEIGHTS)
        if dcu is None and dconvfc is None:
            return none
        if dconvfc is None:
            dconvfc = torch.zeros_like(fbar)
        dfc, dfbar, dfw, dfs, dweights = content_rows_backward(
            weights, fc, fbar, fw, fs, query_mask, vmask,
            dcu.contiguous() if dcu is not None else None, dconvfc.contiguous(),
            ctx.workspace)
        return (None, dfc, dfbar, dfw, dfs, None, None, *dweights)


def content_rows_train(weights, fc, fbar, fw, fs, query_mask, vmask,
                       workspace: Optional[Workspace] = None):
    """Differentiable (cu (B, N, C, D), convfc (B, N, D)); no gradient flows
    to the masks."""
    return _ContentRows.apply(workspace, fc.contiguous(), fbar.contiguous(), fw.contiguous(),
                              fs.contiguous(), query_mask.contiguous(), vmask.contiguous(),
                              *weights)


def smi_stack_content_train(blocks: nn.ModuleList, fc, fm, fb, fw, fs, query_mask,
                            length_mask, vmask, L: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The differentiable SMI stack with the content unit as a kernel per
    layer: every block of ``blocks`` in turn -> (fm_out (B, N, D), fb_out
    (B, L, D)), the heads' inputs. The moment gate, the boundary unit and
    the moment unit's boundary half (the outer product of the boundary rows
    and conv_fb) are PyTorch ops; conv_fc comes out of the kernel already
    masked."""
    workspace = Workspace()
    i_idx, j_idx = pair_index(L, fb.device)
    for block in blocks:
        fbar = moment_gate(fm, fs)
        cu, conv_fc = content_rows_train(content_weights(block), fc, fbar, fw, fs,
                                         query_mask, vmask, workspace)
        bu = boundary_unit_packed(block.boundary_unit, fb, fw, fs, fm, query_mask,
                                  length_mask, L, fbar=fbar)
        outer = bu[:, i_idx] * bu[:, j_idx]
        conv_fb = _linear(block.moment_unit.conv_layer_fb, outer) * vmask[..., None]
        fm = conv_fb + conv_fc + fm
        fc, fb = cu, bu
    return fm, fb

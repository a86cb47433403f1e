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

K7 has a bf16 variant (K7-bf16, `vml_content_rows_{fwd,bwd}_bf16`), taken
when fc is bf16: activations and cotangents bf16, the masks fp32, the
matrices bf16 and the biases fp32 (`_ContentRows` casts the fp32 parameters
once per layer, `ops.smin_train_cuda.layer_weights_for`), the 14 weight
gradients fp32. Its plain version is `content_rows_plain_bf16` (the content
section of `models.smin.smi_layer_bf16`, the clip mean and conv_fc, each
stored value rounded once) and autograd through it; ``.launches_bf16``
counts it. At bf16 `smi_stack_content_train` runs its glue (gate, boundary
unit, conv_fb, the moment sum) in bf16, as the JAX stack does.
"""

from __future__ import annotations

import ctypes
import functools
import types
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from video_moment_localization_tpu_torch.models.smin import (
    BLOCK_WEIGHT_NAMES,
    SMI,
    _linear,
    _mm16,
    block_weights,
    boundary_unit_packed,
    content_bf16,
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
from video_moment_localization_tpu_torch.ops.smin_train_cuda import layer_weights_for

WEIGHTS = 14   # the content unit's 12 tensors and conv_fc's 2
CONTENT_WEIGHT_NAMES = BLOCK_WEIGHT_NAMES[:12] + BLOCK_WEIGHT_NAMES[18:20]


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
    """The plain version of the forward: (cu (B, N, C, D), convfc (B, N, D));
    on a bf16 fc, `content_rows_plain_bf16`."""
    if fc.dtype == torch.bfloat16:
        return content_rows_plain_bf16(weights, fc, fbar, fw, fs, query_mask, vmask)
    unit, conv_fc = _as_units(weights)
    cu = content_unit_packed(unit, fc, fw, fs, None, query_mask, vmask, fbar=fbar)
    return cu, _linear(conv_fc, cu.mean(dim=2)) * vmask[..., None]


def content_rows_plain_bf16(weights, fc, fbar, fw, fs, query_mask, vmask):
    """The plain version of K7-bf16's forward, on bf16 fc, fbar, fw, fs and
    `content_weights` (matrices bf16 or fp32, rounded to bf16 either way;
    biases fp32): cu = f_cc + fc + fbar summed in fp32 and rounded once
    (`models.smin.content_bf16`, the layer's content section), the clip mean
    of the stored cu rounded once, convfc = (conv_fc(mean) + b) * vmask with
    bf16 operands and fp32 sums, rounded once. Each input is read back in
    fp32 once, so autograd rounds each input's gradient once, as the kernel
    stores it."""
    bf = torch.bfloat16
    w = dict(zip(CONTENT_WEIGHT_NAMES, weights))
    vm = vmask.float()
    fc32 = fc.float()
    cu = (content_bf16(w, fc32, fw.float(), fs.float(), query_mask.float(), vm) + fc32
          + fbar.float()[:, :, None]).to(bf)
    x2 = cu.float().mean(dim=2).to(bf)
    convfc = (_mm16(x2.float(), w["moment_unit.conv_layer_fc.weight"])
              + w["moment_unit.conv_layer_fc.bias"]) * vm[..., None]
    return cu, convfc.to(bf)


def content_rows_backward_plain(weights, fc, fbar, fw, fs, query_mask, vmask, dcu, dconvfc):
    """The plain version of the backward (of K7-bf16 on a bf16 fc):
    recompute under autograd and take the VJP. ``dcu=None`` is the zero
    cotangent. Returns (dfc, dfbar, dfw, dfs, [14 weight gradients]); the
    weight gradients are fp32 at either type (the weights enter as fp32
    leaves, rounded to bf16 at bf16 with the gradient passed through)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (fc, fbar, fw, fs)]
        leaves += [w.detach().float().requires_grad_(True) for w in weights]
        cu, convfc = content_rows_plain(leaves[4:], *leaves[:4], query_mask, vmask)
        outs, cots = [convfc], [dconvfc]
        if dcu is not None:
            outs.append(cu)
            cots.append(dcu)
        grads = torch.autograd.grad(outs, leaves, cots)
    return (*grads[:4], list(grads[4:]))


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The K7 / K10 library with its entries' argument types, set once (the
    wrappers call this on every launch)."""
    lib = load_library("content_train")
    lib.vml_content_rows_workspace_bytes.argtypes = [ctypes.c_int] * 8
    lib.vml_content_rows_workspace_bytes.restype = ctypes.c_size_t
    lib.vml_content_rows_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.vml_content_rows_smem_bytes.restype = ctypes.c_size_t
    pointers = ctypes.POINTER(ctypes.c_void_p)
    for suffix in ("f32", "bf16"):
        fwd = getattr(lib, f"vml_content_rows_fwd_{suffix}")
        fwd.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 6
                        + [pointers] + [ctypes.c_void_p] * 3)
        fwd.restype = ctypes.c_int
        bwd = getattr(lib, f"vml_content_rows_bwd_{suffix}")
        bwd.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 6
                        + [pointers] + [ctypes.c_void_p] * 7 + [pointers])
        bwd.restype = ctypes.c_int
    return lib


def entry(name: str, dtype: torch.dtype) -> str:
    """The C entry point of K7 or K10 (``name``: rows or unit, fwd or bwd)
    for the activations' dtype: fp32, or the bf16 variant's."""
    if dtype == torch.float32:
        return f"vml_content_{name}_f32"
    if dtype == torch.bfloat16:
        return f"vml_content_{name}_bf16"
    raise ValueError(f"vml_content_{name}: the kernel takes float32 or bfloat16, got {dtype}")


def _weight_shapes(D: int, dl: int):
    return [(dl, D), (dl,)] * 3 + [(D, dl), (D,)] + [(dl, dl), (dl,)] * 2 + [(D, D), (D,)]


def check_inputs(fn: str, weights, fc, fbar, fw, fs, query_mask, vmask, cotangents=(),
                 n_weights: int = WEIGHTS, fbar_name: str = "fbar"):
    """Shapes, dtype, device and contiguity of everything the C entry reads
    (fp32, or the bf16 variant's types when fc is bf16): the first
    ``n_weights`` of `content_weights` (12: the unit alone), and a (B, N, D)
    ``fbar`` (or, by ``fbar_name``, what takes its place). Returns (B, N, C,
    Nq, D, dl)."""
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
    check_tensors(fn, fc.device, want + list(cotangents), fc.dtype)
    return B, N, C, Nq, D, dl


class Workspace:
    """The device scratch of one pass over the layers, in bytes: one buffer
    for the forward kernels and one for the backward kernels, each allocated
    at its first use and reused by the other layers."""

    def __init__(self) -> None:
        self._buffers: Dict[bool, torch.Tensor] = {}

    def get(self, lib, fc, dims, backward: bool) -> torch.Tensor:
        B, N, C, Nq, D, dl = dims
        smem = lib.vml_content_rows_smem_bytes(C, Nq, dl)
        if smem > MAX_SMEM_BYTES:
            raise ValueError(f"C={C}, Nq={Nq}, dl={dl} need {smem} B of shared memory per block")
        n = lib.vml_content_rows_workspace_bytes(B, N, C, Nq, D, dl, int(backward),
                                                 int(fc.dtype == torch.bfloat16))
        ws = self._buffers.get(backward)
        if ws is None or ws.numel() < n or ws.device != fc.device:
            ws = self._buffers[backward] = torch.empty(n, device=fc.device, dtype=torch.uint8)
        return ws


def content_rows_forward(weights, fc, fbar, fw, fs, query_mask, vmask,
                         workspace: Optional[Workspace] = None):
    """fc (B, N, C, D), fbar (B, N, D), fw (B, Nq, D), fs (B, D), query_mask
    (B, Nq, 1), vmask (B, N) and `content_weights` -> (cu (B, N, C, D),
    convfc (B, N, D) = conv_fc(mean_c cu) * vmask). ``workspace`` is an
    optional scratch to reuse over layers."""
    if fc.device.type == "cpu":
        return content_rows_plain(weights, fc, fbar, fw, fs, query_mask, vmask)
    name = entry("rows_fwd", fc.dtype)
    dims = check_inputs("content_rows_forward", weights, fc, fbar, fw, fs, query_mask, vmask)
    lib = _library()
    ws = (workspace or Workspace()).get(lib, fc, dims, False)
    cu, convfc = torch.empty_like(fc), torch.empty_like(fbar)
    with torch.cuda.device(fc.device):
        err = getattr(lib, name)(
            stream_of(fc), *dims, ptr(fc), ptr(fbar), ptr(fw), ptr(fs), ptr(query_mask),
            ptr(vmask), pointer_array(weights), ptr(ws), ptr(cu), ptr(convfc))
    check(lib, name, err)
    if fc.dtype == torch.bfloat16:
        content_rows_forward.launches_bf16 += 1
    else:
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
    name = entry("rows_bwd", fc.dtype)
    cots = [("dconvfc", dconvfc, fbar.shape)]
    if dcu is not None:
        cots.append(("dcu", dcu, fc.shape))
    dims = check_inputs("content_rows_backward", weights, fc, fbar, fw, fs, query_mask,
                         vmask, cots)
    lib = _library()
    ws = (workspace or Workspace()).get(lib, fc, dims, True)
    dfc, dfbar = torch.empty_like(fc), torch.empty_like(fbar)
    dfw, dfs = torch.empty_like(fw), torch.empty_like(fs)
    dweights = [torch.empty_like(w, dtype=torch.float32) for w in weights]
    with torch.cuda.device(fc.device):
        err = getattr(lib, name)(
            stream_of(fc), *dims, ptr(fc), ptr(fbar), ptr(fw), ptr(fs), ptr(query_mask),
            ptr(vmask), pointer_array(weights), ptr(dcu) if dcu is not None else None,
            ptr(dconvfc), ptr(ws), ptr(dfc), ptr(dfbar), ptr(dfw), ptr(dfs),
            pointer_array(dweights))
    check(lib, name, err)
    if fc.dtype == torch.bfloat16:
        content_rows_backward.launches_bf16 += 1
    else:
        content_rows_backward.launches += 1
    return dfc, dfbar, dfw, dfs, dweights


content_rows_forward.launches = content_rows_forward.launches_bf16 = 0
content_rows_backward.launches = content_rows_backward.launches_bf16 = 0


class _ContentRows(torch.autograd.Function):
    """Saves its inputs and the weights as the kernel reads them (at bf16
    their bf16 cast); the backward kernel recomputes the unit."""

    @staticmethod
    def forward(ctx, workspace, fc, fbar, fw, fs, query_mask, vmask, *weights):
        weights = layer_weights_for(weights, fc.dtype)
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
    """Differentiable (cu (B, N, C, D), convfc (B, N, D)) in fc's dtype (fp32
    or bf16); the weights are the fp32 parameters (`content_weights`), which
    get fp32 gradients; no gradient flows to the masks (fp32)."""
    return _ContentRows.apply(workspace, fc.contiguous(), fbar.contiguous(), fw.contiguous(),
                              fs.contiguous(), query_mask.float().contiguous(),
                              vmask.float().contiguous(), *weights)


def smi_stack_content_train(blocks: nn.ModuleList, fc, fm, fb, fw, fs, query_mask,
                            length_mask, vmask, L: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The differentiable SMI stack with the content unit as a kernel per
    layer: every block of ``blocks`` in turn -> (fm_out (B, N, D), fb_out
    (B, L, D)), the heads' inputs, in fc's dtype. The moment gate, the
    boundary unit and the moment unit's boundary half (the outer product of
    the boundary rows and conv_fb) are PyTorch ops, at bf16 in bf16 as the
    JAX stack runs them on XLA (fm, fb, fw, fs cast to fc's dtype); conv_fc
    comes out of the kernel already masked."""
    dtype = fc.dtype
    fm, fb, fw, fs = (t.to(dtype) for t in (fm, fb, fw, fs))
    workspace = Workspace()
    i_idx, j_idx = pair_index(L, fb.device)
    m_mask = vmask[..., None].to(dtype)
    for block in blocks:
        fbar = moment_gate(fm, fs)
        cu, conv_fc = content_rows_train(content_weights(block), fc, fbar, fw, fs,
                                         query_mask, vmask, workspace)
        bu = boundary_unit_packed(block.boundary_unit, fb, fw, fs, fm, query_mask,
                                  length_mask, L, fbar=fbar)
        outer = bu[:, i_idx] * bu[:, j_idx]
        conv_fb = _linear(block.moment_unit.conv_layer_fb, outer) * m_mask
        fm = conv_fb + conv_fc + fm
        fc, fb = cu, bu
    return fm, fb

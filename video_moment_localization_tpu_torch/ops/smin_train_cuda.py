"""K2 and K3: one SMI layer forward and its hand-written backward, K9: all
layers' forward in one launch, and the differentiable stack over them
(csrc/smin_train.cu).

Counterpart of ``video_moment_localization_tpu/ops/smin_train_pallas.py``:
`_layer_fwd_call` (K2), `_layer_bwd_call` (K3), `_stack_fwd_call` (K9) and
the `smi_stack_layers` custom VJP that drives them. As in the JAX package
the stack's forward reads ``VML_SMIN_TRAIN_FUSED_FWD`` at each call: "1"
runs K9 in place of one K2 per layer (the same device code in the same
order, so the same bits), anything else the per-layer K2s; the backward is
K3 per layer either way. The JAX backward kernel differentiates the
layer body at trace time; here the gradient is derived by hand and written
as CUDA kernels (the derivation is in csrc/smin_train.cu). As in the JAX
package the stack saves only the layer-boundary carries (fc_i, fm_i, fb_i):
the backward kernel recomputes the layer before differentiating it, the top
layer's fc cotangent is a null pointer, weight gradients are fp32, and dfw /
dfs accumulate over the layers.

fc is n-major, (B, N, C, D), as everywhere in this package (the JAX kernels'
c-major rows are a TPU tiling choice).

`smi_layer_forward` / `smi_layer_backward` / `smi_stack_forward` are the
kernel wrappers: on a CPU tensor each runs its plain version
(`models.smin.smi_block_packed`, layer by layer for K9, and
``torch.autograd.grad`` through it), on a CUDA tensor it launches its kernel
or raises. ``.launches`` on each counts the launches (one per layer for K2
and K3, one per stack for K9: the C entry point sequences the kernels).

K2, K3 and K9 have bf16 variants (`vml_smi_layer_fwd_bf16` / `_bwd_bf16`,
`vml_smi_stack_fwd_bf16`), taken when the carry is bf16: activations and
cotangents bf16, the masks fp32, the layer's matrices bf16 and its biases
fp32 (the stack casts the fp32 parameters once per forward, as the JAX
package's `_wlayer` does), the 20 weight gradients fp32. K9-bf16 runs
K2-bf16's device code per layer, so its outputs and carries are those of
one K2-bf16 launch per layer bit for bit. Their plain versions are
`models.smin.smi_layer_bf16` (per layer for K9-bf16) and autograd through
it. ``.launches_bf16`` counts them.
"""

from __future__ import annotations

import ctypes
import functools
import os
import types
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from video_moment_localization_tpu_torch.models.smin import (
    BLOCK_WEIGHT_NAMES,
    block_weights,
    smi_block_packed,
    smi_layer_bf16,
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

WEIGHTS_PER_LAYER = 20
Carry = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _as_block(weights: Sequence[torch.Tensor]):
    """The 20 tensors of `block_weights` as the attribute tree that
    `smi_block_packed` reads."""
    layers = [types.SimpleNamespace(weight=weights[k], bias=weights[k + 1])
              for k in range(0, WEIGHTS_PER_LAYER, 2)]
    c_hat, w_hat, s_hat, c_out, cq, ck, bq, bk, conv_fb, conv_fc = layers
    ns = types.SimpleNamespace
    return ns(content_unit=ns(linear_c_hat=c_hat, linear_w_hat=w_hat, linear_s_hat=s_hat,
                              linear_c=c_out, attn_layer=ns(W_q=cq, W_k=ck)),
              boundary_unit=ns(attn_layer=ns(W_q=bq, W_k=bk)),
              moment_unit=ns(conv_layer_fb=conv_fb, conv_layer_fc=conv_fc))


def smi_layer_plain(weights, fc, fm, fb, fw, fs, query_mask, length_mask, vmask,
                    L: int) -> Carry:
    """The plain version of K2: `smi_block_packed` on the layer's weights;
    of K2-bf16 on a bf16 carry: `smi_layer_bf16`."""
    if fc.dtype == torch.bfloat16:
        return smi_layer_bf16(dict(zip(BLOCK_WEIGHT_NAMES, weights)), fc, fm, fb, fw, fs,
                              query_mask, length_mask, vmask, L)
    return smi_block_packed(_as_block(weights), fc, fm, fb, fw, fs, query_mask,
                            length_mask, vmask, L)


def smi_layer_backward_plain(weights, fc, fm, fb, fw, fs, query_mask, length_mask, vmask,
                             L: int, dcu, dmu, dbu):
    """The plain version of K3 (and of K3-bf16 on a bf16 carry): recompute
    the layer under autograd and take its VJP. ``dcu=None`` is the zero
    cotangent. Returns (dfc, dfm, dfb, dfw, dfs, [20 weight gradients]);
    the weight gradients are fp32 at either type (the bf16 layer's weights
    enter as fp32 leaves, rounded to bf16 with the gradient passed
    through)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (fc, fm, fb, fw, fs)]
        leaves += [w.detach().float().requires_grad_(True) for w in weights]
        cu, mu, bu = smi_layer_plain(leaves[5:], *leaves[:5], query_mask, length_mask,
                                     vmask, L)
        outs, cots = [mu, bu], [dmu, dbu]
        if dcu is not None:
            outs.append(cu)
            cots.append(dcu)
        grads = torch.autograd.grad(outs, leaves, cots)
    return (*grads[:5], list(grads[5:]))


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The smin_train library with its entries' argument types, set once (the
    wrappers call this on every launch)."""
    lib = load_library("smin_train")
    lib.vml_smi_layer_workspace_floats.argtypes = [ctypes.c_int] * 7
    lib.vml_smi_layer_workspace_floats.restype = ctypes.c_size_t
    lib.vml_smi_layer_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.vml_smi_layer_smem_bytes.restype = ctypes.c_size_t
    pointers = ctypes.POINTER(ctypes.c_void_p)
    fwd = lib.vml_smi_layer_fwd_f32
    fwd.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 8
                    + [pointers] + [ctypes.c_void_p] * 4)
    fwd.restype = ctypes.c_int
    bwd = lib.vml_smi_layer_bwd_f32
    bwd.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 8
                    + [pointers] + [ctypes.c_void_p] * 9 + [pointers])
    bwd.restype = ctypes.c_int
    stack = lib.vml_smi_stack_fwd_f32
    stack.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 8
                      + [pointers] + [ctypes.c_void_p] * 7)
    stack.restype = ctypes.c_int
    lib.vml_smi_stack_fwd_bf16.argtypes = stack.argtypes
    lib.vml_smi_stack_fwd_bf16.restype = ctypes.c_int
    lib.vml_smi_layer_workspace_bytes_bf16.argtypes = [ctypes.c_int] * 7
    lib.vml_smi_layer_workspace_bytes_bf16.restype = ctypes.c_size_t
    lib.vml_smi_layer_fwd_bf16.argtypes = fwd.argtypes
    lib.vml_smi_layer_fwd_bf16.restype = ctypes.c_int
    lib.vml_smi_layer_bwd_bf16.argtypes = bwd.argtypes
    lib.vml_smi_layer_bwd_bf16.restype = ctypes.c_int
    return lib


def _weight_shapes(D: int, dl: int):
    return [(dl, D), (dl,)] * 3 + [(D, dl), (D,)] + [(dl, dl), (dl,)] * 2 + [(D, D), (D,)] * 4


@functools.lru_cache(maxsize=None)
def _weight_specs(D: int, dl: int):
    """(name, shape) of the layer's 20 weights, as `check_tensors` reads them."""
    return tuple((f"weight {k}", s) for k, s in enumerate(_weight_shapes(D, dl)))


def _check_inputs(fn: str, weights, fc, fm, fb, fw, fs, query_mask, length_mask, vmask,
                  L: int, cotangents=()):
    """Shapes, dtype, device and contiguity of everything the C entry reads
    (fp32, or the bf16 variant's types when fc is bf16). Returns (B, C, Nq,
    D, dl)."""
    if fc.device.type != "cuda":
        raise ValueError(f"{fn} takes CPU or CUDA tensors, got {fc.device}")
    if fc.dim() != 4 or len(weights) != WEIGHTS_PER_LAYER:
        raise ValueError(f"{fn}: want fc (B, N, C, D) and {WEIGHTS_PER_LAYER} weight "
                         f"tensors, got {tuple(fc.shape)} and {len(weights)}")
    B, N, C, D = fc.shape
    Nq, dl = fw.shape[1], weights[0].shape[0]
    if N != L * (L + 1) // 2:
        raise ValueError(f"{fn}: fc has {N} pairs, L={L} gives {L * (L + 1) // 2}")
    want = [("fc", fc, (B, N, C, D)), ("fm", fm, (B, N, D)), ("fb", fb, (B, L, D)),
            ("fw", fw, (B, Nq, D)), ("fs", fs, (B, D)), ("query_mask", query_mask, (B, Nq, 1)),
            ("length_mask", length_mask, (B, L)), ("vmask", vmask, (B, N))]
    want += [(name, w, s) for (name, s), w in zip(_weight_specs(D, dl), weights)]
    check_tensors(fn, fc.device, want + list(cotangents), fc.dtype)
    return B, C, Nq, D, dl


@functools.lru_cache(maxsize=None)
def _workspace_size(B, L, C, Nq, D, dl, backward: bool, bf16: bool) -> int:
    """Elements of a layer launch's workspace (`_workspace`), once per shape."""
    lib = _library()
    smem = lib.vml_smi_layer_smem_bytes(L, C, Nq, D, dl)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"L={L}, C={C}, Nq={Nq}, dl={dl} need {smem} B of shared memory "
                         f"per block")
    if bf16:
        return lib.vml_smi_layer_workspace_bytes_bf16(B, L, C, Nq, D, dl, int(backward))
    return lib.vml_smi_layer_workspace_floats(B, L, C, Nq, D, dl, int(backward))


def _workspace(lib, fc, B, L, C, Nq, D, dl, backward: bool,
               ws: Optional[torch.Tensor]) -> torch.Tensor:
    """The workspace of a layer launch: float32 elements for the fp32
    entries, bytes (uint8) for the bf16 ones; ``ws`` is checked and reused
    when given."""
    bf16 = fc.dtype == torch.bfloat16
    n = _workspace_size(B, L, C, Nq, D, dl, backward, bf16)
    dtype = torch.uint8 if bf16 else torch.float32
    if ws is None:
        return torch.empty(n, device=fc.device, dtype=dtype)
    if ws.numel() < n or ws.device != fc.device or ws.dtype != dtype:
        raise ValueError(f"workspace: want {n} {dtype} on {fc.device}")
    return ws


def smi_layer_forward(weights, fc, fm, fb, fw, fs, query_mask, length_mask, vmask, L: int,
                      ws: Optional[torch.Tensor] = None) -> Carry:
    """One SMI layer: fc (B, N, C, D), fm (B, N, D), fb (B, L, D), fw
    (B, Nq, D), fs (B, D), query_mask (B, Nq, 1), length_mask (B, L), vmask
    (B, N) and `block_weights` -> (cu, mu, bu) of the same three shapes.
    ``ws`` is an optional workspace to reuse over layers."""
    if fc.device.type == "cpu":
        return smi_layer_plain(weights, fc, fm, fb, fw, fs, query_mask, length_mask,
                               vmask, L)
    B, C, Nq, D, dl = _check_inputs("smi_layer_forward", weights, fc, fm, fb, fw, fs,
                                    query_mask, length_mask, vmask, L)
    lib = _library()
    ws = _workspace(lib, fc, B, L, C, Nq, D, dl, False, ws)
    cu, mu, bu = torch.empty_like(fc), torch.empty_like(fm), torch.empty_like(fb)
    bf16 = fc.dtype == torch.bfloat16
    entry = "vml_smi_layer_fwd_bf16" if bf16 else "vml_smi_layer_fwd_f32"
    with torch.cuda.device(fc.device):
        err = getattr(lib, entry)(
            stream_of(fc), B, L, C, Nq, D, dl, ptr(fc), ptr(fm), ptr(fb), ptr(fw), ptr(fs),
            ptr(query_mask), ptr(length_mask), ptr(vmask), pointer_array(weights),
            ptr(ws), ptr(cu), ptr(mu), ptr(bu))
    check(lib, entry, err)
    if bf16:
        smi_layer_forward.launches_bf16 += 1
    else:
        smi_layer_forward.launches += 1
    return cu, mu, bu


def smi_layer_backward(weights, fc, fm, fb, fw, fs, query_mask, length_mask, vmask, L: int,
                       dcu: Optional[torch.Tensor], dmu, dbu,
                       ws: Optional[torch.Tensor] = None):
    """Recompute one layer from its inputs and backpropagate (dcu, dmu, dbu)
    through it; ``dcu=None`` is the zero cotangent of a top layer. Returns
    (dfc, dfm, dfb, dfw, dfs, [20 fp32 weight gradients in `block_weights`
    order])."""
    if fc.device.type == "cpu":
        return smi_layer_backward_plain(weights, fc, fm, fb, fw, fs, query_mask,
                                        length_mask, vmask, L, dcu, dmu, dbu)
    cots = [("dmu", dmu, fm.shape), ("dbu", dbu, fb.shape)]
    if dcu is not None:
        cots.append(("dcu", dcu, fc.shape))
    B, C, Nq, D, dl = _check_inputs("smi_layer_backward", weights, fc, fm, fb, fw, fs,
                                    query_mask, length_mask, vmask, L, cots)
    lib = _library()
    ws = _workspace(lib, fc, B, L, C, Nq, D, dl, True, ws)
    dfc, dfm, dfb = torch.empty_like(fc), torch.empty_like(fm), torch.empty_like(fb)
    dfw, dfs = torch.empty_like(fw), torch.empty_like(fs)
    dweights = [torch.empty_like(w, dtype=torch.float32) for w in weights]
    bf16 = fc.dtype == torch.bfloat16
    entry = "vml_smi_layer_bwd_bf16" if bf16 else "vml_smi_layer_bwd_f32"
    with torch.cuda.device(fc.device):
        err = getattr(lib, entry)(
            stream_of(fc), B, L, C, Nq, D, dl, ptr(fc), ptr(fm), ptr(fb), ptr(fw), ptr(fs),
            ptr(query_mask), ptr(length_mask), ptr(vmask), pointer_array(weights),
            ptr(dcu) if dcu is not None else None, ptr(dmu), ptr(dbu), ptr(ws),
            ptr(dfc), ptr(dfm), ptr(dfb), ptr(dfw), ptr(dfs), pointer_array(dweights))
    check(lib, entry, err)
    if bf16:
        smi_layer_backward.launches_bf16 += 1
    else:
        smi_layer_backward.launches += 1
    return dfc, dfm, dfb, dfw, dfs, dweights


def smi_stack_plain(weights, fc, fm, fb, fw, fs, query_mask, length_mask, vmask, L: int):
    """The plain version of K9 (of K9-bf16 on a bf16 carry): `smi_layer_plain`
    layer by layer. Returns
    (fm_out, fb_out, [the (fc, fm, fb) input carry of every layer])."""
    carries = []
    for k in range(len(weights) // WEIGHTS_PER_LAYER):
        carries.append((fc, fm, fb))
        fc, fm, fb = smi_layer_plain(weights[k * WEIGHTS_PER_LAYER:(k + 1) * WEIGHTS_PER_LAYER],
                                     fc, fm, fb, fw, fs, query_mask, length_mask, vmask, L)
    return fm, fb, carries


def smi_stack_forward(weights, fc, fm, fb, fw, fs, query_mask, length_mask, vmask, L: int):
    """All layers' forward: ``weights`` holds every layer's 20 tensors in
    `block_weights` order, one layer after the other. Returns (fm_out
    (B, N, D), fb_out (B, L, D), [the (fc, fm, fb) input carry of every
    layer]); on the card the inner layers' carries are views of three
    buffers that the one launch writes. A bf16 carry takes K9-bf16, with
    the weights as `layer_weights_for` casts them."""
    if fc.device.type == "cpu":
        return smi_stack_plain(weights, fc, fm, fb, fw, fs, query_mask, length_mask, vmask, L)
    n_layers = len(weights) // WEIGHTS_PER_LAYER
    if n_layers < 1 or len(weights) != n_layers * WEIGHTS_PER_LAYER:
        raise ValueError(f"smi_stack_forward: want 20 weight tensors per layer, got "
                         f"{len(weights)}")
    B, C, Nq, D, dl = _check_inputs("smi_stack_forward", weights[:WEIGHTS_PER_LAYER], fc, fm,
                                    fb, fw, fs, query_mask, length_mask, vmask, L)
    check_tensors("smi_stack_forward", fc.device,
                  [(f"weight {k}", w, shape) for k, (w, shape)
                   in enumerate(zip(weights, _weight_shapes(D, dl) * n_layers))], fc.dtype)
    lib = _library()
    ws = _workspace(lib, fc, B, L, C, Nq, D, dl, False, None)
    inner = n_layers - 1
    carry_fc = fc.new_empty((inner,) + tuple(fc.shape))
    carry_fm = fm.new_empty((inner,) + tuple(fm.shape))
    carry_fb = fb.new_empty((inner,) + tuple(fb.shape))
    cu_last, fm_out, fb_out = torch.empty_like(fc), torch.empty_like(fm), torch.empty_like(fb)
    bf16 = fc.dtype == torch.bfloat16
    entry = "vml_smi_stack_fwd_bf16" if bf16 else "vml_smi_stack_fwd_f32"
    with torch.cuda.device(fc.device):
        err = getattr(lib, entry)(
            stream_of(fc), B, L, C, Nq, D, dl, n_layers, ptr(fc), ptr(fm), ptr(fb), ptr(fw),
            ptr(fs), ptr(query_mask), ptr(length_mask), ptr(vmask), pointer_array(weights),
            ptr(ws), *((ptr(t) if inner else None) for t in (carry_fc, carry_fm, carry_fb)),
            ptr(cu_last), ptr(fm_out), ptr(fb_out))
    check(lib, entry, err)
    if bf16:
        smi_stack_forward.launches_bf16 += 1
    else:
        smi_stack_forward.launches += 1
    carries = [(fc, fm, fb)] + [(carry_fc[k], carry_fm[k], carry_fb[k]) for k in range(inner)]
    return fm_out, fb_out, carries


smi_layer_forward.launches = 0
smi_layer_backward.launches = 0
smi_layer_forward.launches_bf16 = 0     # the bf16 variants' launches
smi_layer_backward.launches_bf16 = 0
smi_stack_forward.launches = 0
smi_stack_forward.launches_bf16 = 0


def layer_weights_for(weights: Sequence[torch.Tensor], dtype: torch.dtype) -> List[torch.Tensor]:
    """The layers' weights as the kernels of ``dtype`` read them: as they
    are at fp32; at bf16 the matrices cast to bf16 and the biases fp32 (the
    JAX package's `_wlayer`), detached."""
    if dtype == torch.float32:
        return list(weights)
    return [w.detach().to(dtype) if w.dim() >= 2 else w.detach() for w in weights]


class _SMIStack(torch.autograd.Function):
    """All layers; saves the carries, the shared inputs and the weights (at
    bf16 their bf16 cast, which the forward and backward kernels read)."""

    @staticmethod
    def forward(ctx, L, fc, fm, fb, fw, fs, query_mask, length_mask, vmask, *weights):
        n_layers = len(weights) // WEIGHTS_PER_LAYER
        shared = (fw, fs, query_mask, length_mask, vmask)
        weights = layer_weights_for(weights, fc.dtype)
        if os.environ.get("VML_SMIN_TRAIN_FUSED_FWD", "0") == "1":
            fm, fb, carries = smi_stack_forward(weights, fc, fm, fb, *shared, L)
        else:
            ws = None
            if fc.device.type == "cuda":
                ws = _workspace(_library(), fc, fc.shape[0], L, fc.shape[2], fw.shape[1],
                                fc.shape[3], weights[0].shape[0], False, None)
            carries = []
            for k in range(n_layers):
                carries.append((fc, fm, fb))
                fc, fm, fb = smi_layer_forward(
                    weights[k * WEIGHTS_PER_LAYER:(k + 1) * WEIGHTS_PER_LAYER], fc, fm, fb,
                    *shared, L, ws=ws)
        ctx.save_for_backward(*(t for carry in carries for t in carry), *shared, *weights)
        ctx.L, ctx.n_layers = L, n_layers
        return fm, fb

    @staticmethod
    def backward(ctx, dfm, dfb):
        L, n_layers = ctx.L, ctx.n_layers
        saved = ctx.saved_tensors
        carries, shared = saved[:3 * n_layers], saved[3 * n_layers:3 * n_layers + 5]
        weights = saved[3 * n_layers + 5:]
        fc0, fw = carries[0], shared[0]
        ws = None
        if fc0.device.type == "cuda":
            ws = _workspace(_library(), fc0, fc0.shape[0], L, fc0.shape[2], fw.shape[1],
                            fc0.shape[3], weights[0].shape[0], True, None)
        # The cotangents in the carry's type, as the JAX package's backward
        # casts them (`_stack_bwd_impl`).
        dfc, dfm, dfb = None, dfm.to(fc0.dtype).contiguous(), dfb.to(fc0.dtype).contiguous()
        dfw_acc = dfs_acc = None
        dweights: List[torch.Tensor] = []
        for k in reversed(range(n_layers)):
            dfc, dfm, dfb, dfw, dfs, dw = smi_layer_backward(
                weights[k * WEIGHTS_PER_LAYER:(k + 1) * WEIGHTS_PER_LAYER],
                *carries[3 * k:3 * k + 3], *shared, L, dfc, dfm, dfb, ws=ws)
            dfw_acc = dfw if dfw_acc is None else dfw_acc + dfw
            dfs_acc = dfs if dfs_acc is None else dfs_acc + dfs
            dweights = list(dw) + dweights
        return (None, dfc, dfm, dfb, dfw_acc, dfs_acc, None, None, None, *dweights)


def smi_stack_layers(blocks: nn.ModuleList, fc, fm, fb, fw, fs, query_mask, length_mask,
                     vmask, L: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The differentiable SMI stack: every block of ``blocks`` in turn ->
    (fm_out (B, N, D), fb_out (B, L, D)), the heads' inputs. The last
    layer's fc has no consumer and is not returned."""
    weights = [w for block in blocks for w in block_weights(block)]
    return _SMIStack.apply(L, fc.contiguous(), fm.contiguous(), fb.contiguous(),
                           fw.contiguous(), fs.contiguous(), query_mask.contiguous(),
                           length_mask.contiguous(), vmask.contiguous(), *weights)

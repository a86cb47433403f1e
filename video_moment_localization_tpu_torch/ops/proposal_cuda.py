"""K1, K6 and K8: proposal features for training, forward and backward
(csrc/proposal_rows.cu).

Counterparts of three kernels of ``video_moment_localization_tpu/ops/
proposal_pallas.py``, each with its custom VJP: `proposal_features_rows`
(K1: `_rows_fwd` / `_rows_bwd`), which feeds the whole-layer train kernels,
`proposal_features_packed_pallas` (K6: `_packed_fwd` / `_packed_bwd`),
which feeds the content-unit train path and the packed unit loop, and
`proposal_features_pallas` (K8: `_fc_fm_pallas`, backward the XLA VJP),
which feeds the dense layout (``packed: False``). All map the fused backbone
features f (B, T, D) to the clip means fc, their mean over clips fm and the
snippet window means fb. The JAX kernels multiply by a dense averaging
matrix; K1 and K6 differ only in the layout of fc (K1 emits c-major rows
(B, C*N, D) for the TPU's tiling, K6 n-major (B, N, C, D)), K8 writes every
cell of the L x L map and masks by a given moment_mask. This port keeps fc
n-major everywhere (`ops.packing.pack_rows` converts), and what the kernels
compute is a mean over a closed-form run of frames per (moment, clip), so on
the card they are one forward that writes every clip mean from prefix sums
of f's tile in shared memory, and one backward that scatters each clip's
cotangent into difference arrays in shared memory and scans them over t,
both templated on the layout: two C entry points for the packed layout (K1
and K6, each with its own launch counters) and two for the dense one (K8).
Both kernels take any D; they refuse a T whose shared-memory tile exceeds
what a block may have (`check_smem`: T <= 899 forward, T <= 1763 backward
at L=16 at fp32).

`proposal_features_rows` (K1), `proposal_features_packed_fused` (K6) and
`proposal_features_dense_fused` (K8) are the differentiable entries
(autograd Functions that save their inputs; no gradient flows to a mask).
`proposal_rows_forward` / `_backward`, `proposal_packed_forward` /
`_backward` and `proposal_dense_forward` / `_backward` are the kernel
wrappers: on a CPU tensor each runs its plain version
(`ops.proposal.proposal_features_packed` or `ops.proposal.proposal_features`,
and autograd through it), on a CUDA tensor it launches its kernel or raises.
``.launches`` on each counts the launches.

All three have bf16 variants (K1-bf16, K6-bf16 and K8-bf16, the training
paths at bf16), taken on a bf16 f or bf16 cotangents (K6-bf16 launches
K1-bf16's two C entry points), with fp32 / fp64 sums inside and one rounding
per stored value; the masks stay fp32. They run kernels of their own,
designed for 2-byte elements: the forward (`pool_kernel_bf16`) gives a lane
four adjacent columns, so every warp store is one 256-byte row segment, with
fp32 prefix sums of the block's 128 columns (the plain version's type); the
backward (`proposal_bwd_bf16_kernel`) gives a lane two, so every row it reads
is a 128-byte segment: a producer warp streams the unmasked moments' rows,
in chunks of up to 8 adjacent moments, into a ring in shared memory by TMA
copies completed on mbarriers, and consumer warps, each with its own T x 64
fp32 difference array, scatter them. `plan` mirrors both launch plans (the
library's own: ``vml_proposal_plan``); at L=16 and C=4 they take T <= 445
forward and T <= 837 backward (`check_smem`). Their vector path (and the
backward's TMA path) needs D % 8 == 0 and 16-byte aligned data pointers
(`vector_path`); any other D or pointer takes the scalar path inside the
same kernels. Their plain
versions are the fp32 ones of the layout on the bf16 values, rounded once
(`proposal_rows_forward_plain_bf16`, `proposal_rows_backward_plain_bf16`,
which take either layout by the mask's rank). This follows the JAX kernels as
their tests run them (interpret mode): pooled in fp32, fc, fm and fb each
rounded once, and the backward (K8's the XLA VJP of the fp32 prefix sums) the
fp32 transpose of the bf16 cotangents' values, df rounded once. On the TPU,
K8 at bf16 multiplies at ``Precision.DEFAULT``, which would also round its
averaging matrix Wc's weights (1 / clip length) to bf16; interpret mode on
the CPU does not, and neither does this port. ``.launches_bf16`` counts their
launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from video_moment_localization_tpu_torch.ops.cuda_build import (
    MAX_SMEM_BYTES,
    check,
    load_library,
    ptr,
    stream_of,
)
from video_moment_localization_tpu_torch.ops.proposal import (
    proposal_features,
    proposal_features_packed,
)

Features = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
# A fp32 block of either kernel owns one element and 32 columns; the
# forward's has 8 warps, the backward's up to 16 (csrc/proposal.cuh:
# kPropCols, kPoolWarps; csrc/proposal_rows.cu: kMaxWarps, scatter_warps).
# Shared memory of one H100 block and SM, and what the SM reserves per block.
_COLS, _POOL_WARPS, _MAX_SCATTER_WARPS = 32, 8, 16
_SM_SMEM, _RESERVED = 233472, 1024
# The bf16 kernels: a forward of 8 warps (kPool16Warps), four columns a
# lane (kPoolCPL) and 8 x 32 16-byte run totals; a backward of 64 columns a
# block (kPairCols, 128-byte rows), 8 x 32 double2 run totals
# (kMaxPairWarps, kRunTotalPairBytes), up to 4 consumer warps
# (kPairConsumers), chunks of 8 moments (kBoxMoments) and a ring of up to 32
# slots (kMaxSlots), 2 a consumer at least (kMinSlots).
_POOL16_WARPS, _POOL_CPL = 8, 4
_PAIR_COLS, _MAX_PAIR_WARPS, _ROW = 64, 8, 128
_RUN_TOTAL16, _RUN_TOTAL_PAIR = _POOL16_WARPS * 32 * 16, _MAX_PAIR_WARPS * 32 * 16
_PAIR_CONSUMERS, _BOX_MOMENTS, _MAX_SLOTS, _MIN_SLOTS = 4, 8, 32, 2


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library("proposal_rows")
    for name in ("rows_fwd_f32", "rows_bwd_f32", "dense_fwd_f32", "dense_bwd_f32",
                 "rows_fwd_bf16", "rows_bwd_bf16", "dense_fwd_bf16", "dense_bwd_bf16"):
        fn = getattr(lib, f"vml_proposal_{name}")
        fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 5
        fn.restype = ctypes.c_int
    lib.vml_proposal_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.vml_proposal_smem_bytes.restype = ctypes.c_size_t
    lib.vml_proposal_plan.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_longlong)]
    lib.vml_proposal_plan.restype = None
    return lib


def _check(name: str, t: torch.Tensor, shape, device, dtype=torch.float32) -> None:
    if (tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != device
            or not t.is_contiguous()):
        raise ValueError(f"{name}: want contiguous {dtype} {tuple(shape)} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _kernel_dtype(fn: str, dtype: torch.dtype) -> str:
    """The C entry's suffix for the activations' dtype."""
    if dtype == torch.float32:
        return "f32"
    if dtype == torch.bfloat16:
        return "bf16"
    raise ValueError(f"{fn}: the kernel takes float32 or bfloat16, got {dtype}")


def _check_device(fn: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{fn} takes CPU or CUDA tensors, got {t.device}")


def _check_geometry(T: int, L: int, C: int) -> None:
    if T % L != 0 or C < 1:
        raise ValueError(f"T ({T}) must be a multiple of L ({L}) and C ({C}) positive")


def _scatter_extra(L: int) -> int:
    """The fp32 backward's shared memory beside its difference arrays: the N
    pair masks, the L x 32 tile of dfb and the 16 x 32 fp64 run totals."""
    return (L * (L + 1) // 2 + L * _COLS) * 4 + _MAX_SCATTER_WARPS * _COLS * 8


def backward_warps(T: int, L: int) -> int:
    """Warps of a fp32 backward block at T frames and L snippets: two blocks
    of 8 per SM where they fit, else as many T x 32 fp32 difference arrays as
    fit, up to 16; 0 if none fits (csrc/proposal_rows.cu::scatter_warps)."""
    per_warp, extra = T * _COLS * 4, _scatter_extra(L)
    if 2 * (8 * per_warp + extra + _RESERVED) <= _SM_SMEM:
        return 8
    if extra + per_warp > MAX_SMEM_BYTES:
        return 0
    return min(_MAX_SCATTER_WARPS, (MAX_SMEM_BYTES - extra) // per_warp)


def proposal_smem_bytes(T: int, L: int, backward: bool) -> int:
    """Shared memory per fp32 block: the forward's fp64 prefix sums of a
    (T + 1) x 32 tile and its 8 x 32 fp64 run totals, or the backward's
    difference arrays (one at least) and `_scatter_extra`
    (csrc/proposal_rows.cu::vml_proposal_smem_bytes)."""
    if backward:
        return max(1, backward_warps(T, L)) * T * _COLS * 4 + _scatter_extra(L)
    return (T + 1) * _COLS * 8 + _POOL_WARPS * _COLS * 8


def _slot_bytes(C: int) -> int:
    """One slot of the bf16 backward's ring: the dfc and dfm boxes (C + 1
    rows of 128 bytes a moment) of a chunk of 8 moments."""
    return _BOX_MOMENTS * (C + 1) * _ROW


def _pair_fixed_bytes(L: int) -> int:
    """The bf16 backward's shared memory beside its ring and difference
    arrays: the ring's alignment (128 bytes), the list of unmasked moments (a
    word and mask / clip length each of the N pairs at most), the clip
    geometry by moment length (L int2), the L x 64 bf16 dfb tile and the
    chunk starts (N + 1 16-bit)."""
    N = L * (L + 1) // 2
    return 128 + N * 8 + L * 8 + L * _ROW + (N + 1) * 2


def pair_plan(T: int, L: int, C: int) -> Tuple[int, int, int, int]:
    """(consumer warps, ring slots, blocks an SM, dynamic shared memory) of
    the bf16 backward (csrc/proposal_rows.cu::pair_plan): two blocks an SM
    where half of it holds 4 T x 64 fp32 difference arrays (a consumer warp
    each) and 2 slots for each, else one block with as many consumers as fit
    so, up to 4; the ring takes the rest, up to 32 slots, a multiple of the
    consumers. (0, 0, 0, 0) where not even one consumer fits."""
    per_warp, per_slot, fixed = T * _PAIR_COLS * 4, _slot_bytes(C) + 16, _pair_fixed_bytes(L)
    half = _SM_SMEM // 2 - _RESERVED - _RUN_TOTAL_PAIR
    whole = MAX_SMEM_BYTES - _RUN_TOTAL_PAIR
    for blocks, room in ((2, half), (1, whole)):
        if room < fixed:
            continue
        warps = min(_PAIR_CONSUMERS, (room - fixed) // (per_warp + _MIN_SLOTS * per_slot))
        if warps == 0 or (blocks == 2 and warps < _PAIR_CONSUMERS):
            continue
        slots = min(_MAX_SLOTS, (room - fixed - warps * per_warp) // per_slot)
        slots -= slots % warps
        return warps, slots, blocks, fixed + warps * per_warp + slots * per_slot
    return 0, 0, 0, 0


def plan(T: int, L: int, C: int, backward: bool, dtype=torch.float32) -> dict:
    """The launch plan of the forward or the backward at ``dtype``
    (csrc/proposal_rows.cu::vml_proposal_plan): warps and columns a block,
    blocks an SM and ring slots (the bf16 backward; 0 otherwise), shared
    memory a block, dynamic and static (0 where no plan fits)."""
    if dtype == torch.float32:
        warps = backward_warps(T, L) if backward else _POOL_WARPS
        smem = proposal_smem_bytes(T, L, backward) if warps else 0
        return dict(warps=warps, cols=_COLS, blocks_per_sm=0, smem=smem, slots=0)
    if not backward:
        return dict(warps=_POOL16_WARPS, cols=32 * _POOL_CPL, blocks_per_sm=0,
                    smem=(T + 1) * 32 * _POOL_CPL * 4 + _RUN_TOTAL16, slots=0)
    consumers, slots, blocks, smem = pair_plan(T, L, C)
    return dict(warps=consumers + 1 if consumers else 0, cols=_PAIR_COLS, blocks_per_sm=blocks,
                smem=smem + _RUN_TOTAL_PAIR if consumers else 0, slots=slots)


def library_plan(T: int, L: int, C: int, backward: bool, dtype=torch.float32) -> dict:
    """`plan` as the library computes it (``vml_proposal_plan``), on the card."""
    out = (ctypes.c_longlong * 5)()
    _library().vml_proposal_plan(T, L, C, int(backward), int(dtype == torch.bfloat16), out)
    return dict(zip(("warps", "cols", "blocks_per_sm", "smem", "slots"), list(out)))


def vector_path(D: int, tensors) -> bool:
    """Whether the bf16 kernels take their vector path on these tensors (bf16x2
    accesses, and the backward's TMA copies): D a multiple of 8 and every
    data pointer 16-byte aligned (csrc/proposal.cuh::pair_vector); else their
    scalar path."""
    return D % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


def check_smem(fn: str, T: int, L: int, C: int, backward: bool, dtype=torch.float32) -> None:
    """Raise unless the pooling forward (or the backward) at ``dtype`` takes
    T frames at L snippets and C clips: its tile (or the backward's difference
    arrays, and the bf16 backward's ring) must fit the shared memory one
    block may have."""
    if dtype == torch.bfloat16 and backward:
        fits = pair_plan(T, L, C)[0] > 0
        need = (_pair_fixed_bytes(L) + T * _PAIR_COLS * 4 + _MIN_SLOTS * (_slot_bytes(C) + 16)
                + _RUN_TOTAL_PAIR)
    else:
        need = plan(T, L, C, backward, dtype)["smem"] if dtype == torch.bfloat16 \
            else proposal_smem_bytes(T, L, backward)
        fits = need <= MAX_SMEM_BYTES
    if not fits:
        raise ValueError(f"{fn}: T={T} frames need {need} B of shared memory per block for "
                         f"the {'backward' if backward else 'forward'} kernel at {dtype}, more "
                         f"than the {MAX_SMEM_BYTES} B a block may have")


def _plain_forward(dense: bool):
    return proposal_features if dense else proposal_features_packed


def _shapes(B: int, L: int, dense: bool):
    """(the mask's shape, the leading shape of fc and fm) of a layout."""
    if dense:
        return (B, L, L), (B, L, L)
    return (B, L), (B, L * (L + 1) // 2)


def proposal_rows_forward_plain_bf16(f, mask, L: int, C: int) -> Features:
    """The plain version of K1-bf16's, K6-bf16's and (a (B, L, L) ``mask``,
    the moment_mask) K8-bf16's forward: the fp32 pooling of the layout on
    f's bf16 values (fp32 prefix sums), each output rounded once to bf16."""
    return tuple(x.to(torch.bfloat16)
                 for x in _plain_forward(mask.dim() == 3)(f.float(), mask, L, C))


def proposal_rows_backward_plain_bf16(mask, T: int, L: int, C: int, dfc, dfm, dfb):
    """The plain version of the bf16 backwards of either layout (by the
    mask's rank): the fp32 transpose of the bf16 cotangents' values, df
    rounded once to bf16."""
    return proposal_backward_plain(mask, T, L, C, dfc.float(), dfm.float(),
                                   dfb.float()).to(torch.bfloat16)


def proposal_backward_plain(mask, T: int, L: int, C: int, dfc, dfm, dfb):
    """The plain backward of either layout (a (B, L, L) ``mask`` is the dense
    moment_mask, a (B, L) one the length mask): the pooling is linear in f,
    so its transpose is autograd through the plain forward at any f."""
    B, D = dfc.shape[0], dfc.shape[-1]
    with torch.enable_grad():
        f = torch.zeros((B, T, D), dtype=dfc.dtype, device=dfc.device, requires_grad=True)
        out = _plain_forward(mask.dim() == 3)(f, mask, L, C)
        return torch.autograd.grad(out, f, (dfc, dfm, dfb))[0]


def _call(lib: ctypes.CDLL, entry: str, device: torch.device, *args) -> None:
    """Call a C entry point with ``device`` current, switching only when it
    is not (a switch costs host time on every call), and raise on the CUDA
    error it returns."""
    if device.index == torch.cuda.current_device():
        err = getattr(lib, entry)(*args)
    else:
        with torch.cuda.device(device):
            err = getattr(lib, entry)(*args)
    check(lib, entry, err)


def _launch_forward(fn: str, dense: bool, f: torch.Tensor, mask: torch.Tensor, L: int,
                    C: int) -> Features:
    B, T, D = f.shape
    _check_geometry(T, L, C)
    check_smem(fn, T, L, C, False, f.dtype)
    _check_device(fn, f)
    mask_shape, lead = _shapes(B, L, dense)
    suffix = _kernel_dtype(fn, f.dtype)
    _check("f", f, (B, T, D), f.device, f.dtype)
    _check("moment_mask" if dense else "length_mask", mask, mask_shape, f.device)
    lib = _library()
    fc = torch.empty(lead + (C, D), device=f.device, dtype=f.dtype)
    fm = torch.empty(lead + (D,), device=f.device, dtype=f.dtype)
    fb = torch.empty((B, L, D), device=f.device, dtype=f.dtype)
    _call(lib, f"vml_proposal_{'dense' if dense else 'rows'}_fwd_{suffix}", f.device,
          stream_of(f), B, T, L, C, D, ptr(f), ptr(mask), ptr(fc), ptr(fm), ptr(fb))
    return fc, fm, fb


def _launch_backward(fn: str, dense: bool, mask: torch.Tensor, T: int, L: int, C: int,
                     dfc: torch.Tensor, dfm: torch.Tensor, dfb: torch.Tensor) -> torch.Tensor:
    B, D = dfc.shape[0], dfc.shape[-1]
    _check_geometry(T, L, C)
    check_smem(fn, T, L, C, True, dfc.dtype)
    _check_device(fn, dfc)
    mask_shape, lead = _shapes(B, L, dense)
    suffix = _kernel_dtype(fn, dfc.dtype)
    _check("dfc", dfc, lead + (C, D), dfc.device, dfc.dtype)
    _check("dfm", dfm, lead + (D,), dfc.device, dfc.dtype)
    _check("dfb", dfb, (B, L, D), dfc.device, dfc.dtype)
    _check("moment_mask" if dense else "length_mask", mask, mask_shape, dfc.device)
    lib = _library()
    df = torch.empty((B, T, D), device=dfc.device, dtype=dfc.dtype)
    _call(lib, f"vml_proposal_{'dense' if dense else 'rows'}_bwd_{suffix}", dfc.device,
          stream_of(dfc), B, T, L, C, D, ptr(mask), ptr(dfc), ptr(dfm), ptr(dfb), ptr(df))
    return df


def _forward_wrapper(name: str, dense: bool, doc: str):
    """A kernel wrapper of a forward entry point with its own counter."""
    def run(f: torch.Tensor, mask: torch.Tensor, L: int, C: int) -> Features:
        bf16 = f.dtype == torch.bfloat16
        if f.device.type == "cpu":
            if bf16:
                return proposal_rows_forward_plain_bf16(f, mask, L, C)
            return _plain_forward(dense)(f, mask, L, C)
        out = _launch_forward(name, dense, f, mask, L, C)
        if bf16:
            run.launches_bf16 += 1
        else:
            run.launches += 1
        return out

    run.__name__ = run.__qualname__ = name
    run.__doc__ = doc
    run.launches = run.launches_bf16 = 0
    return run


def _backward_wrapper(name: str, dense: bool, doc: str):
    """A kernel wrapper of a backward entry point with its own counter."""
    def run(mask: torch.Tensor, T: int, L: int, C: int, dfc: torch.Tensor,
            dfm: torch.Tensor, dfb: torch.Tensor) -> torch.Tensor:
        bf16 = dfc.dtype == torch.bfloat16
        if dfc.device.type == "cpu":
            if bf16:
                return proposal_rows_backward_plain_bf16(mask, T, L, C, dfc, dfm, dfb)
            return proposal_backward_plain(mask, T, L, C, dfc, dfm, dfb)
        df = _launch_backward(name, dense, mask, T, L, C, dfc, dfm, dfb)
        if bf16:
            run.launches_bf16 += 1
        else:
            run.launches += 1
        return df

    run.__name__ = run.__qualname__ = name
    run.__doc__ = doc
    run.launches = run.launches_bf16 = 0
    return run


proposal_rows_forward = _forward_wrapper(
    "proposal_rows_forward", False,
    """K1 forward. f (B, T, D), length_mask (B, L) -> fc (B, N, C, D) masked
    by the pair validity, fm (B, N, D) = mean over C, fb (B, L, D) window
    means; f and the outputs fp32, or bf16 (K1-bf16).""")
proposal_rows_backward = _backward_wrapper(
    "proposal_rows_backward", False,
    """K1 backward. (length_mask, T, L, C, dfc, dfm, dfb): cotangents of
    (fc, fm, fb) -> df (B, T, D), in the cotangents' type (fp32, or bf16:
    K1-bf16).""")
proposal_packed_forward = _forward_wrapper(
    "proposal_packed_forward", False,
    """K6 forward: the same function and device code as `proposal_rows_forward`
    (the two JAX kernels differ only in fc's layout, which this port does
    not carry over), fp32 or bf16 (K6-bf16), counted on its own.""")
proposal_packed_backward = _backward_wrapper(
    "proposal_packed_backward", False,
    """K6 backward: cotangents of (fc, fm, fb) -> df (B, T, D), fp32 or bf16
    (K6-bf16), counted on its own.""")
proposal_dense_forward = _forward_wrapper(
    "proposal_dense_forward", True,
    """K8 forward. f (B, T, D), moment_mask (B, L, L) fp32 -> fc (B, L, L, C, D)
    masked by the moment_mask's value (0 below the diagonal whatever the
    mask holds there), fm (B, L, L, D) = mean over C, fb (B, L, D); f and
    the outputs fp32, or bf16 (K8-bf16).""")
proposal_dense_backward = _backward_wrapper(
    "proposal_dense_backward", True,
    """K8 backward. (moment_mask, T, L, C, dfc, dfm, dfb): cotangents of the
    dense (fc, fm, fb) -> df (B, T, D), in the cotangents' type (fp32, or
    bf16: K8-bf16).""")


class _Proposal(torch.autograd.Function):
    """Differentiable over one pair of kernel wrappers; saves its inputs."""

    @staticmethod
    def forward(ctx, f, mask, L, C, run_forward, run_backward):
        ctx.save_for_backward(f, mask)
        ctx.geometry = (L, C)
        ctx.run_backward = run_backward
        return run_forward(f, mask, L, C)

    @staticmethod
    def backward(ctx, dfc, dfm, dfb):
        f, mask = ctx.saved_tensors
        L, C = ctx.geometry
        df = ctx.run_backward(mask, f.shape[1], L, C, *(g.to(f.dtype).contiguous()
                                                        for g in (dfc, dfm, dfb)))
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


def proposal_features_dense_fused(f: torch.Tensor, moment_mask: torch.Tensor, L: int,
                                  C: int) -> Features:
    """K8, differentiable: dense (fc (B, L, L, C, D), fm (B, L, L, D),
    fb (B, L, D)) of f (B, T, D), for the dense layout (``packed: False``);
    no gradient flows to ``moment_mask``."""
    return _Proposal.apply(f, moment_mask.float().contiguous(), L, C, proposal_dense_forward,
                           proposal_dense_backward)

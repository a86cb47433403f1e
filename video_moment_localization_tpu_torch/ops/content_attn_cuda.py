"""The content-attention pair of ``csrc/content_attn.cuh`` on its own
(``csrc/content_attn.cu``), for the card tests and the timing phase of
``chip_smoke.py``, and a Python mirror of its tile plan.

The pair is the ContentUnit between its projections: the word attention of
every clip row, f_cq, the C x C clip attention and its mix of the rows
(forward), and the backward from dfcc to dh, dq and the per-element sums
dfwh, dkhat, dfsh. K4, K2, K3, K7, K9 and K10 run it inside their own C
entry points (their device code is the same); this module calls it alone.
`content_attn_forward` / `content_attn_backward` run their plain versions
(`content_attn_plain`, autograd through it) on CPU tensors and launch the
kernels or raise on CUDA tensors; ``.launches`` on each counts the launches.
`path_launches` reads how often the kernel entry points of the other
libraries launched the pair since `reset_path_launches`.

The mirror (`plan`, `smem_floats`, `partial_floats`, `tile_bounds`) restates
``content_attn.cuh``'s choices, so the CPU tests can check every shipped
config and ``chip_smoke.py`` can hold the mirror against the C plan on the
card.

The forward has a bf16 variant (K4, K2 at bf16): h, q, khat, fwh and fcc
bf16, fsh and the masks fp32 (`content_attn_forward` on bf16 tensors; its
plain version is `content_attn_plain_bf16`). It converts the rows to fp32
as it stages them, so its plan is the fp32 forward's. The backward has one
(K3-bf16, K7-bf16, K10-bf16; `content_attn_backward` on bf16 tensors: dq,
dkhat and dfsh bf16, dh and dfwh fp32; plain version
`content_attn_backward_plain_bf16`): it stages the rows as bf16 by
cp.async (`bwd_layout`), so its plan (`plan(..., bf16=True)`) is the fp32
backward's with about half the shared memory.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, Tuple

import torch

from video_moment_localization_tpu_torch.ops.cuda_build import (
    check,
    check_tensors,
    load_library,
    ptr,
    stream_of,
)

THREADS = 256
ROWS = 64                       # clip rows per pass
SMS = 132                       # H100 SXM
MAX_PASSES = 16
MAX_SMEM = 232448               # dynamic shared memory of one block
SMEM_PER_SM = 233472
RESERVED_PER_BLOCK = 1024
NEG_INF = -1e9
# The libraries whose entry points run the pair (K4; K2, K3, K9; K7, K10).
PATH_LIBRARIES = ("smin_stack", "smin_train", "content_train")


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def shape(pp: int, C: int, Nq: int, dl: int) -> Dict[str, int]:
    """content_attn.cuh::ca_shape: padded row stride DS, words NQ4, rows R
    and RP, pairs PP4 of a pass of ``pp`` pairs."""
    dl4 = _ceil(dl, 4)
    return dict(dl4=dl4, DS=dl4 * 4 + 4, NQ4=_ceil(Nq, 4) * 4, R=pp * C,
                RP=_ceil(pp * C, 4) * 4, PP4=_ceil(pp, 4) * 4)


def smem_floats(pp: int, C: int, Nq: int, dl: int, backward: bool) -> int:
    """content_attn.cuh::ca_smem_floats."""
    s = shape(pp, C, Nq, dl)
    f = 2 * s["NQ4"] * s["DS"] + s["DS"] + s["NQ4"] + s["PP4"]
    if not backward:
        return f + 2 * s["RP"] * s["DS"] + s["RP"] * s["NQ4"] + s["RP"] * C
    return (f + 5 * s["RP"] * s["DS"] + 2 * s["RP"] * s["NQ4"] + 2 * s["RP"] * C
            + 2 * s["NQ4"] * s["dl4"] * 4)


def chunk_threads(RP: int) -> int:
    return THREADS // (RP // 4)


def fused_pairs(C: int, DG: int) -> bool:
    """content_attn.cuh::ca_fused_pairs: a pair's clip attention in the
    registers of its row group's lanes."""
    return C == 4 and DG <= 32 and DG & (DG - 1) == 0


def bwd_layout(pp: int, C: int, Nq: int, dl: int, bf16: bool) -> Dict[str, int]:
    """content_attn.cuh::ca_bwd_layout: the backward's shared-memory arrays,
    byte offsets (each 16-byte aligned; absent arrays at 0), ``DSS`` the
    staged rows' stride in elements, ``fused`` and ``bytes``. fp32 rows:
    `smem_floats`' arrays; bf16: khat, fwh, q, h, dfcc as bf16 rows of 4 dl4
    + 8, and on the fused path neither g nor the clip arrays."""
    s = shape(pp, C, Nq, dl)
    fused = fused_pairs(C, chunk_threads(s["RP"]))
    DSS = s["dl4"] * 4 + 8 if bf16 else s["DS"]
    row, row32 = DSS * (2 if bf16 else 4), 4 * s["DS"]
    every = not bf16 or not fused
    sizes = [("K", s["NQ4"] * row), ("V", s["NQ4"] * row), ("fsh", row32),
             ("qm", 4 * s["NQ4"]), ("vm", 4 * s["PP4"]), ("Q", s["RP"] * row),
             ("H", s["RP"] * row), ("O", s["RP"] * row),
             ("G", s["RP"] * row32 if every else None), ("U", s["RP"] * row32),
             ("Pr", 4 * s["RP"] * s["NQ4"]), ("Dr", 4 * s["RP"] * s["NQ4"]),
             ("As", 4 * s["RP"] * C if every else None),
             ("dAs", 4 * s["RP"] * C if every else None),
             ("Fw", 16 * s["NQ4"] * s["dl4"]), ("Fk", 16 * s["NQ4"] * s["dl4"])]
    out, off = dict(DSS=DSS, fused=fused), 0
    for name, size in sizes:
        out[name] = 0 if size is None else off
        off += 0 if size is None else _ceil(size, 16) * 16
    out["bytes"] = off
    return out


def plan(B: int, N: int, C: int, Nq: int, dl: int, backward: bool,
         bf16: bool = False) -> Dict[str, int]:
    """content_attn.cuh::content_attn_plan: pairs per pass ``pp``, passes
    per block, blocks (tiles) per element and a block's shared memory in
    bytes (all 0: the shape is not taken), for fp32 rows, the bf16 forward
    (which stages fp32 rows) or, with ``bf16`` and ``backward``, the bf16
    backward (the fp32 backward's plan with `bwd_layout`'s shared memory)."""
    none = dict(pp=0, passes=0, tiles=0, smem=0)
    if B < 1 or N < 1 or C < 1 or C > ROWS or Nq < 1 or Nq > 32 or dl < 1:
        return none
    bf16_bwd = backward and bf16
    pp = ROWS // C

    def too_wide(pp):
        s = shape(pp, C, Nq, dl)
        return backward and s["dl4"] > 2 * chunk_threads(s["RP"])

    def smem_of(pp):
        if bf16_bwd:
            return bwd_layout(pp, C, Nq, dl, True)["bytes"]
        return 4 * smem_floats(pp, C, Nq, dl, backward)

    while pp > 1 and too_wide(pp):
        pp = (pp + 1) // 2
    smem = smem_of(pp)
    while smem > MAX_SMEM and pp > 1:
        pp = (pp + 1) // 2
        smem = smem_of(pp)
    if smem > MAX_SMEM or too_wide(pp):
        return none
    # The bf16 backward's registers allow one block an SM.
    per_sm = 1 if bf16_bwd else SMEM_PER_SM // (smem + RESERVED_PER_BLOCK)
    target = 4 * SMS * max(per_sm, 1)
    pass_tiles = _ceil(N, pp)
    passes = 1
    while (passes < MAX_PASSES and passes < pass_tiles
           and B * _ceil(N, pp * (passes + 1)) >= target):
        passes += 1
    return dict(pp=pp, passes=passes, tiles=_ceil(N, pp * passes), smem=smem)


def partial_floats(B: int, N: int, C: int, Nq: int, dl: int, bf16: bool = False) -> int:
    """The backward's per-tile partials: B * tiles of (2 Nq dl + dl) floats."""
    return B * plan(B, N, C, Nq, dl, True, bf16)["tiles"] * (2 * Nq * dl + dl)


def tile_bounds(p: Dict[str, int], N: int) -> List[List[Tuple[int, int]]]:
    """The pairs [n0, n1) of each pass of each tile of one element, as the
    kernels walk them."""
    out = []
    for tile in range(p["tiles"]):
        begin = tile * p["pp"] * p["passes"]
        end = min(N, begin + p["pp"] * p["passes"])
        out.append([(n0, min(n0 + p["pp"], end)) for n0 in range(begin, end, p["pp"])])
    return out


def content_attn_plain(h, q, khat, fwh, fsh, query_mask, vmask):
    """The plain version of the forward, the content unit of
    `models.smin.content_unit_packed` between its projections: h, q
    (B, N, C, dl) with h masked by vmask, khat, fwh (B, Nq, dl) with fwh
    masked by the query mask, fsh (B, dl), query_mask (B, Nq, 1), vmask
    (B, N) -> fcc (B, N, C, dl)."""
    dl = h.shape[-1]
    vm = vmask[..., None, None]
    logits = torch.einsum("bncd,bmd->bncm", q, khat) / math.sqrt(dl)
    logits = torch.where(query_mask[..., 0][:, None, None, :] > 0, logits, NEG_INF)
    f_caq = torch.einsum("bncm,bmd->bncd", torch.softmax(logits, dim=-1), fwh) * vm
    f_cq = h * (f_caq + fsh[:, None, None, :])
    A = torch.softmax(torch.einsum("bncd,bned->bnce", f_cq, f_cq) / math.sqrt(dl), dim=-1) * vm
    return torch.einsum("bnce,bned->bncd", A, h)


def content_attn_plain_bf16(h, q, khat, fwh, fsh, query_mask, vmask):
    """The plain version of the bf16 forward: `content_attn_plain` on the
    bf16 rows' values in fp32, rounded once to bf16 (the pair of
    models/smin.py::smi_block_packed_bf16)."""
    return content_attn_plain(h.float(), q.float(), khat.float(), fwh.float(), fsh.float(),
                              query_mask, vmask).to(torch.bfloat16)


def unit_projections(unit, fc, fw, fs, query_mask, vmask):
    """The pair's inputs as a content unit makes them from its own inputs:
    (h, q, khat, fwh, fsh) = (c_hat(fc) * vmask, attn_q(h), attn_k(fwh),
    w_hat(fw) * query_mask, s_hat(fs)), ``unit`` a `models.smin.ContentUnit`."""
    from video_moment_localization_tpu_torch.models.smin import _linear

    h = _linear(unit.linear_c_hat, fc) * vmask[..., None, None]
    fwh = _linear(unit.linear_w_hat, fw) * query_mask
    return (h.contiguous(), _linear(unit.attn_layer.W_q, h).contiguous(),
            _linear(unit.attn_layer.W_k, fwh).contiguous(), fwh.contiguous(),
            _linear(unit.linear_s_hat, fs).contiguous())


def content_attn_backward_plain(h, q, khat, fwh, fsh, query_mask, vmask, dfcc):
    """The plain version of the backward: the VJP of `content_attn_plain`.
    Returns (dh, dq, dfwh, dkhat, dfsh); on bf16 rows
    `content_attn_backward_plain_bf16`."""
    if h.dtype == torch.bfloat16:
        return content_attn_backward_plain_bf16(h, q, khat, fwh, fsh, query_mask, vmask, dfcc)
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (h, q, khat, fwh, fsh)]
        out = content_attn_plain(*leaves, query_mask, vmask)
        dh, dq, dkhat, dfwh, dfsh = torch.autograd.grad(out, leaves, dfcc)
    return dh, dq, dfwh, dkhat, dfsh


def content_attn_backward_plain_bf16(h, q, khat, fwh, fsh, query_mask, vmask, dfcc):
    """The plain version of the bf16 backward: the fp32 VJP on the bf16
    values, dq, dkhat and dfsh rounded once to bf16, dh and dfwh fp32 (the
    kernel's types)."""
    dh, dq, dfwh, dkhat, dfsh = content_attn_backward_plain(
        h.float(), q.float(), khat.float(), fwh.float(), fsh.float(), query_mask, vmask,
        dfcc.float())
    bf = torch.bfloat16
    return dh, dq.to(bf), dfwh, dkhat.to(bf), dfsh.to(bf)


def _library() -> ctypes.CDLL:
    lib = load_library("content_attn")
    for name in ("vml_content_attn_fwd_f32", "vml_content_attn_fwd_bf16"):
        fwd = getattr(lib, name)
        fwd.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 8
        fwd.restype = ctypes.c_int
    for name in ("vml_content_attn_bwd_f32", "vml_content_attn_bwd_bf16"):
        bwd = getattr(lib, name)
        bwd.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 14
        bwd.restype = ctypes.c_int
    lib.vml_content_attn_plan.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2
    lib.vml_content_attn_plan.restype = None
    lib.vml_content_attn_partial_floats.argtypes = [ctypes.c_int] * 6
    lib.vml_content_attn_partial_floats.restype = ctypes.c_size_t
    return lib


def card_plan(B: int, N: int, C: int, Nq: int, dl: int, backward: bool,
              bf16: bool = False) -> Dict[str, int]:
    """The C host code's plan, in `plan`'s form."""
    lib = _library()
    out = (ctypes.c_int * 3)()
    smem = ctypes.c_size_t()
    lib.vml_content_attn_plan(B, N, C, Nq, dl, int(backward), int(bf16), out,
                              ctypes.byref(smem))
    return dict(pp=out[0], passes=out[1], tiles=out[2], smem=smem.value)


def card_partial_floats(B: int, N: int, C: int, Nq: int, dl: int, bf16: bool = False) -> int:
    return _library().vml_content_attn_partial_floats(B, N, C, Nq, dl, int(bf16))


def _check(fn: str, backward: bool, h, q, khat, fwh, fsh, query_mask, vmask, extra=()):
    if h.device.type != "cuda":
        raise ValueError(f"{fn} takes CPU or CUDA tensors, got {h.device}")
    if h.dim() != 4 or khat.dim() != 3:
        raise ValueError(f"{fn}: want h (B, N, C, dl) and khat (B, Nq, dl), got "
                         f"{tuple(h.shape)} and {tuple(khat.shape)}")
    B, N, C, dl = h.shape
    Nq = khat.shape[1]
    rows = [("h", h, (B, N, C, dl)), ("q", q, (B, N, C, dl)), ("khat", khat, (B, Nq, dl)),
            ("fwh", fwh, (B, Nq, dl))] + [e for e in extra if e[0] == "dfcc"]
    extra = [e for e in extra if e[0] != "dfcc"]
    bf16 = h.dtype == torch.bfloat16
    if bf16:
        for name, t, want in rows:
            if (tuple(t.shape) != want or t.dtype != torch.bfloat16 or t.device != h.device
                    or not t.is_contiguous()):
                raise ValueError(f"{fn}: {name}: want contiguous bfloat16 {want} on "
                                 f"{h.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
        rows = []
    check_tensors(fn, h.device, rows + [("fsh", fsh, (B, dl)),
                                        ("query_mask", query_mask, (B, Nq, 1)),
                                        ("vmask", vmask, (B, N))] + list(extra))
    if not plan(B, N, C, Nq, dl, backward, bf16)["smem"]:
        raise ValueError(f"{fn}: C={C}, Nq={Nq}, dl={dl} are not taken by the kernel's plan")
    return B, N, C, Nq, dl


def content_attn_forward(h, q, khat, fwh, fsh, query_mask, vmask):
    """fcc (B, N, C, dl) of the pair (see `content_attn_plain`), in the
    type of h, q, khat and fwh: fp32, or bf16 (the bf16 variant; fsh and
    the masks fp32)."""
    bf16 = h.dtype == torch.bfloat16
    if h.device.type == "cpu":
        plain = content_attn_plain_bf16 if bf16 else content_attn_plain
        return plain(h, q, khat, fwh, fsh, query_mask, vmask)
    dims = _check("content_attn_forward", False, h, q, khat, fwh, fsh, query_mask, vmask)
    lib = _library()
    out = torch.empty_like(h)
    entry = "vml_content_attn_fwd_bf16" if bf16 else "vml_content_attn_fwd_f32"
    with torch.cuda.device(h.device):
        err = getattr(lib, entry)(stream_of(h), *dims, ptr(h), ptr(q), ptr(khat), ptr(fwh),
                                  ptr(fsh), ptr(query_mask), ptr(vmask), ptr(out))
    check(lib, entry, err)
    content_attn_forward.launches += 1
    return out


def content_attn_backward(h, q, khat, fwh, fsh, query_mask, vmask, dfcc):
    """The pair's backward from dfcc: (dh, dq, dfwh, dkhat, dfsh), the paths
    through the attention only (the projections' are their callers'). On
    bf16 h, q, khat, fwh and dfcc the bf16 variant: dh and dfwh fp32, dq,
    dkhat and dfsh bf16 (fsh and the masks fp32)."""
    if h.device.type == "cpu":
        return content_attn_backward_plain(h, q, khat, fwh, fsh, query_mask, vmask, dfcc)
    dims = _check("content_attn_backward", True, h, q, khat, fwh, fsh, query_mask, vmask,
                  [("dfcc", dfcc, tuple(h.shape))])
    bf16 = h.dtype == torch.bfloat16
    lib = _library()
    part = torch.empty(partial_floats(*dims, bf16), device=h.device, dtype=torch.float32)
    f32 = torch.float32
    dh, dq = torch.empty_like(h, dtype=f32), torch.empty_like(h)
    dfwh, dkhat = torch.empty_like(fwh, dtype=f32), torch.empty_like(khat)
    dfsh = torch.empty_like(fsh, dtype=h.dtype)
    entry = "vml_content_attn_bwd_bf16" if bf16 else "vml_content_attn_bwd_f32"
    with torch.cuda.device(h.device):
        err = getattr(lib, entry)(
            stream_of(h), *dims, ptr(h), ptr(q), ptr(khat), ptr(fwh), ptr(fsh),
            ptr(query_mask), ptr(vmask), ptr(dfcc), ptr(part), ptr(dh), ptr(dq), ptr(dfwh),
            ptr(dkhat), ptr(dfsh))
    check(lib, entry, err)
    content_attn_backward.launches += 1
    return dh, dq, dfwh, dkhat, dfsh


content_attn_forward.launches = 0
content_attn_backward.launches = 0


def _counters(name: str) -> ctypes.CDLL:
    lib = load_library(name)
    lib.vml_content_attn_launches.argtypes = [ctypes.c_void_p]
    lib.vml_content_attn_launches.restype = None
    lib.vml_content_attn_reset_launches.argtypes = []
    lib.vml_content_attn_reset_launches.restype = None
    return lib


def path_launches() -> Tuple[int, int]:
    """(forward, backward) launches of the pair by the entry points of K4,
    K2, K3, K9, K7 and K10 since `reset_path_launches`."""
    total = [0, 0]
    for name in PATH_LIBRARIES:
        out = (ctypes.c_longlong * 2)()
        _counters(name).vml_content_attn_launches(out)
        total[0] += out[0]
        total[1] += out[1]
    return total[0], total[1]


def reset_path_launches() -> None:
    for name in PATH_LIBRARIES:
        _counters(name).vml_content_attn_reset_launches()

"""K5: the fused 2-layer biLSTM of the serving path (csrc/lstm.cu).

Counterpart of ``video_moment_localization_tpu/ops/lstm_pallas.py::
bilstm_fused``. The layer-1 input projection ``x @ W_ih^T + b_ih`` runs
here, outside the kernel, as it does in the JAX wrapper; the kernel runs the
recurrence of both layers and directions and the layer-2 input projection.

On a CPU tensor the wrapper runs the plain version, ``models/lstm.py::
bilstm`` (imported here as `bilstm_plain`) at fp32 and ``bilstm_bf16`` at
bf16; on a CUDA tensor it launches the kernel or raises.
``bilstm_fused.launches`` counts the fp32 variant's launches,
``bilstm_fused.launches_bf16`` the bf16 variant's.

The kernel has an fp32 and a bf16 variant, chosen by ``x.dtype``. At bf16
(the JAX kernel at bf16) x, the weight matrices and the output are bf16 and
the biases fp32 (models/smin.py::cast_weights casts them once); gates and
sums are fp32, and the plain version is ``models/lstm.py::bilstm_bf16``.
Any other mix of types raises: the wrapper casts nothing. The bf16
variant's recurrence runs its product on the tensor cores, in clusters of 4
CTAs (the fp32 one in clusters of 8 on the CUDA cores); both plans have
Python mirrors here (`lstm_smem_bytes`, `row_choices`, `lstm_plan`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from video_moment_localization_tpu_torch.models.lstm import Layers
from video_moment_localization_tpu_torch.models.lstm import bilstm as bilstm_plain
from video_moment_localization_tpu_torch.models.lstm import bilstm_bf16
from video_moment_localization_tpu_torch.ops.cuda_build import (
    MAX_SMEM_BYTES,
    check,
    load_library,
    ptr,
    refuse_grad,
    stream_of,
)

_WEIGHTS = ("w_ih", "w_hh", "b_ih", "b_hh")


# The recurrence kernels' batch rows per cluster (multiples of ROW_STEP up
# to MAX_ROWS, csrc/lstm.cu) and their cluster sizes: 8 CTAs at fp32, 4 at
# bf16.
ROW_STEP = 16
MAX_ROWS = 96
CLUSTER = 8
CLUSTER_BF16 = 4


def _wslice_bytes(H: int) -> int:
    """csrc/lstm.cu::wslice_bytes: the fp32 W_hh slice (H, 4H/8 + 1)."""
    return 4 * H * (4 * H // CLUSTER + 1)


def lstm_smem_bytes(H: int, rows: int, itemsize: int = 4) -> int:
    """Shared memory of one recurrence CTA at an element size (4 fp32, 2
    bf16). fp32 (csrc/lstm.cu::layer_smem_bytes): its W_hh slice and h
    (rows, H), double-buffered where two copies fit in a block's shared
    memory. bf16 (layer_smem_bytes_bf): the slice's 4H/4 gate rows and two
    copies of h (rows, H), each row H + 8 bf16 elements."""
    if itemsize == 2:
        return 2 * (H + 8) * (4 * H // CLUSTER_BF16 + 2 * rows)
    double = _wslice_bytes(H) + 2 * 4 * rows * H <= MAX_SMEM_BYTES
    return _wslice_bytes(H) + (2 if double else 1) * 4 * rows * H


def max_rows(H: int, itemsize: int = 4) -> int:
    """csrc/lstm.cu::max_rows: the most rows per cluster that fit."""
    rows = MAX_ROWS
    while rows > ROW_STEP and lstm_smem_bytes(H, rows, itemsize) > MAX_SMEM_BYTES:
        rows -= ROW_STEP
    return rows


def row_choices(H: int, itemsize: int = 4) -> Tuple[int, ...]:
    return tuple(range(ROW_STEP, max_rows(H, itemsize) + 1, ROW_STEP))


def lstm_plan(B: int, H: int, max_active_clusters: Callable[[int], int],
              itemsize: int = 4) -> Tuple[int, int]:
    """Mirror of csrc/lstm.cu::plan_for: (rows per cluster, clusters) at
    batch B, the smallest row choice whose 2 * ceil(B / rows) clusters (two
    directions) the card holds at once, else the largest;
    ``max_active_clusters(rows)`` is what ``cudaOccupancyMaxActiveClusters``
    answers at that choice and element size (a bf16 cluster has 4 CTAs
    to fp32's 8, so the card holds about twice as many)."""
    for rows in row_choices(H, itemsize):
        clusters = 2 * -(-B // rows)
        if clusters <= max_active_clusters(rows):
            break
    return rows, clusters


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The lstm library with its entries' argument types, set once (the
    wrappers call this on every launch)."""
    lib = load_library("lstm")
    lib.vml_lstm_plan.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
    lib.vml_lstm_plan.restype = ctypes.c_int
    lib.vml_lstm_max_active_clusters.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.vml_lstm_max_active_clusters.restype = ctypes.c_int
    lib.vml_bilstm2_f32.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 19
    lib.vml_bilstm2_f32.restype = ctypes.c_int
    lib.vml_bilstm2_bf16.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 19
    lib.vml_bilstm2_bf16.restype = ctypes.c_int
    return lib


def _check_inputs(x: torch.Tensor, mask: torch.Tensor, layers: Layers) -> int:
    """The hidden size, once every tensor has the shape, device and type
    the variant of ``x.dtype`` takes: fp32 throughout, or at bf16 bf16
    matrices and fp32 biases."""
    if x.device.type != "cuda":
        raise ValueError(f"bilstm_fused takes CPU or CUDA tensors, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 3:
        raise ValueError(f"x must be float32 or bfloat16 (B, S, in), got {x.dtype} "
                         f"{tuple(x.shape)}")
    if mask.shape != x.shape[:2] or mask.device != x.device:
        raise ValueError(f"mask must be (B, S) on {x.device}, got {tuple(mask.shape)}")
    if len(layers) != 2:
        raise ValueError(f"the fused biLSTM has 2 layers, got {len(layers)}")
    H = layers[0]["fwd"]["w_hh"].shape[1]
    if H % 32 or H > 256:
        raise ValueError(f"hidden size {H} must be a multiple of 32 and at most 256")
    for k, layer in enumerate(layers):
        in_dim = x.shape[2] if k == 0 else 2 * H
        shapes = {"w_ih": (4 * H, in_dim), "w_hh": (4 * H, H), "b_ih": (4 * H,), "b_hh": (4 * H,)}
        for direction in ("fwd", "bwd"):
            for name in _WEIGHTS:
                w = layer[direction][name]
                dtype = x.dtype if name.startswith("w") else torch.float32
                if (tuple(w.shape) != shapes[name] or w.dtype != dtype
                        or w.device != x.device or not w.is_contiguous()):
                    raise ValueError(
                        f"layer {k} {direction} {name}: want contiguous {dtype} "
                        f"{shapes[name]} on {x.device}, got {w.dtype} "
                        f"{tuple(w.shape)} on {w.device}")
                if name == "w_hh" and w.data_ptr() % 16:
                    raise ValueError(f"layer {k} {direction} w_hh: want a 16-byte-aligned start")
    return H


def bilstm_fused(x: torch.Tensor, mask: torch.Tensor, layers: Layers,
                 rows: Optional[int] = None) -> torch.Tensor:
    """Fused 2-layer biLSTM forward: x (B, S, in), mask (B, S) -> (B, S, 2H).

    ``layers`` is `models.lstm.lstm_layers`' view of the weights, in torch's
    layout (w_ih (4H, in), w_hh (4H, H), gate order i, f, g, o). Grad-free:
    on CUDA tensors that would record a graph it raises (training runs
    `models.lstm.bilstm` under autograd). ``rows``: the bf16 kernel's rows per
    cluster, one of `row_choices(H, 2)` (the card tests hold each), in place
    of its plan's."""
    if x.device.type == "cpu":
        with torch.no_grad():
            plain = bilstm_bf16 if x.dtype == torch.bfloat16 else bilstm_plain
            return plain(x, mask, layers)
    H = _check_inputs(x, mask, layers)
    if rows is not None and (x.dtype != torch.bfloat16 or rows not in row_choices(H, 2)):
        raise ValueError(f"rows={rows}: the bf16 kernel takes one of {row_choices(H, 2)}")
    refuse_grad("bilstm_fused", [x] + [w for layer in layers for d in layer.values()
                                       for w in d.values()])
    itemsize = x.element_size()
    smem = lstm_smem_bytes(H, ROW_STEP, itemsize)     # the smallest plan's
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"hidden size {H} needs {smem} B of shared memory per block")
    lib = _library()
    B, S, _ = x.shape
    p1, p2 = layers
    x = x.contiguous()
    maskf = mask.to(torch.float32).contiguous()
    bf16 = x.dtype == torch.bfloat16
    # The layer-1 input projection (outside the TPU kernel too): the
    # library's product, at bf16 with the bias rounded to bf16 as the
    # plain version does.
    xp1f = F.linear(x, p1["fwd"]["w_ih"], p1["fwd"]["b_ih"].to(x.dtype))
    xp1b = F.linear(x, p1["bwd"]["w_ih"], p1["bwd"]["b_ih"].to(x.dtype))
    h1 = torch.empty((B, S, 2 * H), device=x.device, dtype=x.dtype)
    xp2f = torch.empty((B, S, 4 * H), device=x.device, dtype=x.dtype)
    xp2b = torch.empty_like(xp2f)
    out = torch.empty_like(h1)
    entry = "vml_bilstm2_bf16" if bf16 else "vml_bilstm2_f32"
    dims = (B, S, H, rows or 0) if bf16 else (B, S, H)
    with torch.cuda.device(x.device):
        err = getattr(lib, entry)(
            stream_of(x), *dims, ptr(xp1f), ptr(xp1b), ptr(maskf),
            ptr(p1["fwd"]["w_hh"]), ptr(p1["bwd"]["w_hh"]),
            ptr(p1["fwd"]["b_hh"]), ptr(p1["bwd"]["b_hh"]),
            ptr(p2["fwd"]["w_ih"]), ptr(p2["bwd"]["w_ih"]),
            ptr(p2["fwd"]["b_ih"]), ptr(p2["bwd"]["b_ih"]),
            ptr(p2["fwd"]["w_hh"]), ptr(p2["bwd"]["w_hh"]),
            ptr(p2["fwd"]["b_hh"]), ptr(p2["bwd"]["b_hh"]),
            ptr(h1), ptr(xp2f), ptr(xp2b), ptr(out))
    check(lib, entry, err)
    if bf16:
        bilstm_fused.launches_bf16 += 1
    else:
        bilstm_fused.launches += 1
    return out


bilstm_fused.launches = 0          # the fp32 variant's launches
bilstm_fused.launches_bf16 = 0     # the bf16 variant's


def card_plan(B: int, H: int = 256, itemsize: int = 4) -> Dict[str, int]:
    """The plan the kernel takes at batch B and element size (4 fp32, 2
    bf16) on the current card (``vml_lstm_plan``): rows per cluster,
    clusters, clusters the card holds at once at that choice, and one CTA's
    shared memory in bytes."""
    lib = _library()
    out = [ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), ctypes.c_size_t()]
    err = lib.vml_lstm_plan(B, H, itemsize, *[ctypes.byref(v) for v in out])
    check(lib, "vml_lstm_plan", err)
    rows, clusters, max_active, smem = (v.value for v in out)
    return dict(rows=rows, clusters=clusters, max_active_clusters=max_active, smem=smem)


def card_max_active_clusters(rows: int, H: int = 256, itemsize: int = 4) -> int:
    """``cudaOccupancyMaxActiveClusters`` of the layer kernel at that many
    rows per cluster and element size on the current card."""
    lib = _library()
    n = ctypes.c_int()
    err = lib.vml_lstm_max_active_clusters(H, rows, itemsize, ctypes.byref(n))
    check(lib, "vml_lstm_max_active_clusters", err)
    return n.value

"""The shared GEMM of ``csrc/gemm.cuh`` on its own (``csrc/gemm.cu``),
for the card tests and the GEMM phase of ``chip_smoke.py``, and a Python
mirror of its host-side plans.

The GEMM has two paths: 3xTF32 on the tensor cores (fp32-accurate: each
operand split into two TF32 parts, three products added in fp32) and fp32
FMAs on the CUDA cores. `path_for` is the static rule that picks one per
launch by shape, `SITE_PATHS` names the one call site that fixes its path
instead; ``gemm(..., path=...)`` forces one for the card tests and the
GEMM phase.

The GEMM is no port of a TPU kernel by itself: K2-K5, K7, K9 and K10 run
their projections through it inside their C entry points. ``gemm`` calls one
layout with every epilogue term; on a CPU tensor it runs its plain version
(``gemm_plain``: ``torch.matmul`` and the epilogue), on a CUDA tensor it
launches the kernel or raises. ``gemm.launches`` counts the launches.

The mirror (`path_for`, `tile_for`, `splitk_for`, `tn_partial_floats`,
`smem_bytes`) restates ``gemm.cuh``'s choices, and `model_gemm_shapes` lists the products
each kernel of the port launches, so the CPU tests can check every shape of
the shipped configs and ``chip_smoke.py`` can hold the mirror against the C
plan on the card.

The bf16 products (the bf16 variants of K2-K5, K7, K9 and K10, all three
layouts): bf16 operands, fp32 sums, the epilogue in fp32 with bf16 or fp32
residuals, a bf16 or fp32 result; gemm_tn's split and fixed-order reduction
are the fp32 path's. Two kernels, chosen statically by layout, shape and
alignment (`path_for` at bf16): BF16_WG, a persistent wgmma kernel fed by
TMA with a producer warp and an epilogue staged through shared memory, for
every product whose operands TMA can read; BF16, the ``mma.sync`` m16n8k16
kernel, for operands off 16-byte alignment or with leading dimensions no
multiple of 8. ``gemm_bf16_general`` launches any form of it (``gemm_bf16``
its nt layout, ``gemm_bf16_layout`` its nn and tn ones; the plain version
`gemm_bf16_general_plain` multiplies the bf16 values in fp32);
`model_gemm_shapes_bf16` lists the products and `epilogue_bf16` their
epilogue terms and output type; `wg_bf16_plan` and `wg_bf16_tile` restate
the wgmma kernel's plan and order of tiles.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import torch

from video_moment_localization_tpu_torch.ops.cuda_build import check, load_library, ptr, stream_of

BK = 16                     # K slice of a stage
STAGES = 5                  # slices in the ring of asynchronous copies (CUDA cores)
TC_STAGES = 3               # the same, tensor cores (each stage holds a slice twice)
WG_STAGES = 3               # the same, gemm_tn on the tensor cores (wgmma)
SMS = 132                   # H100 SXM
TILES = ((128, 128), (128, 64), (64, 64))   # csrc/gemm.cuh::GemmTile, in order
LAYOUTS = {"nt": 0, "nn": 1, "tn": 2}
CUDA_CORE, TENSOR = 0, 1    # csrc/gemm.cuh::GemmPath
BF16 = 2                    # csrc/gemm.cuh::kPathBf16 (mma.sync)
BF16_WG = 3                 # csrc/gemm.cuh::kPathBf16Wg (wgmma, TMA)
PATHS = {"cuda_core": CUDA_CORE, "tensor": TENSOR}
TC_PAD = 8                  # k-major row padding of the tensor-core path
BF16_BK = 32                # K slice of a stage of the bf16 path
BF16_LD = BF16_BK + 8       # bf16 per shared row of a k-contiguous slice
BF16_PAD = 8                # bf16 past R per shared row of a k-major slice
BF16_STAGES = 4
WG_BF16_TILE = 128          # gemm.cuh::kWgBfTile: columns of the wgmma kernel's output tile
WG_BF16_THREADS = 384       # kWgBfThreads: a producer and two consumer warpgroups
# gemm.cuh::WgBf by layout: (rows of a tile, K of a slice, stages of the ring);
# nt / nn one consumer warpgroup a tile in turns, tn both on one tile.
WG_BF16_SHAPE = {"nt": (64, 64, 5), "nn": (64, 64, 5), "tn": (128, 128, 2)}


# Call sites that fix their path instead of taking `path_for`'s: the moment
# unit's product over [x1 | x2] (csrc/smin_units.cuh::layer_forward) takes
# the tensor cores at every shape, where its rounding lands closest to
# float64 at the top of an SMI stack (gemm.cuh::kMomentProductPath).
MOMENT_PRODUCT = "conv_fb + conv_fc"
SITE_PATHS = {MOMENT_PRODUCT: TENSOR}


WG_MIN_ROWS = 512           # gemm.cuh::kWgMinRows
TC_MIN_WORK = 1 << 29       # gemm.cuh::kTcMinWork


def path_for(layout: str, M: int, N: int, K: int, groups: int = 1,
             dtype: torch.dtype = torch.float32, tma_ok: bool = True) -> int:
    """gemm.cuh::gemm_path_for: gemm_nt and gemm_nn take the tensor cores
    from M N K = TC_MIN_WORK on; gemm_tn (K: the rows it reduces) when a
    block reduces at least WG_MIN_ROWS rows; else the CUDA cores. A bf16
    product of any shape (gemm_path_for_bf16) takes the wgmma kernel
    BF16_WG where TMA can read its operands (``tma_ok``: 16-byte-aligned
    bases, leading dimensions multiples of 8), else the mma.sync kernel
    BF16."""
    if dtype == torch.bfloat16:
        if layout not in LAYOUTS:
            raise ValueError(f"unknown layout {layout!r}")
        return BF16_WG if tma_ok else BF16
    if layout == "tn":
        return TENSOR if splitk_for(M, N, K)[1] >= WG_MIN_ROWS else CUDA_CORE
    return TENSOR if M * N * K >= TC_MIN_WORK else CUDA_CORE


def site_path(product: Optional[str], layout: str, M: int, N: int, K: int, groups: int = 1) -> int:
    """The path a product of `model_gemm_shapes` runs on."""
    return SITE_PATHS.get(product, path_for(layout, M, N, K, groups))


def smem_bytes(tile: int, layout: str, path: int = TENSOR) -> int:
    """Dynamic shared memory of one block. CUDA cores
    (gemm.cuh::gemm_smem_floats): the ring of both operands' slices and two
    k-major slices of each operand that is contiguous along k (A unless tn,
    W if nt). Tensor cores, nt / nn (gemm_tc_smem_floats): a ring of
    TC_STAGES, each holding both operands' slices twice (big and small
    parts), W padded by TC_PAD floats per k when it is contiguous along its
    rows (nn); tn (gemm_wg_smem_floats) below."""
    bm, bn = TILES[tile]
    if path == BF16_WG:
        # gemm_bf16_wg_smem_bytes: 1024 bytes of alignment slack, the ring of
        # both operands' slices (rows x K and 128 x K bf16), each of two
        # warpgroups' staged 64 x 128 tile (fp32) and bf16 output tile, a
        # full and an empty mbarrier a stage.
        rows, bk, stages = WG_BF16_SHAPE[layout]
        return (1024 + stages * (rows + WG_BF16_TILE) * bk * 2 + 2 * 64 * WG_BF16_TILE * 6
                + 2 * stages * 8)
    if path == BF16:
        # gemm_bf16_smem_bytes: a ring of both operands' slices, rows of
        # BF16_LD bf16 where an operand is contiguous along k, else BF16_BK
        # rows of its R + BF16_PAD (A of tn, W of nn and tn).
        a = BF16_BK * (bm + BF16_PAD) if layout == "tn" else bm * BF16_LD
        w = BF16_BK * (bn + BF16_PAD) if layout != "nt" else bn * BF16_LD
        return 2 * BF16_STAGES * (a + w)
    if path == TENSOR and layout == "tn":
        # gemm_wg_smem_floats: the ring of both k-major slices, and two
        # big / small pairs of core-matrix tiles of each operand (128x128).
        return 4 * (WG_STAGES * 2 * BK * (128 + TC_PAD) + 2 * 2 * 2 * 128 * BK)
    if path == TENSOR:
        a = bm * BK
        w = bn * BK if layout == "nt" else BK * (bn + TC_PAD)
        return 4 * TC_STAGES * 2 * (a + w)
    transposed = (0 if layout == "tn" else bm) + (bn if layout == "nt" else 0)
    return 4 * BK * (STAGES * (bm + bn) + 2 * transposed)


def blocks_per_sm(layout: str, path: int) -> int:
    """Blocks an SM holds (their launch bounds and shared memory): one of
    gemm_tn's tensor-core kernel and of the bf16 wgmma kernel, two of every
    other."""
    return 1 if (path == TENSOR and layout == "tn") or path == BF16_WG else 2


def tiles(tile: int, M: int, N: int) -> int:
    bm, bn = TILES[tile]
    return -(-M // bm) * -(-N // bn)


def tile_for(M: int, N: int, groups: int = 1) -> int:
    """gemm.cuh::gemm_tile_for: the largest tile that fills both block
    slots of every SM, else the smallest. gemm_tn always takes 128x128."""
    for t in (0, 1):
        if tiles(t, M, N) * groups >= 2 * SMS:
            return t
    return 2


def splitk_for(M: int, N: int, R: int) -> Tuple[int, int]:
    """gemm.cuh::splitk_for: (splits, rows per split) of gemm_tn's R rows."""
    z = 2 * SMS // tiles(0, M, N)
    z = max(1, min(z, -(-R // 64)))
    kchunk = -(-R // z)
    kchunk = -(-kchunk // BK) * BK
    return -(-R // kchunk), kchunk


def tn_partial_floats(M: int, N: int, R: int) -> int:
    """gemm.cuh::gemm_tn_partial_floats: split products and column sums."""
    return splitk_for(M, N, R)[0] * (M * N + M)


def launch_grid(layout: str, M: int, N: int, K: int, groups: int = 1) -> Tuple[int, int, int]:
    """The (tile, gridDim.x, gridDim.z) of one launch (the same on both
    paths)."""
    if layout == "tn":
        return 0, tiles(0, M, N), splitk_for(M, N, K)[0]
    tile = tile_for(M, N, groups)
    return tile, tiles(tile, M, N), 1


def wg_bf16_split(layout: str, M: int, N: int, K: int) -> Tuple[int, int]:
    """(splits, rows a split) of the wgmma kernel's K: gemm_tn's splitk_for
    split of its R rows, one split of K otherwise."""
    return splitk_for(M, N, K) if layout == "tn" else (1, K)


def wg_bf16_plan(layout: str, M: int, N: int, K: int, groups: int = 1) -> Dict[str, int]:
    """gemm.cuh's plan of one launch of the wgmma kernel
    (vml_gemm_bf16_wg_plan): its output tiles (rows x 128, of every problem
    and split), its persistent blocks (one an SM, at most one a tile), the
    slices of a tile's K (of the first split), the ring's stages, the
    block's threads and the rows of a tile."""
    splits, kchunk = wg_bf16_split(layout, M, N, K)
    rows, bk, stages = WG_BF16_SHAPE[layout]
    tiles = -(-M // rows) * -(-N // WG_BF16_TILE) * groups * splits
    return dict(tiles=tiles, blocks=min(tiles, SMS), slices=-(-min(kchunk, K) // bk),
                stages=stages, threads=WG_BF16_THREADS, rows=rows)


def wg_bf16_tile(layout: str, M: int, N: int, K: int, groups: int, t: int):
    """gemm_bf16_wg_kernel's tile ``t``: (problem, split, first row, first
    column, first and end k). Column tiles fastest, then the problem (nt /
    nn) or the row tile (tn), then the row tile (nt / nn) or the split (tn);
    block b takes tiles b, b + blocks, b + 2 blocks, ... (nt / nn: its
    consumer warpgroups take them in turns)."""
    splits, kchunk = wg_bf16_split(layout, M, N, K)
    rows = WG_BF16_SHAPE[layout][0]
    tn_, tm_ = -(-N // WG_BF16_TILE), -(-M // rows)
    n0 = (t % tn_) * WG_BF16_TILE
    t //= tn_
    if layout == "tn":
        g, m0, z = 0, (t % tm_) * rows, t // tm_
    else:
        g, m0, z = t % groups, (t // groups) * rows, 0
    return g, z, m0, n0, z * kchunk, min(K, (z + 1) * kchunk)


def model_gemm_shapes_bf16(cfg, B: int) -> List[Tuple[str, str, str, int, int, int, int]]:
    """The products of the bf16 variants of K4 (one layer's, per layer), K5
    (the layer-2 projections), K2, K3, K7 (forward and backward), K9 and K10
    (forward and backward) at batch B, in `model_gemm_shapes`' form (the
    fp32 kernels' products at bf16); `epilogue_bf16` gives each one's
    epilogue terms and output type."""
    L, C, D, dl, Nq = cfg.L, cfg.C, cfg.D, cfg.dl, cfg.max_query_length
    H = cfg.lstm_hidden_size
    N = L * (L + 1) // 2
    NC = N * C
    k = "K4-bf16"
    return [("K5-bf16", "layer-2 projections", "nt", B * Nq, 4 * H, 2 * H, 2),
            (k, "c_hat", "nt", B * NC, dl, D, 1), (k, "attn_q", "nt", B * NC, dl, dl, 1),
            (k, "w_hat", "nt", B * Nq, dl, D, 1), (k, "attn_k", "nt", B * Nq, dl, dl, 1),
            (k, "s_hat", "nt", B, dl, D, 1), (k, "c_out", "nt", B * NC, D, dl, 1),
            (k, "bq", "nt", B * L, D, D, 1), (k, "bk", "nt", B * Nq, D, D, 1),
            (k, "conv_fb + conv_fc", "nt", B * N, D, 2 * D, 1)] + [
        (f"{s[0]}-bf16",) + s[1:] for s in model_gemm_shapes(cfg, B)
        if s[0] in ("K2", "K3", "K7f", "K7b", "K9", "K10f", "K10b")]


# The epilogue of each bf16 product (csrc/smin_units.cuh, content_bwd.cuh,
# content_train.cu, smin_train.cu, lstm.cu): its terms, by name (rmask and
# post2 with their divisor, "/C" for the clip rows' C) and its output type.
# gemm_tn's products write fp32 partial sums (the fixed-order reduction
# adds them), with the column sums of the scaled A ("colsum") where the bias
# gradient is taken and the row scale ("ascale") where the backward masks.
_EPILOGUES_BF16 = {
    "layer-2 projections": (("bias",), "bf16"),
    "c_hat": (("bias", "rmask/C"), "bf16"), "attn_q": (("bias",), "bf16"),
    "w_hat": (("bias", "rmask"), "bf16"), "attn_k": (("bias",), "bf16"),
    "s_hat": (("bias",), "fp32"),
    "c_out": (("bias", "rmask/C", "post", "post2/C"), "bf16"),
    "bq": (("bias",), "bf16"), "bk": (("bias",), "bf16"),
    "conv_fb + conv_fc": (("bias", "rmask", "post"), "bf16"),
    "conv_fc": (("bias", "rmask"), "bf16"),
    "dfcc": (("rmask/C",), "bf16"), "dW c_out": (("ascale/C", "colsum"), "fp32"),
    "dh attn_q": (("pre", "rmask/C"), "bf16"), "dW attn_q": (("colsum",), "fp32"),
    "dfwh attn_k": (("pre", "rmask"), "bf16"), "dW attn_k": (("colsum",), "fp32"),
    "dW w_hat": (("colsum",), "fp32"), "dW s_hat": (("colsum",), "fp32"),
    "dW c_hat": (("colsum",), "fp32"),
    "dfw": (("post32",), "bf16"), "dfs": (("post32",), "bf16"), "dfc": (("post",), "bf16"),
    "dx1 dx2": (("rmask",), "bf16"), "dW conv_fb + conv_fc": (("ascale", "colsum"), "fp32"),
    "dW conv_fc": (("ascale", "colsum"), "fp32"), "conv_fc dx2": (("rmask",), "bf16"),
    "dfb": (("post32",), "bf16"), "dfw bk": (("post32",), "fp32"),
    "dW bq": (("colsum",), "fp32"), "dW bk": (("colsum",), "fp32"),
}


def epilogue_bf16(kernel: str, product: str) -> Tuple[Tuple[str, ...], str]:
    """(epilogue terms, output type) of a product of `model_gemm_shapes_bf16`:
    K10's c_out adds its residuals in bf16 ("round_each"); K7 takes no other
    units' shares into dfw / dfs and K10 only its gate's into dfs (K3 both:
    "post32")."""
    terms, out = _EPILOGUES_BF16[product]
    if kernel.startswith("K10") and product == "c_out":
        terms += ("round_each",)
    if not kernel.startswith("K3") and product in ("dfw", "dfs") and not (
            kernel.startswith("K10") and product == "dfs"):
        terms = ()
    return terms, out


def model_gemm_shapes(cfg, B: int) -> List[Tuple[str, str, str, int, int, int, int]]:
    """Every product the port's kernels launch through gemm.cuh at batch B
    for the model config ``cfg``: (kernel, product, layout, M, N, K,
    groups), M, N, K as the C host code passes them (gemm_tn: M, N and the
    R rows it reduces). K4, K2, K3, K9 and K10 run on the packed map of L
    snippets; K7 on the same map as the content-unit route (ActivityNet).
    The moment unit is one product over [x1 | x2] (K = 2D) against [W_fb |
    W_fc]; K3 reduces its two weights' gradients in one product over both
    halves; K9 runs K2's products once per layer."""
    L, C, D, dl, Nq = cfg.L, cfg.C, cfg.D, cfg.dl, cfg.max_query_length
    H = cfg.lstm_hidden_size
    N = L * (L + 1) // 2
    NC = N * C

    def content_fwd(k):
        return [(k, "c_hat", "nt", B * NC, dl, D, 1), (k, "attn_q", "nt", B * NC, dl, dl, 1),
                (k, "w_hat", "nt", B * Nq, dl, D, 1), (k, "attn_k", "nt", B * Nq, dl, dl, 1),
                (k, "s_hat", "nt", B, dl, D, 1), (k, "c_out", "nt", B * NC, D, dl, 1)]

    def layer_fwd(k, moment=True):
        out = content_fwd(k) + [(k, "bq", "nt", B * L, D, D, 1), (k, "bk", "nt", B * Nq, D, D, 1)]
        if moment:
            out += [(k, "conv_fb + conv_fc", "nt", B * N, D, 2 * D, 1)]
        return out

    def content_bwd(k):
        return [(k, "dfcc", "nn", B * NC, dl, D, 1), (k, "dW c_out", "tn", D, dl, B * NC, 1),
                (k, "dh attn_q", "nn", B * NC, dl, dl, 1), (k, "dW attn_q", "tn", dl, dl, B * NC, 1),
                (k, "dfwh attn_k", "nn", B * Nq, dl, dl, 1), (k, "dW attn_k", "tn", dl, dl, B * Nq, 1),
                (k, "dW w_hat", "tn", dl, D, B * Nq, 1), (k, "dW s_hat", "tn", dl, D, B, 1),
                (k, "dW c_hat", "tn", dl, D, B * NC, 1),
                (k, "dfw", "nn", B * Nq, D, dl, 1), (k, "dfs", "nn", B, D, dl, 1),
                (k, "dfc", "nn", B * NC, D, dl, 1)]

    shapes = [("K5", "layer-2 projections", "nt", B * Nq, 4 * H, 2 * H, 2)]
    shapes += layer_fwd("K4")
    shapes += layer_fwd("K2") + layer_fwd("K9")
    shapes += layer_fwd("K3", moment=False) + content_bwd("K3") + [
        ("K3", "dx1 dx2", "nn", B * N, D, D, 2),
        ("K3", "dW conv_fb + conv_fc", "tn", D, 2 * D, B * N, 1),
        ("K3", "dfb", "nn", B * L, D, D, 1),
        ("K3", "dfw bk", "nn", B * Nq, D, D, 1), ("K3", "dW bq", "tn", D, D, B * L, 1),
        ("K3", "dW bk", "tn", D, D, B * Nq, 1)]
    shapes += content_fwd("K7f") + [("K7f", "conv_fc", "nt", B * N, D, D, 1)]
    shapes += content_fwd("K7b") + [("K7b", "conv_fc dx2", "nn", B * N, D, D, 1),
                                     ("K7b", "dW conv_fc", "tn", D, D, B * N, 1)] + content_bwd("K7b")
    shapes += content_fwd("K10f") + content_fwd("K10b") + content_bwd("K10b")
    return shapes


def gemm_plain(layout: str, A, W, ascale=None, adiv: int = 1, bias=None, pre=None, rmask=None,
               mask_div: int = 1, post=None, post2=None, post2_div: int = 1,
               bias_sums: bool = False):
    """The GEMM's function in torch ops: the product of the (row-scaled) A
    and W in the layout, then bias, pre, the row mask, post and post2 in
    that order (layouts nt and nn); gemm_tn returns (C, column sums of the
    scaled A) with ``bias_sums``."""
    if ascale is not None:
        idx = torch.arange(A.shape[0], device=A.device) // adiv
        A = A * ascale[idx][:, None]
    if layout == "tn":
        out = A.t() @ W
        return (out, A.sum(dim=0)) if bias_sums else out
    out = A @ (W.t() if layout == "nt" else W)
    rows = torch.arange(out.shape[0], device=out.device)
    if bias is not None:
        out = out + bias
    if pre is not None:
        out = out + pre
    if rmask is not None:
        out = out * rmask[rows // mask_div][:, None]
    if post is not None:
        out = out + post
    if post2 is not None:
        out = out + post2[rows // post2_div]
    return out


def _library() -> ctypes.CDLL:
    lib = load_library("gemm")
    fn = lib.vml_gemm_f32
    ints = {1, 2, 3, 4, 6, 8, 10, 12, 15, 17, 19, 21, 22, 23, 26}
    fn.argtypes = [ctypes.c_int if k in ints else ctypes.c_void_p for k in range(27)]
    fn.restype = ctypes.c_int
    lib.vml_gemm_tile_for.argtypes = [ctypes.c_int] * 3
    lib.vml_gemm_tile_for.restype = ctypes.c_int
    lib.vml_gemm_path_for.argtypes = [ctypes.c_int] * 5
    lib.vml_gemm_path_for.restype = ctypes.c_int
    lib.vml_gemm_moment_path.argtypes = []
    lib.vml_gemm_moment_path.restype = ctypes.c_int
    lib.vml_gemm_splitk.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    lib.vml_gemm_splitk.restype = None
    lib.vml_gemm_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.vml_gemm_smem_bytes.restype = ctypes.c_size_t
    lib.vml_gemm_tn_partial_floats.argtypes = [ctypes.c_int] * 3
    lib.vml_gemm_tn_partial_floats.restype = ctypes.c_size_t
    lib.vml_gemm_path_for_bf16.argtypes = [ctypes.c_int] * 2
    lib.vml_gemm_path_for_bf16.restype = ctypes.c_int
    lib.vml_gemm_bf16_wg_plan.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.vml_gemm_bf16_wg_plan.restype = None
    fn = lib.vml_gemm_bf16_general
    ints = {1, 2, 3, 4, 6, 8, 11, 14, 15, 19, 21, 23, 25, 27, 28, 29, 32}
    fn.argtypes = [ctypes.c_int if k in ints else ctypes.c_void_p for k in range(33)]
    fn.restype = ctypes.c_int
    return lib


def card_plan(layout: str, M: int, N: int, K: int, groups: int = 1,
              product: Optional[str] = None,
              dtype: torch.dtype = torch.float32, tma_ok: bool = True) -> Dict[str, int]:
    """The C host code's plan for one launch of ``product`` (a name of
    `model_gemm_shapes`, or at bf16 of `model_gemm_shapes_bf16`, whose
    operands TMA can read or, ``tma_ok`` False, cannot), to hold the mirror
    against."""
    lib = _library()
    if dtype == torch.bfloat16:
        path = lib.vml_gemm_path_for_bf16(LAYOUTS[layout], int(tma_ok))
        tile = 0 if layout == "tn" else lib.vml_gemm_tile_for(M, N, groups)
        out = dict(path=path, tile=tile, smem=lib.vml_gemm_smem_bytes(path, LAYOUTS[layout], tile))
        if path == BF16_WG:
            splits, kchunk = ctypes.c_int(1), ctypes.c_int(K)
            if layout == "tn":
                lib.vml_gemm_splitk(M, N, K, ctypes.byref(splits), ctypes.byref(kchunk))
            vals = (ctypes.c_longlong * 7)()
            lib.vml_gemm_bf16_wg_plan(LAYOUTS[layout], M, N, K, groups, splits.value,
                                      kchunk.value, vals)
            out.update(zip(("smem_wg", "tiles", "blocks", "slices", "stages", "threads", "rows"),
                           vals))
            if out.pop("smem_wg") != out["smem"]:
                raise RuntimeError("vml_gemm_bf16_wg_plan and vml_gemm_smem_bytes differ")
        return out
    path = (lib.vml_gemm_moment_path() if product == MOMENT_PRODUCT
            else lib.vml_gemm_path_for(LAYOUTS[layout], M, N, K, groups))
    if layout == "tn":
        splits, kchunk = ctypes.c_int(), ctypes.c_int()
        lib.vml_gemm_splitk(M, N, K, ctypes.byref(splits), ctypes.byref(kchunk))
        return dict(path=path, tile=0, smem=lib.vml_gemm_smem_bytes(path, 2, 0),
                    splits=splits.value, kchunk=kchunk.value,
                    partial_floats=lib.vml_gemm_tn_partial_floats(M, N, K))
    tile = lib.vml_gemm_tile_for(M, N, groups)
    return dict(path=path, tile=tile, smem=lib.vml_gemm_smem_bytes(path, LAYOUTS[layout], tile))


def plan(layout: str, M: int, N: int, K: int, groups: int = 1,
         product: Optional[str] = None, dtype: torch.dtype = torch.float32,
         tma_ok: bool = True) -> Dict[str, int]:
    """The mirror's plan for one launch, in `card_plan`'s form."""
    tile = launch_grid(layout, M, N, K, groups)[0]
    if dtype == torch.bfloat16:
        path = path_for(layout, M, N, K, groups, dtype, tma_ok)
        out = dict(path=path, tile=tile, smem=smem_bytes(tile, layout, path))
        if path == BF16_WG:
            out.update(wg_bf16_plan(layout, M, N, K, groups))
        return out
    path = site_path(product, layout, M, N, K, groups)
    out = dict(path=path, tile=tile, smem=smem_bytes(tile, layout, path))
    if layout == "tn":
        splits, kchunk = splitk_for(M, N, K)
        out.update(splits=splits, kchunk=kchunk, partial_floats=tn_partial_floats(M, N, K))
    return out


def _ld(name: str, t: Optional[torch.Tensor], device) -> int:
    if t is None:
        return 0
    if t.dim() != 2 or t.stride(1) != 1 or t.dtype != torch.float32 or t.device != device:
        raise ValueError(f"gemm: {name} must be a float32 matrix with unit column stride on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} strides {t.stride()}")
    return t.stride(0)


def gemm(layout: str, A, W, ascale=None, adiv: int = 1, bias=None, pre=None, rmask=None,
         mask_div: int = 1, post=None, post2=None, post2_div: int = 1, bias_sums: bool = False,
         tile: Optional[int] = None, out: Optional[torch.Tensor] = None,
         path: Optional[int] = None):
    """One launch of the shared GEMM: layout "nt" (A (M, K), W (N, K)),
    "nn" (W (K, N)) with the epilogue terms, or "tn" (A (R, M), W (R, N),
    no epilogue; with ``bias_sums`` also the column sums of the scaled A).
    Matrices may have any row stride (and any alignment: unaligned operands
    take the scalar path); ``out`` may be ``pre`` or ``post`` (in place);
    ``tile`` forces a block tile of nt / nn (an index into TILES), ``path``
    the path (CUDA_CORE or TENSOR; by `path_for` when None)."""
    if A.device.type == "cpu":
        return gemm_plain(layout, A, W, ascale, adiv, bias, pre, rmask, mask_div, post, post2,
                          post2_div, bias_sums)
    if layout not in LAYOUTS:
        raise ValueError(f"gemm: layout must be one of {sorted(LAYOUTS)}, got {layout!r}")
    if path not in (None, CUDA_CORE, TENSOR):
        raise ValueError(f"gemm: path must be None, CUDA_CORE or TENSOR, got {path!r}")
    dev = A.device
    lda, ldw = _ld("A", A, dev), _ld("W", W, dev)
    if layout == "tn":
        R, M = A.shape
        N, K = W.shape[1], R
        if W.shape[0] != R or any(t is not None for t in (bias, pre, rmask, post, post2)):
            raise ValueError("gemm tn: A (R, M), W (R, N), and no epilogue")
    else:
        M, K = A.shape
        N = W.shape[0] if layout == "nt" else W.shape[1]
        if (W.shape[1] if layout == "nt" else W.shape[0]) != K:
            raise ValueError(f"gemm {layout}: A {tuple(A.shape)} and W {tuple(W.shape)} differ in K")
        if layout == "nt" and ascale is not None:
            raise ValueError("gemm nt takes no ascale")
    for name, t, shape in (("ascale", ascale, None), ("bias", bias, (N,)), ("rmask", rmask, None)):
        if t is not None and (t.dim() != 1 or t.dtype != torch.float32 or t.device != dev
                              or not t.is_contiguous() or (shape and tuple(t.shape) != shape)):
            raise ValueError(f"gemm: {name} must be a contiguous float32 vector on {dev}")
    if out is None:
        out = torch.empty((M, N), device=dev, dtype=torch.float32)
    ldc = _ld("out", out, dev)
    if tuple(out.shape) != (M, N) or (layout == "tn" and ldc != N):
        raise ValueError(f"gemm: out must be ({M}, {N})")
    lib = _library()
    partial = colsum = None
    if layout == "tn":
        partial = torch.empty(tn_partial_floats(M, N, K), device=dev, dtype=torch.float32)
        if bias_sums:
            colsum = torch.empty(M, device=dev, dtype=torch.float32)
    nul = ctypes.c_void_p(0)
    p = lambda t: ptr(t) if t is not None else nul   # noqa: E731
    with torch.cuda.device(dev):
        err = lib.vml_gemm_f32(
            stream_of(A), LAYOUTS[layout], M, N, K, ptr(A), lda, p(ascale), adiv, ptr(W), ldw,
            ptr(out), ldc, p(bias), p(pre), _ld("pre", pre, dev), p(rmask), mask_div, p(post),
            _ld("post", post, dev), p(post2), _ld("post2", post2, dev), post2_div,
            -1 if tile is None else tile, p(partial), p(colsum), -1 if path is None else path)
    check(lib, "vml_gemm_f32", err)
    gemm.launches += 1
    return (out, colsum) if bias_sums else out


gemm.launches = 0


def gemm_bf16_general_plain(layout: str, A, W, W1=None, ascale=None, adiv: int = 1, bias=None,
                            bias1=None, pre=None, rmask=None, mask_div: int = 1, post=None,
                            post32=None, post2=None, post2_div: int = 1, round_each: bool = False,
                            out_dtype: torch.dtype = torch.bfloat16, bias_sums: bool = False,
                            split: int = 0):
    """The bf16 path's function in torch ops: the bf16 values multiplied in
    fp32. tn: the row-scaled A rounded to bf16 first, (A * ascale)^T W in
    fp32, with the column sums of the scaled A when ``bias_sums``, its
    columns cut in two at ``split`` when it is not 0. nt / nn:
    then bias, pre, the row mask, a bf16 rounding with ``round_each``, post,
    another, post32 and post2 in fp32, rounded once to ``out_dtype``; with
    W1 the second problem's output too (its own bias1, the other terms
    shared)."""
    A = A.to(torch.bfloat16).float()
    if layout == "tn":
        if ascale is not None:
            A = (A * ascale[torch.arange(A.shape[0], device=A.device) // adiv][:, None]).to(
                torch.bfloat16).float()
        out = A.t() @ W.to(torch.bfloat16).float()
        if split:
            out = (out[:, :split], out[:, split:])
        return (out, A.sum(dim=0)) if bias_sums else out
    rows = torch.arange(A.shape[0], device=A.device)

    def one(Wg, b):
        Wg = Wg.to(torch.bfloat16).float()
        out = A @ (Wg.t() if layout == "nt" else Wg)
        if b is not None:
            out = out + b
        if pre is not None:
            out = out + pre
        if rmask is not None:
            out = out * rmask[rows // mask_div][:, None]
        if round_each:
            out = out.to(torch.bfloat16).float()
        if post is not None:
            out = out + post.float()
        if round_each:
            out = out.to(torch.bfloat16).float()
        if post32 is not None:
            out = out + post32
        if post2 is not None:
            out = out + post2.float()[rows // post2_div]
        return out.to(out_dtype)

    return one(W, bias) if W1 is None else (one(W, bias), one(W1, bias1))


def gemm_bf16_plain(A, W, bias=None, rmask=None, mask_div: int = 1, post=None, post2=None,
                    post2_div: int = 1, out_dtype: torch.dtype = torch.bfloat16):
    """`gemm_bf16`'s plain version: A (M, K) @ W (N, K)^T, then bias, the
    row mask, post and post2 (`gemm_bf16_general_plain`'s nt layout)."""
    return gemm_bf16_general_plain("nt", A, W, bias=bias, rmask=rmask, mask_div=mask_div,
                                   post=post, post2=post2, post2_div=post2_div,
                                   out_dtype=out_dtype)


def gemm_bf16_layout_plain(layout: str, A, W, ascale=None, adiv: int = 1, bias=None, pre=None,
                           rmask=None, mask_div: int = 1, post32=None,
                           out_dtype: torch.dtype = torch.bfloat16, bias_sums: bool = False):
    """`gemm_bf16_layout`'s plain version (`gemm_bf16_general_plain`'s nn
    and tn layouts)."""
    return gemm_bf16_general_plain(layout, A, W, ascale=ascale, adiv=adiv, bias=bias, pre=pre,
                                   rmask=rmask, mask_div=mask_div, post32=post32,
                                   out_dtype=out_dtype, bias_sums=bias_sums)


def _ld16(name: str, t: Optional[torch.Tensor], device) -> int:
    if t is None:
        return 0
    if t.dim() != 2 or t.stride(1) != 1 or t.dtype != torch.bfloat16 or t.device != device:
        raise ValueError(f"gemm_bf16: {name} must be a bfloat16 matrix with unit column stride "
                         f"on {device}, got {t.dtype} {tuple(t.shape)} strides {t.stride()}")
    return t.stride(0)


def _bf16_path(name: str, path: Optional[int]) -> int:
    if path not in (None, BF16, BF16_WG):
        raise ValueError(f"{name}: path must be None, BF16 or BF16_WG, got {path!r}")
    return -1 if path is None else path


def gemm_bf16_general(layout: str, A, W, W1=None, ascale=None, adiv: int = 1, bias=None,
                      bias1=None, pre=None, rmask=None, mask_div: int = 1, post=None, post32=None,
                      post2=None, post2_div: int = 1, round_each: bool = False,
                      out_dtype: torch.dtype = torch.bfloat16, bias_sums: bool = False,
                      path: Optional[int] = None, split: int = 0):
    """One launch of any form of a bf16 product: layout "nt" (A (M, K), W
    (N, K)) or "nn" (W (K, N)), over two problems sharing A when W1 is
    given (nt: bf16 outputs), with every epilogue term (bias, bias1, rmask
    and ascale fp32 vectors; pre, post32 fp32 and post, post2 bf16 matrices;
    ``round_each``), or "tn" (A (R, M), W (R, N) -> (M, N) fp32, with the
    column sums of the scaled A when ``bias_sums``; with ``split``, one
    launch of two products of A side by side, returned as the (M, split) and
    (M, N - split) outputs, as K3's moment weights take them). Matrices may have any
    row stride and alignment: TMA reads 16-byte-aligned ones with row
    strides of multiples of 8, and the plan sends the rest to the mma.sync
    kernel; ``path`` forces a kernel (BF16: mma.sync; BF16_WG: wgmma, which
    refuses operands TMA cannot read). A CPU tensor runs
    `gemm_bf16_general_plain`; a CUDA tensor launches the kernel or raises
    (nothing is cast)."""
    if A.device.type == "cpu":
        return gemm_bf16_general_plain(layout, A, W, W1, ascale, adiv, bias, bias1, pre, rmask,
                                       mask_div, post, post32, post2, post2_div, round_each,
                                       out_dtype, bias_sums, split)
    if layout not in LAYOUTS:
        raise ValueError(f"gemm_bf16: unknown layout {layout!r}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"gemm_bf16: out_dtype must be bfloat16 or float32, got {out_dtype}")
    if layout == "nt" and W1 is not None and out_dtype != torch.bfloat16:
        raise ValueError("gemm_bf16: nt over two problems writes bf16")
    cpath = _bf16_path("gemm_bf16", path)
    dev = A.device
    lda, ldw = _ld16("A", A, dev), _ld16("W", W, dev)
    if W1 is not None and (W1.shape != W.shape or _ld16("W1", W1, dev) != ldw):
        raise ValueError("gemm_bf16: W1 must have W's shape and row stride")
    if layout == "tn":
        (R, M), N = A.shape, W.shape[1]
        K, out_dtype = R, torch.float32
        inner = W.shape[0]
    else:
        M, K = A.shape
        N, inner = (W.shape[0], W.shape[1]) if layout == "nt" else (W.shape[1], W.shape[0])
    if inner != K:
        raise ValueError(f"gemm_bf16 {layout}: A {tuple(A.shape)} and W {tuple(W.shape)} do "
                         f"not meet")
    for name, t, n in (("ascale", ascale, None), ("bias", bias, N), ("bias1", bias1, N),
                       ("rmask", rmask, None)):
        if t is not None and (t.dim() != 1 or t.dtype != torch.float32 or t.device != dev
                              or not t.is_contiguous() or (n and t.shape[0] != n)):
            raise ValueError(f"gemm_bf16: {name} must be a contiguous float32 vector on {dev}")
    for name, t, rows in (("pre", pre, M), ("post", post, M), ("post32", post32, M),
                          ("post2", post2, -(-M // post2_div))):
        if t is not None and tuple(t.shape) != (rows, N):
            raise ValueError(f"gemm_bf16: {name} must be ({rows}, {N}), got {tuple(t.shape)}")
    if split and (layout != "tn" or not 0 < split < N):
        raise ValueError(f"gemm_bf16: split {split} needs the tn layout and 0 < split < {N}")
    outs = [torch.empty((M, N), device=dev, dtype=out_dtype) for _ in range(1 if W1 is None else 2)]
    if split:
        outs = [torch.empty((M, n), device=dev, dtype=out_dtype) for n in (split, N - split)]
    partial = colsum = None
    if layout == "tn":
        partial = torch.empty(tn_partial_floats(M, N, K), device=dev, dtype=torch.float32)
        colsum = torch.empty(M, device=dev, dtype=torch.float32) if bias_sums else None
    lib = _library()
    nul = ctypes.c_void_p(0)
    p = lambda t: ptr(t) if t is not None else nul   # noqa: E731
    with torch.cuda.device(dev):
        err = lib.vml_gemm_bf16_general(
            stream_of(A), LAYOUTS[layout], M, N, K, ptr(A), lda, p(ascale), adiv, ptr(W),
            p(W1), ldw, ptr(outs[0]), p(outs[1] if len(outs) > 1 else None), split or N,
            int(out_dtype == torch.float32), p(bias), p(bias1), p(pre), _ld("pre", pre, dev),
            p(rmask), mask_div, p(post), _ld16("post", post, dev), p(post32),
            _ld("post32", post32, dev), p(post2), _ld16("post2", post2, dev), post2_div,
            int(round_each), p(partial), p(colsum), cpath)
    check(lib, "vml_gemm_bf16_general", err)
    gemm_bf16_general.launches += 1
    if layout == "tn":
        out = tuple(outs) if split else outs[0]
        return (out, colsum) if bias_sums else out
    return outs[0] if W1 is None else tuple(outs)


gemm_bf16_general.launches = 0


def gemm_bf16(A, W, bias=None, rmask=None, mask_div: int = 1, post=None, post2=None,
              post2_div: int = 1, out_dtype: torch.dtype = torch.bfloat16,
              path: Optional[int] = None):
    """The bf16 path's nt layout: A (M, K), W (N, K) bf16, bias (N,) and
    rmask fp32, post / post2 bf16 -> (M, N) in ``out_dtype``
    (`gemm_bf16_general`)."""
    return gemm_bf16_general("nt", A, W, bias=bias, rmask=rmask, mask_div=mask_div, post=post,
                             post2=post2, post2_div=post2_div, out_dtype=out_dtype, path=path)


def gemm_bf16_layout(layout: str, A, W, ascale=None, adiv: int = 1, bias=None, pre=None,
                     rmask=None, mask_div: int = 1, post32=None,
                     out_dtype: torch.dtype = torch.bfloat16, bias_sums: bool = False,
                     path: Optional[int] = None):
    """The bf16 path's nn (C = A W, A (M, K), W (K, N)) and tn (C = (A *
    ascale)^T W, A (R, M), W (R, N), fp32, with the column sums of the
    scaled A when ``bias_sums``) layouts (`gemm_bf16_general`)."""
    if layout not in ("nn", "tn"):
        raise ValueError(f"gemm_bf16_layout: layout nn or tn, not {layout!r} (nt: gemm_bf16)")
    return gemm_bf16_general(layout, A, W, ascale=ascale, adiv=adiv, bias=bias, pre=pre,
                             rmask=rmask, mask_div=mask_div, post32=post32, out_dtype=out_dtype,
                             bias_sums=bias_sums, path=path)


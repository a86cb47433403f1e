"""SMIN (Structured Multi-level Interaction Network) in PyTorch.

Counterpart of ``video_moment_localization_tpu/models/smin.py``. The module
tree carries the reference's ``state_dict`` key names (reference models.py
module tree), so a reference checkpoint, or JAX parameters carried across by
``models/port.py``, load with ``strict=True``. The modules are
parameter containers; the math lives in the plain functions below, one per
JAX function, over the triangular-packed moment layout (N = L(L+1)/2 pairs)
and over the dense L x L layout of ``packed: False``:

* the reference's three masking patterns are kept exactly: a pre-softmax
  -1e9 fill in the word and boundary attentions, and a post-softmax multiply
  in the intra-moment clip attention (SURVEY.md "masking subtleties");
* 1x1 convolutions are matmuls over the channel axis.

`smin_forward_inference` is the grad-free forward. For the packed layout
with the fused stack (the default) it runs the backbone with the fused
biLSTM (ops/lstm_cuda.py; the plain one under ``fused_lstm: False``), then
the fused SMI stack (ops/smin_cuda.py); every other mode goes through
`smin_forward` without a graph, as in the JAX package.
`smin_forward` is the differentiable forward: the backbone with the plain
biLSTM under autograd (the JAX package's own choice for training: its fused
biLSTM has no backward), then one of the JAX package's routes:

* packed, ``fused_smi_train`` and not ``compat_head`` (the default): by
  `whole_layer_train_admits`, the proposal rows kernel and the whole-layer
  SMI kernels with their hand-written backward (ops/proposal_cuda.py,
  ops/smin_train_cuda.py; all layers' forward in one launch under
  ``VML_SMIN_TRAIN_FUSED_FWD=1``), or the packed proposal kernel and the
  content-unit kernels (ops/content_train_cuda.py) with the boundary and
  moment units in PyTorch ops;
* packed otherwise (``compat_head``, or ``fused_smi_train: False``): the
  packed proposal kernel, then `smi_block_packed` per layer in PyTorch ops
  under autograd, its content unit the fused kernel of ops/content_cuda.py
  under ``fused_content``; pm densified to (B, L, L) under ``compat_head``;
* dense (``packed: False``): the dense proposal kernel, then `smi_block` per
  layer in PyTorch ops under autograd;

``compute_dtype: bfloat16`` takes every route (`check_dtype`), through the
bf16 variants of its kernels (K1, K2, K3 on the whole-layer route, K9 in
place of the per-layer K2s under ``VML_SMIN_TRAIN_FUSED_FWD=1``; K6, K7 on
the content-unit route; K6 and, under ``fused_content``, K10 in the packed
loop; K8 on the dense layout), as the JAX package does on the TPU; the
loops' other units run in bf16 with the JAX package's XLA arithmetic (every
op in bf16, masks cast to the activations' dtype, `_linear` casting weight
and bias). The parameters stay fp32, with differentiable bf16 casts
(`module_weights`). ``remat_smi`` recomputes each block of the two loop
routes in the backward.
The heads are plain PyTorch. Each kernel wrapper launches its CUDA kernel on
a CUDA tensor and runs its plain version on a CPU tensor.

`attention_weights_sink` captures the softmax weights of the plain attention
primitives (`word_attention`, `content_attention_packed`) for debugging, as
the JAX package's sink does; a kernel records nothing.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from video_moment_localization_tpu_torch.config import ModelConfig
from video_moment_localization_tpu_torch.models.lstm import (
    BiLSTMParams,
    bilstm,
    lstm_layers,
)
from video_moment_localization_tpu_torch.ops import lstm_cuda
from video_moment_localization_tpu_torch.ops.packing import (
    pair_index,
    packed_valid_mask,
    unpack_map,
)
from video_moment_localization_tpu_torch.ops.proposal import proposal_features_packed

_NEG_INF = -1e9


# --------------------------------------------------------------------- #
# Module tree (reference names)
# --------------------------------------------------------------------- #
class VideoEncoder(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.ve = nn.Linear(cfg.input_video_dim, cfg.D)
        self.pe = nn.Embedding(cfg.T, cfg.D)


class QueryEncoder(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.lstm = BiLSTMParams(cfg.word_dim, cfg.lstm_hidden_size, num_layers=2)


class Backbone(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.videoencoder = VideoEncoder(cfg)
        self.queryencoder = QueryEncoder(cfg)


class Attention(nn.Module):
    """Single-head scaled-dot attention without a value projection."""

    def __init__(self, dim: int):
        super().__init__()
        self.W_q = nn.Linear(dim, dim)
        self.W_k = nn.Linear(dim, dim)


class ContentUnit(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.linear_c_hat = nn.Linear(cfg.D, cfg.dl)
        self.linear_w_hat = nn.Linear(cfg.D, cfg.dl)
        self.linear_s_hat = nn.Linear(cfg.D, cfg.dl)
        self.linear_c = nn.Linear(cfg.dl, cfg.D)
        self.attn_layer = Attention(cfg.dl)


class BoundaryUnit(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.attn_layer = Attention(cfg.D)


class MomentUnit(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.conv_layer_fb = nn.Conv2d(cfg.D, cfg.D, 1)
        self.conv_layer_fc = nn.Conv2d(cfg.D, cfg.D, 1)


class SMI(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.content_unit = ContentUnit(cfg)
        self.boundary_unit = BoundaryUnit(cfg)
        self.moment_unit = MomentUnit(cfg)


class Localization(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.conv_layer_pm = nn.Conv2d(cfg.D, 1, 1)
        self.conv_layer_ps = nn.Conv1d(cfg.D, 1, 1)
        self.conv_layer_pe = nn.Conv1d(cfg.D, 1, 1)
        self.conv_layer_pa = nn.Conv1d(cfg.D, 1, 1)


class SMIN(nn.Module):
    """The reference module tree; ``forward`` is the serving forward."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = Backbone(cfg)
        self.smis = nn.ModuleList([SMI(cfg) for _ in range(cfg.num_smi_layers)])
        self.localization = Localization(cfg)

    def forward(self, video_features, video_mask, query_features, query_mask,
                length_mask, moment_mask=None, video_group=None):
        return smin_forward_inference(self, self.cfg, video_features, video_mask,
                                      query_features, query_mask, length_mask, moment_mask,
                                      video_group=video_group)


# The 20 parameters of one SMI block by name, in the order its CUDA entry
# points read them (`block_weights`).
BLOCK_WEIGHT_NAMES = tuple(
    f"{layer}.{kind}" for layer in (
        "content_unit.linear_c_hat", "content_unit.linear_w_hat", "content_unit.linear_s_hat",
        "content_unit.linear_c", "content_unit.attn_layer.W_q", "content_unit.attn_layer.W_k",
        "boundary_unit.attn_layer.W_q", "boundary_unit.attn_layer.W_k",
        "moment_unit.conv_layer_fb", "moment_unit.conv_layer_fc")
    for kind in ("weight", "bias"))


def block_weights(block: SMI) -> List[torch.Tensor]:
    """The 20 tensors of one SMI block in the order its CUDA entry points
    read them: weight, bias of c_hat, w_hat, s_hat, c_out, content attn
    W_q, W_k, boundary attn W_q, W_k, conv_fb, conv_fc
    (`BLOCK_WEIGHT_NAMES`)."""
    params = dict(block.named_parameters())
    return [params[name] for name in BLOCK_WEIGHT_NAMES]


def _linear(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Linear or 1x1 conv over the last axis. On activations of another
    dtype than the weight's (bf16) it is the JAX package's `_linear`: weight
    and bias cast to that dtype (`module_weights`), the bias added to the
    rounded product and rounded again."""
    w = layer.weight
    if x.dtype == w.dtype:
        return F.linear(x, w.reshape(w.shape[0], w.shape[1]), layer.bias)
    cast = module_weights(layer, x.dtype)
    w = cast["weight"]
    return F.linear(x, w.reshape(w.shape[0], w.shape[1])) + cast["bias"].to(x.dtype)


# --------------------------------------------------------------------- #
# Backbone: encoders + cross-modal Hadamard fusion
# --------------------------------------------------------------------- #
def video_encoder(ve: VideoEncoder, video_features, video_mask, frames: slice = slice(None)):
    """Masked linear projection + learned positional embedding (reference
    models.py:7-36): (B, T, dv), (B, T, 1) -> (B, T, D), in the dtype of
    ``video_features``. At bf16 the weights are cast as the JAX package casts
    them (`module_weights`) and the product is the library's bf16 one.
    ``frames``: the rows of the positional table that the frames given take
    (a sequence-parallel rank's clip shard)."""
    if video_features.dtype == torch.float32:
        x = _linear(ve.ve, video_features) * video_mask
        return x + ve.pe.weight[frames][None] * video_mask
    dtype = video_features.dtype
    w = module_weights(ve, dtype)
    mask = video_mask.to(dtype)
    x = F.linear(video_features, w["ve.weight"], w["ve.bias"].to(dtype)) * mask
    return x + w["pe.weight"][frames][None] * mask


def query_encoder(qe: QueryEncoder, query_features, query_mask, hidden_size: int,
                  fused_lstm: bool = True):
    """biLSTM sentence/word features (reference models.py:38-64): fs = [last
    valid forward state, backward state at t=0], fw = per-word outputs, from
    the fused biLSTM (ops/lstm_cuda.py), which is grad-free, or with
    ``fused_lstm=False`` from the plain one under autograd (models/lstm.py
    `bilstm`), as the JAX package runs its scan. At bf16 they take the
    weights' bf16 cast (`module_weights`) and return bf16 features."""
    mask = query_mask[..., 0]                                     # (B, Nq)
    layers = lstm_layers(qe.lstm, module_weights(qe.lstm, query_features.dtype)
                         if query_features.dtype != torch.float32 else None)
    run = lstm_cuda.bilstm_fused if fused_lstm else bilstm
    fw = run(query_features, mask, layers)
    lengths = mask.sum(dim=1).long().clamp(min=1)
    f_fwd = fw[torch.arange(fw.shape[0], device=fw.device), lengths - 1, :hidden_size]
    f_bwd = fw[:, 0, hidden_size:]
    return torch.cat([f_fwd, f_bwd], dim=-1), fw


def backbone(bb: Backbone, cfg: ModelConfig, video_features, video_mask,
             query_features, query_mask, video_group=None, fused_lstm: bool = True):
    """Cross-modal fusion f = fv * fs (reference models.py:66-83).

    ``video_group``: optional (vf_g (G, T, dv), vm_g (G, T, 1), vidx (B,)):
    the video encoder runs once per unique video and its rows are gathered
    to pairs before the fusion; ``video_features``/``video_mask`` are then
    ignored."""
    if video_group is None:
        fv = video_encoder(bb.videoencoder, video_features, video_mask)
    else:
        vf_g, vm_g, vidx = video_group
        fv = video_encoder(bb.videoencoder, vf_g, vm_g).index_select(0, vidx)
    fs, fw = query_encoder(bb.queryencoder, query_features, query_mask,
                           cfg.lstm_hidden_size, fused_lstm=fused_lstm)
    return fv * fs[:, None, :], fs, fw


# --------------------------------------------------------------------- #
# Attention primitives
# --------------------------------------------------------------------- #
# Debug introspection (JAX models/smin.py:178-207): the reference's Attention
# module keeps its last softmax weights on ``self.attn_weights`` (reference
# models.py:150). Inside `attention_weights_sink()` each plain attention
# primitive appends (name, weights) in call order instead.
_ATTN_SINK: Optional[list] = None


@contextlib.contextmanager
def attention_weights_sink():
    """Capture the attention weights of the forward passes run inside the
    block. Yields a list that fills with ``(name, weights)`` tuples:
    ``"word"`` for the boundary unit's query-word attention (B, L, Nq)
    (reference models.py:128-154) and ``"content"`` for the content-clip
    attention, (B, N, C, Nq) packed or (B, L, L, C, Nq) dense
    (models.py:198-226), per SMI layer content then word. The weights are
    detached. Re-entrant: the previous sink is restored on exit. A CUDA
    kernel records nothing (its plain version, which the CPU runs, does)."""
    global _ATTN_SINK
    prev, sink = _ATTN_SINK, []
    _ATTN_SINK = sink
    try:
        yield sink
    finally:
        _ATTN_SINK = prev


def _record_attn(name: str, weights: torch.Tensor) -> None:
    if _ATTN_SINK is not None:
        _ATTN_SINK.append((name, weights.detach()))


def word_attention(attn: Attention, query, key, value, key_mask):
    """Scaled-dot attention, raw value passthrough, -1e9 key mask (reference
    models.py:128-154). query (B, Lq, D), key/value (B, Lk, D),
    key_mask (B, Lk, 1)."""
    q = _linear(attn.W_q, query)
    k = _linear(attn.W_k, key)
    logits = torch.einsum("bqd,bkd->bqk", q, k) / math.sqrt(query.shape[-1])
    logits = torch.where(key_mask[..., 0][:, None, :] > 0, logits, _NEG_INF)
    weights = torch.softmax(logits, dim=-1)
    _record_attn("word", weights)
    return torch.einsum("bqk,bkd->bqd", weights, value)


def moment_gate(f_m, f_s):
    """fbar_m = sigmoid(f_m * f_s) * f_m, shared by the content and boundary
    units (reference models.py:191-193, 268-269). f_m (B, N, D) packed or
    (B, L, L, D) dense, f_s (B, D) broadcast over the map axes."""
    fs = f_s.reshape(f_s.shape[0], *([1] * (f_m.dim() - 2)), f_s.shape[-1])
    return torch.sigmoid(f_m * fs) * f_m


def content_attention_packed(attn: Attention, query3, key, value, key_mask, cells=None):
    """Word attention for every packed clip row: query3 (B, N, C, dl).
    ``cells``: the map's shape in place of N for the sink's record (the dense
    units' (L, L) or a rank's row block)."""
    q = _linear(attn.W_q, query3)
    k = _linear(attn.W_k, key)
    logits = torch.einsum("bncd,bmd->bncm", q, k) / math.sqrt(query3.shape[-1])
    logits = torch.where(key_mask[..., 0][:, None, None, :] > 0, logits, _NEG_INF)
    weights = torch.softmax(logits, dim=-1)
    _record_attn("content", weights if cells is None else
                 weights.reshape(weights.shape[0], *cells, *weights.shape[2:]))
    return torch.einsum("bncm,bmd->bncd", weights, value)


def content_unit_packed(cu: ContentUnit, f_c, f_w, f_s, f_m, query_mask, vmask,
                        fbar=None, cells=None):
    """ContentUnit (reference models.py:228-276) over packed pairs: f_c
    (B, N, C, D), f_m (B, N, D), vmask (B, N). The clip self-attention
    softmax is unmasked; the mask multiplies afterwards. Every op runs in
    f_c's dtype, the masks cast to it, as the JAX unit runs at bf16.
    ``cells``: see `content_attention_packed`."""
    dl = cu.linear_c_hat.weight.shape[0]
    f_c_mask = vmask[..., None, None].to(f_c.dtype)
    f_c_hat = _linear(cu.linear_c_hat, f_c) * f_c_mask               # (B, N, C, dl)
    f_w_hat = _linear(cu.linear_w_hat, f_w) * query_mask.to(f_c.dtype)
    f_s_hat = _linear(cu.linear_s_hat, f_s)

    f_caq = content_attention_packed(cu.attn_layer, f_c_hat, f_w_hat, f_w_hat,
                                     query_mask, cells) * f_c_mask
    f_cq = f_c_hat * (f_caq + f_s_hat[:, None, None, :])
    A_c = torch.einsum("bncd,bned->bnce", f_cq, f_cq) / math.sqrt(dl)
    A_c = torch.softmax(A_c, dim=-1) * f_c_mask

    f_cc_hat = torch.einsum("bnce,bned->bncd", A_c, f_c_hat)
    f_cc = _linear(cu.linear_c, f_cc_hat) * f_c_mask
    if fbar is None:
        fbar = moment_gate(f_m, f_s)
    return f_cc + f_c + fbar[:, :, None, :]


def _boundary_refine(bu: BoundaryUnit, f_b, f_w, f_s, query_mask, length_mask):
    """The boundary unit up to its moment message: (A_b (B, L, L), f_bb +
    f_b) (reference models.py:156-190, with the row-mask / fill /
    post-multiply ordering of A_b)."""
    D = f_b.shape[-1]
    f_b_mask = length_mask[..., None].to(f_b.dtype)                   # (B, L, 1)
    f_baq = word_attention(bu.attn_layer, f_b, f_w, f_w, query_mask) * f_b_mask
    f_bq = f_b * (f_baq + f_s[:, None, :])
    logits = torch.einsum("bid,bjd->bij", f_bq, f_bq) / math.sqrt(D)
    logits = torch.where(length_mask[:, None, :] > 0, logits, _NEG_INF)
    A_b = torch.softmax(logits, dim=-1) * f_b_mask                    # (B, L, L)
    f_bb = torch.einsum("bij,bjd->bid", A_b, f_b) * f_b_mask
    return A_b, f_bb + f_b


def boundary_unit_packed(bu: BoundaryUnit, f_b, f_w, f_s, f_m, query_mask,
                         length_mask, L: int, fbar=None):
    """BoundaryUnit (reference models.py:156-196) with the moment->boundary
    message read from packed f_m: f_bm[i] = sum_{n: i_n = i} A_b[i, j_n]
    fbar[n], summed in fp32 and rounded once to f_b's dtype (the JAX
    package's one-hot product, `rowsum_packed`)."""
    B, _, D = f_b.shape
    A_b, out = _boundary_refine(bu, f_b, f_w, f_s, query_mask, length_mask)
    if fbar is None:
        fbar = moment_gate(f_m, f_s)
    i_idx, j_idx = pair_index(L, f_b.device)
    A_bp = A_b[:, i_idx, j_idx]                                       # (B, N)
    msg = (A_bp[..., None] * fbar).float()
    f_bm = msg.new_zeros((B, L, D)).index_add_(1, i_idx, msg).to(f_b.dtype)
    return out + f_bm


def moment_unit_packed(mu: MomentUnit, f_c, f_m, f_b, vmask, L: int):
    """MomentUnit (reference models.py:278-303): conv of the boundary outer
    product plus conv of the clip mean, masked, plus the residual."""
    i_idx, j_idx = pair_index(L, f_b.device)
    f_m_mask = vmask[..., None].to(f_m.dtype)
    outer = f_b[:, i_idx] * f_b[:, j_idx]                             # (B, N, D)
    conv_fb = _linear(mu.conv_layer_fb, outer) * f_m_mask
    conv_fc = _linear(mu.conv_layer_fc, f_c.mean(dim=2)) * f_m_mask
    return conv_fb + conv_fc + f_m


def smi_block_packed(block: SMI, f_c, f_m, f_b, f_w, f_s, query_mask,
                     length_mask, vmask, L: int, fused_content: bool = False):
    """One interaction block (reference models.py:305-322): the moment unit
    consumes the updated content/boundary but the previous f_m. With
    ``fused_content`` the content unit is the kernel of ops/content_cuda.py
    (K10), which computes the gate itself."""
    fbar = moment_gate(f_m, f_s)
    if fused_content:
        # Imported here: ops/content_cuda.py imports this module.
        from video_moment_localization_tpu_torch.ops.content_cuda import content_unit_fused

        cu = content_unit_fused(block.content_unit, f_c, f_w, f_s, f_m, query_mask, vmask)
    else:
        cu = content_unit_packed(block.content_unit, f_c, f_w, f_s, f_m, query_mask,
                                 vmask, fbar=fbar)
    bu = boundary_unit_packed(block.boundary_unit, f_b, f_w, f_s, f_m, query_mask,
                              length_mask, L, fbar=fbar)
    mu = moment_unit_packed(block.moment_unit, cu, f_m, bu, vmask, L)
    return cu, mu, bu


def localization_packed(loc: Localization, f_m, f_b, length_mask, vmask, L: int,
                        dense_out: bool = False):
    """Four sigmoid 1x1-conv heads (reference models.py:324-344) in fp32;
    pm stays packed (B, N), or with ``dense_out`` (the reference-compat
    eval mode, ``compat_head``) is densified to (B, L, L), zeros at the
    invalid pairs."""
    f_m, f_b = f_m.float(), f_b.float()
    p_m = torch.sigmoid(_linear(loc.conv_layer_pm, f_m))[..., 0] * vmask
    if dense_out:
        p_m = unpack_map(p_m, L)
    p_s = torch.sigmoid(_linear(loc.conv_layer_ps, f_b))[..., 0] * length_mask
    p_e = torch.sigmoid(_linear(loc.conv_layer_pe, f_b))[..., 0] * length_mask
    p_a = torch.sigmoid(_linear(loc.conv_layer_pa, f_b))[..., 0] * length_mask
    return p_m, p_s, p_e, p_a


# --------------------------------------------------------------------- #
# The SMI layer at bf16 (the plain version of the bf16 variants of K4, K2
# and, by autograd, K3)
# --------------------------------------------------------------------- #
def _r16(x: torch.Tensor) -> torch.Tensor:
    """x's values rounded to bf16, in fp32. A bf16 tensor is converted (its
    gradient is rounded to bf16 there, where the stored value is read); an
    fp32 one is rounded with the gradient passed through unchanged, so a
    weight's gradient stays fp32 and an activation converted once stays
    rounded once."""
    if x.dtype == torch.bfloat16:
        return x.float()
    r = x.to(torch.bfloat16).float()
    return x + (r - x).detach() if x.requires_grad else r


class _Grad16(torch.autograd.Function):
    """Identity forward; the gradient rounded to bf16 (an fp32 value whose
    gradient the kernels store in bf16)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def _mm16(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w^T, w (N, K) or a 1x1 conv's (N, K, 1, 1), with bf16
    operands and fp32 sums: both are rounded to bf16 (`_r16`), and the
    product of two bf16 values is exact in fp32."""
    return _r16(x) @ _r16(w.reshape(w.shape[0], w.shape[1])).t()


def gate_bf16(fm32: torch.Tensor, fs32: torch.Tensor) -> torch.Tensor:
    """The moment gate of the bf16 kernels: fbar = sigmoid(fm * fs) * fm in
    fp32 from fm (B, N, D) and fs (B, D) read back in fp32, stored in bf16."""
    return (torch.sigmoid(fm32 * fs32[:, None]) * fm32).to(torch.bfloat16)


def content_bf16(w, fc32, fw32, fs32, qm, vm) -> torch.Tensor:
    """The ContentUnit of the bf16 kernels up to its residual: f_cc =
    c_out(f_cc_hat) * vmask (B, N, C, D) in fp32, from the unit's inputs fc,
    fw, fs read back in fp32 (each once, so that autograd rounds each input's
    gradient once), the query mask qm (B, Nq, 1) and the pair mask vm (B, N)
    in fp32; ``w`` the unit's parameters by `BLOCK_WEIGHT_NAMES` (matrices
    rounded to bf16, biases fp32). Products take bf16 operands with fp32
    sums; h, q, fwh, khat and f_cc_hat are stored in bf16, f_s_hat stays
    fp32 with its gradient stored in bf16 (`_Grad16`). K4, K2 and K7 (at
    bf16) add fc + fbar to it in fp32 and round once; K10 adds them in bf16
    as the JAX fused unit does."""
    # Imported here: the ops modules import this one.
    from video_moment_localization_tpu_torch.ops.content_attn_cuda import content_attn_plain_bf16

    bf = torch.bfloat16

    def proj(x, name):
        return _mm16(x, w[f"content_unit.{name}.weight"]) + w[f"content_unit.{name}.bias"]

    h32 = (proj(fc32, "linear_c_hat") * vm[..., None, None]).to(bf).float()
    q = proj(h32, "attn_layer.W_q").to(bf)
    fwh32 = (proj(fw32, "linear_w_hat") * qm).to(bf).float()
    khat = proj(fwh32, "attn_layer.W_k").to(bf)
    fsh = _Grad16.apply(proj(fs32, "linear_s_hat"))                # fp32 (B, dl)
    fcc = content_attn_plain_bf16(h32, q, khat, fwh32, fsh, qm, vm)
    return proj(fcc.float(), "linear_c") * vm[..., None, None]


def smi_layer_bf16(w, fc, fm, fb, fw, fs, query_mask, length_mask, vmask, L: int):
    """One SMI layer at bf16: fc (B, N, C, D), fm (B, N, D), fb (B, L, D),
    fw (B, Nq, D), fs (B, D) bf16 -> (cu, mu, bu) bf16; ``w`` the layer's
    parameters by `BLOCK_WEIGHT_NAMES` (matrices bf16 or fp32, rounded to
    bf16 either way; biases fp32). The function of `smi_block_packed`, with
    the arithmetic of the JAX layer kernels at bf16
    (ops/smin_pallas.py::smi_layer_rows): every product takes bf16 operands
    with fp32 sums, biases, gates, softmaxes and the other elementwise work
    are fp32, and every activation the layer keeps is stored in bf16 (fbar,
    h, q, fwh, khat, f_cc_hat, cu, bq, bk, f_bq, bu, the moment operands and
    mu; f_s_hat stays fp32). The kernels' order of operations is kept, so
    that K4's and K2's bf16 variants can be held to it.

    Under autograd it is the plain version of K3-bf16: each bf16 value is
    read back once (one `.float()`), so its gradient, the fp32 sum over its
    uses, is rounded to bf16 once there, as the kernel stores it; f_s_hat's
    gradient is stored in bf16 too (`_Grad16`); a value that is also an
    output of the layer (cu, bu) gets the outer cotangent added to that
    rounded gradient in bf16."""
    bf = torch.bfloat16

    def proj(x, name):
        return _mm16(x, w[f"{name}.weight"]) + w[f"{name}.bias"]

    B, N, C, D = fc.shape
    vm = vmask.float()
    qm = query_mask.float()                                         # (B, Nq, 1)
    lm = length_mask.float()
    fc32, fm32, fb32, fw32, fs32 = (t.float() for t in (fc, fm, fb, fw, fs))
    fbar = gate_bf16(fm32, fs32)
    fbar32 = fbar.float()

    # ContentUnit
    cu = (content_bf16(w, fc32, fw32, fs32, qm, vm) + fc32 + fbar32[:, :, None]).to(bf)

    # BoundaryUnit
    bq = proj(fb32, "boundary_unit.attn_layer.W_q").to(bf)
    bk = proj(fw32, "boundary_unit.attn_layer.W_k").to(bf)
    wl = torch.einsum("bid,bmd->bim", bq.float(), bk.float()) / math.sqrt(D)
    wl = torch.where(qm[..., 0][:, None, :] > 0, wl, _NEG_INF)
    f_baq = torch.einsum("bim,bmd->bid", torch.softmax(wl, dim=-1), fw32)
    fbq32 = (fb32 * (f_baq * lm[..., None] + fs32[:, None])).to(bf).float()
    al = torch.einsum("bid,bjd->bij", fbq32, fbq32) / math.sqrt(D)
    al = torch.where(lm[:, None, :] > 0, al, _NEG_INF)
    A_b = torch.softmax(al, dim=-1) * lm[..., None]
    i_idx, j_idx = pair_index(L, fb.device)
    f_bm = fb32.new_zeros((B, L, D)).index_add_(
        1, i_idx, A_b[:, i_idx, j_idx][..., None] * fbar32)
    bu = (torch.einsum("bij,bjd->bid", A_b, fb32) * lm[..., None] + fb32 + f_bm).to(bf)

    # MomentUnit: one product of [x1 | x2] with [W_fb | W_fc], bias b_fb + b_fc
    bu32 = bu.float()
    x1 = (bu32[:, i_idx] * bu32[:, j_idx]).to(bf)
    x2 = cu.float().mean(dim=2).to(bf)
    wm = torch.cat([w["moment_unit.conv_layer_fb.weight"].reshape(D, D),
                    w["moment_unit.conv_layer_fc.weight"].reshape(D, D)], dim=1)
    bias = w["moment_unit.conv_layer_fb.bias"] + w["moment_unit.conv_layer_fc.bias"]
    mu = ((_mm16(torch.cat([x1, x2], dim=-1).float(), wm) + bias) * vm[..., None]
          + fm32).to(bf)
    return cu, mu, bu


def smi_block_packed_bf16(block: SMI, fc, fm, fb, fw, fs, query_mask, length_mask, vmask,
                          L: int):
    """One SMI layer of the serving stack at bf16: `smi_layer_bf16` on the
    block's weights cast once (`cast_weights`)."""
    return smi_layer_bf16(cast_weights(block, torch.bfloat16), fc, fm, fb, fw, fs, query_mask,
                          length_mask, vmask, L)


def smin_stack_bf16(model: SMIN, cfg: ModelConfig, f, fw, fs, query_mask, length_mask,
                    vmask):
    """The serving stack at bf16 from the backbone outputs f (B, T, D), fw,
    fs (bf16): the proposal pooling in fp32 (prefix sums) stored in bf16,
    `smi_block_packed_bf16` per layer, and the fp32 heads -> (pm (B, N),
    ps, pe, pa (B, L)) fp32."""
    bf = torch.bfloat16
    length_mask = length_mask.float()
    fc, fm, fb = (x.to(bf) for x in proposal_features_packed(f.float(), length_mask, cfg.L,
                                                             cfg.C))
    for block in model.smis:
        fc, fm, fb = smi_block_packed_bf16(block, fc, fm, fb, fw, fs, query_mask, length_mask,
                                           vmask, cfg.L)
    return localization_packed(model.localization, fm, fb, length_mask, vmask.float(), cfg.L)


# --------------------------------------------------------------------- #
# SMI units over the dense L x L map (packed: False)
# --------------------------------------------------------------------- #
def content_unit(cu: ContentUnit, f_c, f_w, f_s, f_m, query_mask, moment_mask, fbar=None):
    """ContentUnit (reference models.py:228-276) over the dense map: f_c
    (B, R, L, C, D), f_m (B, R, L, D), moment_mask (B, R, L), R = L or a
    sequence-parallel rank's rows. The unit is the same per moment in both
    layouts, so this is `content_unit_packed` over the R * L cells as pairs,
    masked by the moment_mask."""
    B, R, L = moment_mask.shape

    def flat(x):
        return None if x is None else x.reshape(B, R * L, *x.shape[3:])

    out = content_unit_packed(cu, flat(f_c), f_w, f_s, flat(f_m), query_mask,
                              moment_mask.reshape(B, R * L), fbar=flat(fbar), cells=(R, L))
    return out.reshape(f_c.shape)


def boundary_unit(bu: BoundaryUnit, f_b, f_w, f_s, f_m, query_mask, length_mask, fbar=None):
    """BoundaryUnit (reference models.py:156-196) with the moment->boundary
    message f_bm[i] = sum_j A_b[i, j] fbar[i, j] from the dense f_m, summed
    in fp32 and rounded once to f_b's dtype (XLA's dot at bf16, as
    `boundary_unit_packed` sums its message)."""
    A_b, out = _boundary_refine(bu, f_b, f_w, f_s, query_mask, length_mask)
    if fbar is None:
        fbar = moment_gate(f_m, f_s)                                  # (B, L, L, D)
    return out + torch.einsum("bij,bijd->bid", A_b.float(), fbar.float()).to(f_b.dtype)


def moment_unit(mu: MomentUnit, f_c, f_m, f_b, moment_mask):
    """MomentUnit (reference models.py:278-303) over the dense map: conv of
    the boundary outer product plus conv of the clip mean, masked, plus the
    residual; the mask cast to f_m's dtype, as the JAX unit casts it."""
    f_m_mask = moment_mask[..., None].to(f_m.dtype)                   # (B, L, L, 1)
    outer = f_b[:, :, None, :] * f_b[:, None, :, :]                   # (B, L, L, D)
    conv_fb = _linear(mu.conv_layer_fb, outer) * f_m_mask
    conv_fc = _linear(mu.conv_layer_fc, f_c.mean(dim=3)) * f_m_mask
    return conv_fb + conv_fc + f_m


def smi_block(block: SMI, f_c, f_m, f_b, f_w, f_s, query_mask, length_mask, moment_mask):
    """One interaction block over the dense map (reference models.py:305-322)."""
    fbar = moment_gate(f_m, f_s)
    cu = content_unit(block.content_unit, f_c, f_w, f_s, f_m, query_mask, moment_mask,
                      fbar=fbar)
    bu = boundary_unit(block.boundary_unit, f_b, f_w, f_s, f_m, query_mask, length_mask,
                       fbar=fbar)
    mu = moment_unit(block.moment_unit, cu, f_m, bu, moment_mask)
    return cu, mu, bu


def localization(loc: Localization, f_m, f_b, length_mask, moment_mask):
    """The four heads over the dense map: pm (B, L, L) masked by the
    moment_mask, ps / pe / pa (B, L), in fp32."""
    f_m, f_b = f_m.float(), f_b.float()
    p_m = torch.sigmoid(_linear(loc.conv_layer_pm, f_m))[..., 0] * moment_mask
    p_s = torch.sigmoid(_linear(loc.conv_layer_ps, f_b))[..., 0] * length_mask
    p_e = torch.sigmoid(_linear(loc.conv_layer_pe, f_b))[..., 0] * length_mask
    p_a = torch.sigmoid(_linear(loc.conv_layer_pa, f_b))[..., 0] * length_mask
    return p_m, p_s, p_e, p_a


# --------------------------------------------------------------------- #
# Forward passes
# --------------------------------------------------------------------- #
def check_dtype(cfg: ModelConfig) -> None:
    """The check of every entry point (the differentiable forward, the
    train and eval steps, serving): fp32 and bf16 on every route of the JAX
    package, bf16 through the bf16 variants of K1-K3 and K9 (the whole-layer
    route), K6 and K7 (the content-unit route), K6 and K10 (``compat_head``
    + ``fused_content``), K8 (``packed: False``), the unit loops at bf16
    (``compat_head``, ``fused_smi_train: False``, the dense blocks) and,
    grad-free, K5 and K4 (the default serving route). Any other
    ``compute_dtype`` raises instead of running in fp32."""
    if cfg.compute_dtype not in ("float32", "bfloat16"):
        raise NotImplementedError(
            f"compute_dtype={cfg.compute_dtype} is not supported by the PyTorch port")


def serves_default_route(cfg: ModelConfig) -> bool:
    """Whether the grad-free forward takes the fused default route: the
    packed layout with the fused SMI stack, without ``compat_head``."""
    return cfg.packed and not cfg.compat_head and cfg.fused_smi


def cast_weights(module: nn.Module, dtype: torch.dtype) -> dict:
    """The module's parameters for a bf16 serving path, by name: matrices
    (2-D and up) cast to ``dtype``, vectors (biases) as they are, in fp32.
    The cast is made once and kept on the module until a parameter changes
    (its version counter or storage: an optimizer step, a load, a move).
    Grad-free: the tensors are detached (`module_weights` casts for
    training)."""
    cache = module.__dict__.setdefault("_cast_weights", {})
    params = list(module.named_parameters())
    key = tuple((p._version, p.data_ptr()) for _, p in params)
    hit = cache.get(dtype)
    if hit is not None and hit[0] == key:
        return hit[1]
    with torch.no_grad():
        out = {n: p.detach().to(dtype) if p.dim() >= 2 else p.detach() for n, p in params}
    cache[dtype] = (key, out)
    return out



def module_weights(module: nn.Module, dtype: torch.dtype) -> dict:
    """The module's parameters at ``dtype`` as `cast_weights` gives them
    (matrices cast, biases fp32), by name; when grad mode is on and a
    parameter requires grad, a differentiable cast made anew (its gradient
    reaches the fp32 parameter, as JAX's astype's does), else the kept
    grad-free cast."""
    params = list(module.named_parameters())
    if not (torch.is_grad_enabled() and any(p.requires_grad for _, p in params)):
        return cast_weights(module, dtype)
    return {n: p.to(dtype) if p.dim() >= 2 else p for n, p in params}


_WHOLE_LAYER_MAX_ROWS = 4352            # clip rows N * C of one element
_WHOLE_LAYER_BUDGET_BYTES = 90_000_000  # against 34 bytes per fc element and byte


def whole_layer_train_admits(cfg: ModelConfig) -> bool:
    """Which of the two kernel routes of the default training mode a config
    takes: True for the whole-layer kernels (K1, K2, K3), False for the
    content-unit kernels (K6, K7).

    This is the JAX package's routing, not a limit of the H100: its own copy
    of ``ops/smin_train_pallas.py::supports_train`` with the constants that
    ``ops/limits.py`` resolves to on the TPU the package was tuned on (a row
    cap of its backward kernel and that kernel's working set against its
    budget of fast memory). It is kept so that both packages train a given
    config through the same kernels: Charades passes at fp32 and bf16, TACoS
    (N * C = 2112) at bf16 but not at fp32 (over the budget), ActivityNet
    (N * C = 8320, over the row cap) at neither."""
    rows = cfg.L * (cfg.L + 1) // 2 * cfg.C
    itemsize = torch.finfo(getattr(torch, cfg.compute_dtype)).bits // 8
    return (rows <= _WHOLE_LAYER_MAX_ROWS
            and 34 * rows * cfg.D * itemsize <= _WHOLE_LAYER_BUDGET_BYTES)


def _run_blocks(block_fn, blocks, remat: bool, fc, fm, fb, *args):
    """Every block of ``blocks`` in turn over the carry (fc, fm, fb); with
    ``remat`` each block is recomputed in the backward instead of keeping
    its activations (JAX ``jax.checkpoint``)."""
    for block in blocks:
        if remat:
            fc, fm, fb = torch.utils.checkpoint.checkpoint(block_fn, block, fc, fm, fb, *args,
                                                           use_reentrant=False)
        else:
            fc, fm, fb = block_fn(block, fc, fm, fb, *args)
    return fm, fb


def smin_forward(
    model: SMIN,
    cfg: ModelConfig,
    video_features: Optional[torch.Tensor],   # (B, T, dv)
    video_mask: Optional[torch.Tensor],       # (B, T, 1)
    query_features: torch.Tensor,             # (B, Nq, word_dim)
    query_mask: torch.Tensor,                 # (B, Nq, 1)
    length_mask: torch.Tensor,                # (B, L)
    moment_mask: Optional[torch.Tensor] = None,   # (B, L, L); dense layout only
    video_group: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Differentiable forward -> (pm, ps, pe, pa (B, L)), fp32 in [0, 1]. pm
    is (B, N) packed in the default mode, (B, L, L) under ``compat_head`` or
    ``packed: False``; ``moment_mask`` is read by the dense layout only.
    The routes are those of the module docstring; ``video_group`` is that
    of `backbone`. ``compute_dtype: bfloat16`` (every route,
    `check_dtype`) follows the JAX package's bf16 training: the inputs cast
    to bf16, the parameters fp32 with differentiable bf16 casts where the
    JAX code casts them (`module_weights`; the kernels' own casts in
    ops/smin_train_cuda.py and ops/content_train_cuda.py), bf16 activations
    through the route's kernels at bf16 and the loops' units in bf16, and
    the heads and the loss in fp32."""
    # Imported here: these modules import this one for their plain versions.
    from video_moment_localization_tpu_torch.ops.content_train_cuda import (
        smi_stack_content_train,
    )
    from video_moment_localization_tpu_torch.ops.proposal_cuda import (
        proposal_features_dense_fused,
        proposal_features_packed_fused,
        proposal_features_rows,
    )
    from video_moment_localization_tpu_torch.ops.smin_train_cuda import smi_stack_layers

    check_dtype(cfg)
    dtype = getattr(torch, cfg.compute_dtype)
    if video_group is not None:
        video_group = (video_group[0].to(dtype),) + tuple(video_group[1:])
    elif video_features is not None:
        video_features = video_features.to(dtype)
    f, fs, fw = backbone(model.backbone, cfg, video_features, video_mask,
                         query_features.to(dtype), query_mask, video_group=video_group,
                         fused_lstm=False)
    length_mask = length_mask.float()
    if not cfg.packed:
        moment_mask = moment_mask.float()
        fc, fm, fb = proposal_features_dense_fused(f, moment_mask, cfg.L, cfg.C)
        fm, fb = _run_blocks(smi_block, model.smis, cfg.remat_smi, fc, fm, fb, fw, fs,
                             query_mask, length_mask, moment_mask)
        return localization(model.localization, fm, fb, length_mask, moment_mask)

    vmask = packed_valid_mask(length_mask)
    if cfg.fused_smi_train and not cfg.compat_head:
        if whole_layer_train_admits(cfg):
            proposal, stack = proposal_features_rows, smi_stack_layers
        else:
            proposal, stack = proposal_features_packed_fused, smi_stack_content_train
        fc, fm, fb = proposal(f, length_mask, cfg.L, cfg.C)
        fm, fb = stack(model.smis, fc, fm, fb, fw, fs, query_mask, length_mask, vmask, cfg.L)
        return localization_packed(model.localization, fm, fb, length_mask, vmask, cfg.L)

    fc, fm, fb = proposal_features_packed_fused(f, length_mask, cfg.L, cfg.C)
    fm, fb = _run_blocks(smi_block_packed, model.smis, cfg.remat_smi, fc, fm, fb, fw, fs,
                         query_mask, length_mask, vmask, cfg.L, cfg.fused_content)
    return localization_packed(model.localization, fm, fb, length_mask, vmask, cfg.L,
                               dense_out=cfg.compat_head)


@torch.no_grad()
def smin_forward_inference(
    model: SMIN,
    cfg: ModelConfig,
    video_features: Optional[torch.Tensor],   # (B, T, dv)
    video_mask: Optional[torch.Tensor],       # (B, T, 1)
    query_features: torch.Tensor,             # (B, Nq, word_dim)
    query_mask: torch.Tensor,                 # (B, Nq, 1)
    length_mask: torch.Tensor,                # (B, L)
    moment_mask: Optional[torch.Tensor] = None,   # (B, L, L); dense layout only
    video_group: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Grad-free forward with the contract of `smin_forward`: the fused
    biLSTM (or the plain one under ``fused_lstm: False``) and the fused SMI
    stack for the packed layout with ``fused_smi`` and without
    ``compat_head``; `smin_forward` without a graph otherwise.

    ``compute_dtype: bfloat16`` (`check_dtype`; the other routes, the dense
    layout among them, through `smin_forward`) follows the JAX package's
    bf16 serving: the parameters stay fp32 and are cast to bf16 where its
    kernels cast them, activations are stored in bf16, products take bf16
    operands with fp32 sums, gates, softmaxes and other elementwise work run
    in fp32, the proposal pooling's prefix sums stay fp32, and the heads and
    scores are fp32."""
    # Imported here: ops/smin_cuda.py imports this module for its plain version.
    from video_moment_localization_tpu_torch.ops.smin_cuda import smin_stack_fused

    check_dtype(cfg)
    if not serves_default_route(cfg):
        return smin_forward(model, cfg, video_features, video_mask, query_features,
                            query_mask, length_mask, moment_mask, video_group=video_group)
    dtype = getattr(torch, cfg.compute_dtype)
    if video_group is None:
        video_features = video_features.to(dtype)
    else:
        video_group = (video_group[0].to(dtype),) + tuple(video_group[1:])
    f, fs, fw = backbone(model.backbone, cfg, video_features, video_mask,
                         query_features.to(dtype), query_mask, video_group=video_group,
                         fused_lstm=cfg.fused_lstm)
    vmask = packed_valid_mask(length_mask)
    return smin_stack_fused(model, cfg, f, fw, fs, query_mask, length_mask, vmask)

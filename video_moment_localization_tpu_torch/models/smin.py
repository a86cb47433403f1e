"""SMIN (Structured Multi-level Interaction Network) in PyTorch.

Counterpart of ``video_moment_localization_tpu/models/smin.py``. The module
tree carries the reference's ``state_dict`` key names (reference models.py
module tree), so a reference checkpoint, or JAX parameters carried across by
``models/port.py``, load with ``strict=True``. The modules are
parameter containers; the math lives in the plain functions below, one per
JAX function, over the triangular-packed moment layout (N = L(L+1)/2 pairs):

* the reference's three masking patterns are kept exactly: a pre-softmax
  -1e9 fill in the word and boundary attentions, and a post-softmax multiply
  in the intra-moment clip attention (SURVEY.md "masking subtleties");
* 1x1 convolutions are matmuls over the channel axis.

`smin_forward_inference` is the serving forward: the backbone with the fused
biLSTM (ops/lstm_cuda.py), then the fused SMI stack (ops/smin_cuda.py).
`smin_forward` is the differentiable training forward: the backbone with the
plain biLSTM under autograd (the JAX package's own choice for training: its
fused biLSTM has no backward), then one of the JAX package's two kernel
routes (`whole_layer_train_admits`): the proposal rows kernel and the
whole-layer SMI kernels with their hand-written backward
(ops/proposal_cuda.py, ops/smin_train_cuda.py), or the packed proposal
kernel and the content-unit kernels (ops/content_train_cuda.py) with the
boundary and moment units in PyTorch ops; then the heads in plain PyTorch.
Each wrapper launches its CUDA kernel on a CUDA tensor and runs its plain
version on a CPU tensor.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from video_moment_localization_tpu_torch.config import ModelConfig
from video_moment_localization_tpu_torch.models.lstm import BiLSTMParams, bilstm, lstm_layers
from video_moment_localization_tpu_torch.ops import lstm_cuda
from video_moment_localization_tpu_torch.ops.packing import pair_index, packed_valid_mask

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
                length_mask, video_group=None):
        return smin_forward_inference(self, self.cfg, video_features, video_mask,
                                      query_features, query_mask, length_mask,
                                      video_group=video_group)


def block_weights(block: SMI) -> List[torch.Tensor]:
    """The 20 tensors of one SMI block in the order its CUDA entry points
    read them: weight, bias of c_hat, w_hat, s_hat, c_out, content attn
    W_q, W_k, boundary attn W_q, W_k, conv_fb, conv_fc."""
    cu, bu, mu = block.content_unit, block.boundary_unit, block.moment_unit
    out = []
    for layer in (cu.linear_c_hat, cu.linear_w_hat, cu.linear_s_hat, cu.linear_c,
                  cu.attn_layer.W_q, cu.attn_layer.W_k, bu.attn_layer.W_q,
                  bu.attn_layer.W_k, mu.conv_layer_fb, mu.conv_layer_fc):
        out += [layer.weight, layer.bias]
    return out


def _linear(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Linear or 1x1 conv over the last axis."""
    w = layer.weight
    return F.linear(x, w.reshape(w.shape[0], w.shape[1]), layer.bias)


# --------------------------------------------------------------------- #
# Backbone: encoders + cross-modal Hadamard fusion
# --------------------------------------------------------------------- #
def video_encoder(ve: VideoEncoder, video_features, video_mask):
    """Masked linear projection + learned positional embedding (reference
    models.py:7-36): (B, T, dv), (B, T, 1) -> (B, T, D)."""
    x = _linear(ve.ve, video_features) * video_mask
    return x + ve.pe.weight[None] * video_mask


def query_encoder(qe: QueryEncoder, query_features, query_mask, hidden_size: int,
                  fused_lstm: bool = True):
    """biLSTM sentence/word features (reference models.py:38-64): fs = [last
    valid forward state, backward state at t=0], fw = per-word outputs, from
    the fused biLSTM (ops/lstm_cuda.py), which is grad-free, or with
    ``fused_lstm=False`` from the plain one (models/lstm.py) under autograd."""
    mask = query_mask[..., 0]                                     # (B, Nq)
    layers = lstm_layers(qe.lstm)
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
# SMI units over packed pairs
# --------------------------------------------------------------------- #
def word_attention(attn: Attention, query, key, value, key_mask):
    """Scaled-dot attention, raw value passthrough, -1e9 key mask (reference
    models.py:128-154). query (B, Lq, D), key/value (B, Lk, D),
    key_mask (B, Lk, 1)."""
    q = _linear(attn.W_q, query)
    k = _linear(attn.W_k, key)
    logits = torch.einsum("bqd,bkd->bqk", q, k) / math.sqrt(query.shape[-1])
    logits = torch.where(key_mask[..., 0][:, None, :] > 0, logits, _NEG_INF)
    return torch.einsum("bqk,bkd->bqd", torch.softmax(logits, dim=-1), value)


def moment_gate(f_m, f_s):
    """fbar_m = sigmoid(f_m * f_s) * f_m, shared by the content and boundary
    units (reference models.py:191-193, 268-269). f_m (B, N, D), f_s (B, D)."""
    return torch.sigmoid(f_m * f_s[:, None, :]) * f_m


def content_attention_packed(attn: Attention, query3, key, value, key_mask):
    """Word attention for every packed clip row: query3 (B, N, C, dl)."""
    q = _linear(attn.W_q, query3)
    k = _linear(attn.W_k, key)
    logits = torch.einsum("bncd,bmd->bncm", q, k) / math.sqrt(query3.shape[-1])
    logits = torch.where(key_mask[..., 0][:, None, None, :] > 0, logits, _NEG_INF)
    return torch.einsum("bncm,bmd->bncd", torch.softmax(logits, dim=-1), value)


def content_unit_packed(cu: ContentUnit, f_c, f_w, f_s, f_m, query_mask, vmask,
                        fbar=None):
    """ContentUnit (reference models.py:228-276) over packed pairs: f_c
    (B, N, C, D), f_m (B, N, D), vmask (B, N). The clip self-attention
    softmax is unmasked; the mask multiplies afterwards."""
    dl = cu.linear_c_hat.weight.shape[0]
    f_c_mask = vmask[..., None, None]
    f_c_hat = _linear(cu.linear_c_hat, f_c) * f_c_mask               # (B, N, C, dl)
    f_w_hat = _linear(cu.linear_w_hat, f_w) * query_mask
    f_s_hat = _linear(cu.linear_s_hat, f_s)

    f_caq = content_attention_packed(cu.attn_layer, f_c_hat, f_w_hat, f_w_hat,
                                     query_mask) * f_c_mask
    f_cq = f_c_hat * (f_caq + f_s_hat[:, None, None, :])
    A_c = torch.einsum("bncd,bned->bnce", f_cq, f_cq) / math.sqrt(dl)
    A_c = torch.softmax(A_c, dim=-1) * f_c_mask

    f_cc_hat = torch.einsum("bnce,bned->bncd", A_c, f_c_hat)
    f_cc = _linear(cu.linear_c, f_cc_hat) * f_c_mask
    if fbar is None:
        fbar = moment_gate(f_m, f_s)
    return f_cc + f_c + fbar[:, :, None, :]


def boundary_unit_packed(bu: BoundaryUnit, f_b, f_w, f_s, f_m, query_mask,
                         length_mask, L: int, fbar=None):
    """BoundaryUnit (reference models.py:156-196) with the moment->boundary
    message read from packed f_m: f_bm[i] = sum_{n: i_n = i} A_b[i, j_n]
    fbar[n]."""
    B, _, D = f_b.shape
    f_b_mask = length_mask[..., None]                                 # (B, L, 1)
    f_baq = word_attention(bu.attn_layer, f_b, f_w, f_w, query_mask) * f_b_mask
    f_bq = f_b * (f_baq + f_s[:, None, :])
    logits = torch.einsum("bid,bjd->bij", f_bq, f_bq) / math.sqrt(D)
    logits = torch.where(length_mask[:, None, :] > 0, logits, _NEG_INF)
    A_b = torch.softmax(logits, dim=-1) * f_b_mask                    # (B, L, L)
    f_bb = torch.einsum("bij,bjd->bid", A_b, f_b) * f_b_mask

    if fbar is None:
        fbar = moment_gate(f_m, f_s)
    i_idx, j_idx = pair_index(L, f_b.device)
    A_bp = A_b[:, i_idx, j_idx]                                       # (B, N)
    f_bm = f_b.new_zeros((B, L, D)).index_add_(1, i_idx, A_bp[..., None] * fbar)
    return f_bb + f_b + f_bm


def moment_unit_packed(mu: MomentUnit, f_c, f_m, f_b, vmask, L: int):
    """MomentUnit (reference models.py:278-303): conv of the boundary outer
    product plus conv of the clip mean, masked, plus the residual."""
    i_idx, j_idx = pair_index(L, f_b.device)
    f_m_mask = vmask[..., None]
    outer = f_b[:, i_idx] * f_b[:, j_idx]                             # (B, N, D)
    conv_fb = _linear(mu.conv_layer_fb, outer) * f_m_mask
    conv_fc = _linear(mu.conv_layer_fc, f_c.mean(dim=2)) * f_m_mask
    return conv_fb + conv_fc + f_m


def smi_block_packed(block: SMI, f_c, f_m, f_b, f_w, f_s, query_mask,
                     length_mask, vmask, L: int):
    """One interaction block (reference models.py:305-322): the moment unit
    consumes the updated content/boundary but the previous f_m."""
    fbar = moment_gate(f_m, f_s)
    cu = content_unit_packed(block.content_unit, f_c, f_w, f_s, f_m, query_mask,
                             vmask, fbar=fbar)
    bu = boundary_unit_packed(block.boundary_unit, f_b, f_w, f_s, f_m, query_mask,
                              length_mask, L, fbar=fbar)
    mu = moment_unit_packed(block.moment_unit, cu, f_m, bu, vmask, L)
    return cu, mu, bu


def localization_packed(loc: Localization, f_m, f_b, length_mask, vmask, L: int):
    """Four sigmoid 1x1-conv heads (reference models.py:324-344) in fp32;
    pm stays packed (B, N)."""
    f_m, f_b = f_m.float(), f_b.float()
    p_m = torch.sigmoid(_linear(loc.conv_layer_pm, f_m))[..., 0] * vmask
    p_s = torch.sigmoid(_linear(loc.conv_layer_ps, f_b))[..., 0] * length_mask
    p_e = torch.sigmoid(_linear(loc.conv_layer_pe, f_b))[..., 0] * length_mask
    p_a = torch.sigmoid(_linear(loc.conv_layer_pa, f_b))[..., 0] * length_mask
    return p_m, p_s, p_e, p_a


# --------------------------------------------------------------------- #
# Serving forward
# --------------------------------------------------------------------- #
def check_serving_config(cfg: ModelConfig) -> None:
    """The serving path implements fp32, the packed layout and both fused
    kernels; every other mode raises instead of taking another path."""
    unsupported = []
    if cfg.compute_dtype != "float32":
        unsupported.append(f"compute_dtype={cfg.compute_dtype}")
    if not cfg.packed:
        unsupported.append("packed=False (dense layout)")
    if cfg.compat_head:
        unsupported.append("compat_head=True")
    if not cfg.fused_smi:
        unsupported.append("fused_smi=False")
    if not cfg.fused_lstm:
        unsupported.append("fused_lstm=False")
    if unsupported:
        raise NotImplementedError(
            "not supported by the PyTorch serving path: " + ", ".join(unsupported))


@torch.no_grad()
def smin_forward_inference(
    model: SMIN,
    cfg: ModelConfig,
    video_features: Optional[torch.Tensor],   # (B, T, dv)
    video_mask: Optional[torch.Tensor],       # (B, T, 1)
    query_features: torch.Tensor,             # (B, Nq, word_dim)
    query_mask: torch.Tensor,                 # (B, Nq, 1)
    length_mask: torch.Tensor,                # (B, L)
    video_group: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Grad-free forward -> (pm (B, N), ps, pe, pa (B, L)), fp32 in [0, 1].
    ``video_group`` is that of `backbone`."""
    # Imported here: ops/smin_cuda.py imports this module for its plain version.
    from video_moment_localization_tpu_torch.ops.smin_cuda import smin_stack_fused

    check_serving_config(cfg)
    f, fs, fw = backbone(model.backbone, cfg, video_features, video_mask,
                         query_features, query_mask, video_group=video_group)
    vmask = packed_valid_mask(length_mask)
    return smin_stack_fused(model, cfg, f, fw, fs, query_mask, length_mask, vmask)


# --------------------------------------------------------------------- #
# Training forward
# --------------------------------------------------------------------- #
def check_training_config(cfg: ModelConfig) -> None:
    """The training path implements fp32, the packed layout and the SMI
    kernels with their own backward; every other mode raises instead of
    taking another path."""
    unsupported = []
    if cfg.compute_dtype != "float32":
        unsupported.append(f"compute_dtype={cfg.compute_dtype}")
    if not cfg.packed:
        unsupported.append("packed=False (dense layout)")
    if cfg.compat_head:
        unsupported.append("compat_head=True")
    if not cfg.fused_smi_train:
        unsupported.append("fused_smi_train=False")
    if cfg.remat_smi:
        unsupported.append("remat_smi=True")
    if unsupported:
        raise NotImplementedError(
            "not supported by the PyTorch training path: " + ", ".join(unsupported))


_WHOLE_LAYER_MAX_ROWS = 4352            # clip rows N * C of one element
_WHOLE_LAYER_BUDGET_BYTES = 90_000_000  # against 34 bytes per fc element and byte


def whole_layer_train_admits(cfg: ModelConfig) -> bool:
    """Which of the two training routes a config takes: True for the
    whole-layer kernels (K1, K2, K3), False for the content-unit kernels
    (K6, K7).

    This is the JAX package's routing, not a limit of the H100: its own copy
    of ``ops/smin_train_pallas.py::supports_train`` with the constants that
    ``ops/limits.py`` resolves to on the TPU the package was tuned on (a row
    cap of its backward kernel and that kernel's working set against its
    budget of fast memory). It is kept so that both packages train a given
    config through the same kernels: Charades passes at fp32; TACoS at fp32
    (N * C = 2112, over the budget) and ActivityNet (N * C = 8320, over the
    row cap) do not."""
    rows = cfg.L * (cfg.L + 1) // 2 * cfg.C
    itemsize = torch.finfo(getattr(torch, cfg.compute_dtype)).bits // 8
    return (rows <= _WHOLE_LAYER_MAX_ROWS
            and 34 * rows * cfg.D * itemsize <= _WHOLE_LAYER_BUDGET_BYTES)


def smin_forward(
    model: SMIN,
    cfg: ModelConfig,
    video_features: torch.Tensor,             # (B, T, dv)
    video_mask: torch.Tensor,                 # (B, T, 1)
    query_features: torch.Tensor,             # (B, Nq, word_dim)
    query_mask: torch.Tensor,                 # (B, Nq, 1)
    length_mask: torch.Tensor,                # (B, L)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Differentiable forward -> (pm (B, N), ps, pe, pa (B, L)), fp32 in
    [0, 1]: plain backbone, then proposal rows (K1) -> SMI layers (K2,
    backward K3) where `whole_layer_train_admits`, else packed proposal (K6)
    -> content-unit layers (K7) with the boundary and moment units in
    PyTorch ops; then the heads."""
    # Imported here: these modules import this one for their plain versions.
    from video_moment_localization_tpu_torch.ops.content_train_cuda import (
        smi_stack_content_train,
    )
    from video_moment_localization_tpu_torch.ops.proposal_cuda import (
        proposal_features_packed_fused,
        proposal_features_rows,
    )
    from video_moment_localization_tpu_torch.ops.smin_train_cuda import smi_stack_layers

    check_training_config(cfg)
    f, fs, fw = backbone(model.backbone, cfg, video_features, video_mask,
                         query_features, query_mask, fused_lstm=False)
    length_mask = length_mask.float()
    vmask = packed_valid_mask(length_mask)
    if whole_layer_train_admits(cfg):
        proposal, stack = proposal_features_rows, smi_stack_layers
    else:
        proposal, stack = proposal_features_packed_fused, smi_stack_content_train
    fc, fm, fb = proposal(f, length_mask, cfg.L, cfg.C)
    fm, fb = stack(model.smis, fc, fm, fb, fw, fs, query_mask, length_mask, vmask, cfg.L)
    return localization_packed(model.localization, fm, fb, length_mask, vmask, cfg.L)

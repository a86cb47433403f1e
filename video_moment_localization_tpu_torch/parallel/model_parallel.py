"""Sequence-parallel SMIN forward and the 2-D (data x seq) train and eval
steps.

Counterpart of ``video_moment_localization_tpu/parallel/model_parallel.py``.
For videos too long for one device, each of the n ranks of a seq group holds
a contiguous T/n clip shard and the part of the proposal map derived from
it; the queries are small and replicated (each rank runs the plain biLSTM
under autograd, as JAX's ``query_encoder(fused=False)`` does). The JAX
sequence-parallel forward runs on XLA alone, and so does this one: it
launches no kernel of the port, only PyTorch ops and the collectives of
`parallel.collectives`, through which autograd runs the adjoints.

* Dense (`smin_forward_seq_sharded`, ``packed: False`` and ``compat_head``):
  rank k holds map rows [k L/n, (k+1) L/n) (`parallel.sequence`); one
  all-gather of the (B, L/n, D) boundary features after the pooling and one
  of the (B, L/n, D) moment->boundary message per SMI layer; pm comes back
  row-sharded (B, L/n, L), ps / pe / pa replicated.
* Packed (`smin_forward_seq_sharded_packed`, the default): the N pairs are
  padded to N_pad = n * ceil(N / n) and split into n equal contiguous chunks
  (map rows would be unbalanced: row i carries L - i pairs); padding pairs
  have start = end = 0, weight 0 and index 0. One reduce-scatter of the
  pooling's partial sums, one all-gather of the boundary features, and per
  SMI layer one all-reduce of the moment->boundary message, which each rank
  row-sums over its chunk with a one-hot contraction (a fixed-order sum, not
  ``index_add_``, whose CUDA atomics add in no fixed order). pm (B, N), the
  padded tail sliced off; ps / pe / pa replicated.

The steps (`make_train_step_2d`, `make_eval_step_2d`): a rank of the grid
(`parallel.mesh.make_grid_2d`) holds its data shard of the global batch and,
of it, its T chunk of the video (`put_batch_2d`). The loss takes the whole
outputs of its data shard: pm all-gathered over the seq group. Gradient
semantics, as the JAX 2-D step's: the loss of a data shard is replicated on
its seq ranks, so each backpropagates 1/seq of it (JAX's ``check_vma=False``
transpose divides the cotangents of unmapped outputs so), over the global
batch's valid count (`parallel.steps`), and the parameter gradients are
summed over the whole world in one flat all-reduce
(`mesh.all_reduce_gradients`). Without the 1/seq the replicated part of the
gradient (query encoder, boundary unit, heads) would come out seq times too
large. An epoch's loss sums and counts are summed over the data group only
(`Trainer`): over the world they would count each sample seq times.

At bf16 the inputs are cast to the compute dtype, the prefix sums stay fp32,
the units run the packed loop's bf16 arithmetic (`models.smin`), and the
collectives carry 16-bit tensors in fp32 (`parallel.collectives`).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from video_moment_localization_tpu_torch.config import ModelConfig
from video_moment_localization_tpu_torch.models.smin import (
    SMIN,
    _boundary_refine,
    _linear,
    check_dtype,
    content_unit,
    content_unit_packed,
    localization,
    localization_packed,
    moment_gate,
    query_encoder,
    video_encoder,
)
from video_moment_localization_tpu_torch.ops.content_matrix import content_segments
from video_moment_localization_tpu_torch.ops.cuda_build import resolve_device
from video_moment_localization_tpu_torch.ops.packing import packed_valid_mask, triu_packing
from video_moment_localization_tpu_torch.parallel import mesh
from video_moment_localization_tpu_torch.parallel.collectives import (
    all_gather,
    all_reduce,
    group_rank,
    group_size,
    reduce_scatter,
)
from video_moment_localization_tpu_torch.parallel.sequence import (
    check_seq_widths,
    partial_clip_sums,
    proposal_features_seq_sharded,
    snippet_means,
)
from video_moment_localization_tpu_torch.parallel.steps import _step_metrics
from video_moment_localization_tpu_torch.train.loss import smin_loss

Batch = Dict[str, torch.Tensor]
Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _backbone_shard(model: SMIN, cfg: ModelConfig, vf_loc, vm_loc, qf, qm, k: int):
    """The backbone on clip shard k: the video encoder with the shard's rows
    of the positional table, the replicated plain biLSTM; (f_loc, fs, fw)."""
    dtype = getattr(torch, cfg.compute_dtype)
    vf_loc, qf = vf_loc.to(dtype), qf.to(dtype)
    t_loc = vf_loc.shape[1]
    fv_loc = video_encoder(model.backbone.videoencoder, vf_loc, vm_loc,
                           frames=slice(k * t_loc, (k + 1) * t_loc))
    fs, fw = query_encoder(model.backbone.queryencoder, qf, qm, cfg.lstm_hidden_size,
                           fused_lstm=False)
    return fv_loc * fs[:, None, :], fs, fw


# --------------------------------------------------------------------- #
# Dense: map rows sharded
# --------------------------------------------------------------------- #
def _boundary_unit_rows(bu, f_b, f_w, f_s, query_mask, length_mask, fbar_rows, k: int,
                        group):
    """The boundary unit (`models.smin.boundary_unit`) with whole boundary
    features and this rank's rows of the gated moment map: its rows of the
    moment->boundary message, summed in fp32 and rounded once, then
    all-gathered."""
    A_b, out = _boundary_refine(bu, f_b, f_w, f_s, query_mask, length_mask)
    rows = fbar_rows.shape[1]
    A_rows = A_b[:, k * rows:(k + 1) * rows]
    f_bm_rows = torch.einsum("bij,bijd->bid", A_rows.float(), fbar_rows.float()).to(f_b.dtype)
    return out + all_gather(f_bm_rows, 1, group)


def _moment_unit_rows(mu, f_c, f_m, f_b_rows, f_b, moment_mask_rows):
    """`models.smin.moment_unit` with the start-boundary axis on this rank's
    rows: the outer product of its boundary rows with all of them."""
    f_m_mask = moment_mask_rows[..., None].to(f_m.dtype)
    outer = f_b_rows[:, :, None, :] * f_b[:, None, :, :]
    conv_fb = _linear(mu.conv_layer_fb, outer) * f_m_mask
    conv_fc = _linear(mu.conv_layer_fc, f_c.mean(dim=3)) * f_m_mask
    return conv_fb + conv_fc + f_m


def smin_forward_seq_sharded(model: SMIN, cfg: ModelConfig, video_features, video_mask,
                             query_features, query_mask, length_mask, moment_mask_rows,
                             group) -> Outputs:
    """The dense forward on this rank of the seq group ``group``: its clip
    shard video_features (B, T/n, dv) and video_mask (B, T/n, 1), its rows of
    the moment mask (B, L/n, L), the queries and length mask whole. Returns
    (pm rows (B, L/n, L), ps, pe, pa (B, L)). Raises ValueError unless n
    divides L and T."""
    n, k = group_size(group), group_rank(group)
    check_seq_widths(n, cfg.L, cfg.T)
    dtype = getattr(torch, cfg.compute_dtype)
    f_loc, fs, fw = _backbone_shard(model, cfg, video_features, video_mask, query_features,
                                    query_mask, k)
    lm = length_mask.float()
    mm_rows = moment_mask_rows.float()
    rows = cfg.L // n
    fc, fm, fb_loc = proposal_features_seq_sharded(f_loc, mm_rows.to(dtype), cfg.L, cfg.C, group)
    fb = all_gather(fb_loc, 1, group)                                  # (B, L, D)
    for block in model.smis:
        fbar_rows = moment_gate(fm, fs)
        cu = content_unit(block.content_unit, fc, fw, fs, fm, query_mask, mm_rows,
                          fbar=fbar_rows)
        bu = _boundary_unit_rows(block.boundary_unit, fb, fw, fs, query_mask, lm, fbar_rows, k,
                                 group)
        mu = _moment_unit_rows(block.moment_unit, cu, fm, bu[:, k * rows:(k + 1) * rows], bu,
                               mm_rows)
        fc, fm, fb = cu, mu, bu
    return localization(model.localization, fm, fb, lm, mm_rows)


# --------------------------------------------------------------------- #
# Packed: pair chunks sharded
# --------------------------------------------------------------------- #
@lru_cache(maxsize=None)
def packed_seq_constants(T: int, L: int, C: int, n: int):
    """The packed pooling geometry padded to n equal pair chunks (JAX
    ``_packed_seq_constants``): (starts, ends) (N_pad * C,), weights
    (N_pad, C), i_idx, j_idx (N_pad,), N, N_pad. Padding pairs have
    start = end = 0 (zero partial sums), weight 0 and index 0."""
    seg = content_segments(T, L, C)
    p = triu_packing(L)
    N = p.N
    N_pad = -(-N // n) * n
    pad = N_pad - N
    starts = seg.starts[p.i_idx, p.j_idx]                              # (N, C)
    sizes = seg.sizes[p.i_idx, p.j_idx]
    weights = seg.weights[p.i_idx, p.j_idx]
    starts, sizes, weights = (np.concatenate([a, np.zeros((pad, C), a.dtype)])
                              for a in (starts, sizes, weights))
    i_idx = np.concatenate([p.i_idx, np.zeros(pad, p.i_idx.dtype)])
    j_idx = np.concatenate([p.j_idx, np.zeros(pad, p.j_idx.dtype)])
    return (starts.reshape(-1), (starts + sizes).reshape(-1), weights, i_idx, j_idx, N, N_pad)


def _onehot(idx: np.ndarray, L: int, device) -> torch.Tensor:
    """(len(idx), L) fp32 one-hot rows of ``idx``."""
    out = np.zeros((len(idx), L), np.float32)
    out[np.arange(len(idx)), idx] = 1.0
    return torch.from_numpy(out).to(device)


def _gather_rows(x: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """(B, L, D) -> (B, n, D) rows picked by a one-hot (n, L): exact, and its
    backward a product, a fixed-order sum (JAX ``gather_rows``)."""
    return torch.einsum("nl,bld->bnd", onehot.to(x.dtype), x)


def pool_packed_chunk(f_loc: torch.Tensor, vmask_loc: torch.Tensor, L: int, C: int, group
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """This rank's pair chunk of the packed proposal features from its clip
    shard f_loc (B, T/n, D) and the chunk's pair validity vmask_loc
    (B, N_pad/n): fc (B, N_pad/n, C, D), fm (B, N_pad/n, D), and fb
    (B, L/n, D) of its own shard (JAX ``_local_pool_packed``)."""
    B, T_loc, D = f_loc.shape
    n, k = group_size(group), group_rank(group)
    starts, ends, weights, _, _, _, N_pad = packed_seq_constants(T_loc * n, L, C, n)
    N_loc = N_pad // n
    part = partial_clip_sums(f_loc, starts, ends, k)                   # (B, N_pad * C, D)
    chunk = reduce_scatter(part.reshape(B, N_pad, C, D), 1, group)      # (B, N_loc, C, D)
    w_loc = torch.from_numpy(weights[k * N_loc:(k + 1) * N_loc]).to(f_loc.device)
    fc = chunk * w_loc[None, ..., None] * vmask_loc[..., None, None]
    fm = fc.mean(dim=2)
    return fc.to(f_loc.dtype), fm.to(f_loc.dtype), snippet_means(f_loc, L // n)


def _boundary_unit_packed_chunk(bu, f_b, f_w, f_s, query_mask, length_mask, fbar_loc, flat_loc,
                                rows_loc, group):
    """`models.smin.boundary_unit_packed` with the moment message from this
    rank's pair chunk: each rank row-sums its pairs' A_b * fbar into (B, L, D)
    with the one-hot of their start rows, in fp32, and an all-reduce over the
    group completes every row, rounded once."""
    A_b, out = _boundary_refine(bu, f_b, f_w, f_s, query_mask, length_mask)
    B, L = A_b.shape[:2]
    msg = (A_b.reshape(B, L * L)[:, flat_loc][..., None] * fbar_loc).float()
    f_bm = all_reduce(torch.einsum("nl,bnd->bld", rows_loc, msg), group)
    return out + f_bm.to(f_b.dtype)


def _moment_unit_packed_chunk(mu, f_c, f_m, f_b, vmask_loc, rows_loc, cols_loc):
    """`models.smin.moment_unit_packed` on this rank's pair chunk."""
    f_m_mask = vmask_loc[..., None].to(f_m.dtype)
    outer = _gather_rows(f_b, rows_loc) * _gather_rows(f_b, cols_loc)  # (B, N_loc, D)
    conv_fb = _linear(mu.conv_layer_fb, outer) * f_m_mask
    conv_fc = _linear(mu.conv_layer_fc, f_c.mean(dim=2)) * f_m_mask
    return conv_fb + conv_fc + f_m


def smin_forward_seq_sharded_packed(model: SMIN, cfg: ModelConfig, video_features, video_mask,
                                    query_features, query_mask, length_mask, group) -> Outputs:
    """The packed forward on this rank of the seq group ``group``: its clip
    shard video_features (B, T/n, dv) and video_mask (B, T/n, 1), the queries
    and length mask whole. Returns (pm (B, N), all-gathered with the padded
    tail sliced off, ps, pe, pa (B, L)), the contract of the single-device
    packed forward. Raises ValueError unless n divides L and T."""
    n, k = group_size(group), group_rank(group)
    check_seq_widths(n, cfg.L, cfg.T)
    L = cfg.L
    _, _, _, i_idx, j_idx, N, N_pad = packed_seq_constants(cfg.T, L, cfg.C, n)
    N_loc = N_pad // n
    own = slice(k * N_loc, (k + 1) * N_loc)
    f_loc, fs, fw = _backbone_shard(model, cfg, video_features, video_mask, query_features,
                                    query_mask, k)
    device = f_loc.device
    lm = length_mask.float()
    vmask = torch.nn.functional.pad(packed_valid_mask(lm), (0, N_pad - N))
    vmask_loc = vmask[:, own]
    flat_loc = torch.from_numpy((i_idx * L + j_idx)[own].astype(np.int64)).to(device)
    rows_loc, cols_loc = _onehot(i_idx[own], L, device), _onehot(j_idx[own], L, device)

    fc, fm, fb_loc = pool_packed_chunk(f_loc, vmask_loc, L, cfg.C, group)
    fb = all_gather(fb_loc, 1, group)                                  # (B, L, D)
    for block in model.smis:
        fbar_loc = moment_gate(fm, fs)
        cu = content_unit_packed(block.content_unit, fc, fw, fs, fm, query_mask, vmask_loc,
                                 fbar=fbar_loc)
        bu = _boundary_unit_packed_chunk(block.boundary_unit, fb, fw, fs, query_mask, lm,
                                         fbar_loc, flat_loc, rows_loc, group)
        mu = _moment_unit_packed_chunk(block.moment_unit, cu, fm, bu, vmask_loc, rows_loc,
                                       cols_loc)
        fc, fm, fb = cu, mu, bu
    pm, ps, pe, pa = localization_packed(model.localization, fm, fb, lm, vmask_loc, L)
    return all_gather(pm, 1, group)[:, :N], ps, pe, pa


# --------------------------------------------------------------------- #
# 2-D (data x seq) steps
# --------------------------------------------------------------------- #
def seq_forward(cfg: ModelConfig, model: SMIN, batch: Batch, group) -> Outputs:
    """The sequence-parallel forward of a batch from `put_batch_2d`, by
    layout (JAX ``_seq_forward``): packed unless ``packed`` is False or
    ``compat_head`` is set, then dense with this rank's rows of the whole
    moment mask and pm all-gathered to (B, L, L)."""
    args = (batch["video_features"], batch["video_mask"], batch["query_features"],
            batch["query_mask"], batch["length_mask"])
    if cfg.packed and not cfg.compat_head:
        return smin_forward_seq_sharded_packed(model, cfg, *args, group)
    rows, k = cfg.L // group_size(group), group_rank(group)
    pm, ps, pe, pa = smin_forward_seq_sharded(
        model, cfg, *args, batch["moment_mask"][:, k * rows:(k + 1) * rows], group)
    return all_gather(pm, 1, group), ps, pe, pa


def make_train_step_2d(cfg: ModelConfig, model: SMIN, optimizer: torch.optim.Optimizer,
                       grid: mesh.Grid2D, device: Union[str, torch.device] = "cuda"
                       ) -> Callable[[Batch], Dict[str, torch.Tensor]]:
    """Returns batch -> metrics for a rank of ``grid``; each call updates
    ``model`` and ``optimizer`` in place (see the module docstring). The
    batch is this rank's from `put_batch_2d`, with ``global_valid`` (the
    global batch's valid samples) when there is more than one data shard.
    "loss" is its data shard's share of the global batch's mean loss,
    "loss_sum" / "num_valid" / "counts" its data shard's. The replicas must
    start equal (`mesh.put_replicated`)."""
    check_dtype(cfg)
    device = resolve_device(device, "make_train_step_2d")     # TF32 off on the card
    model.to(device)
    named = list(model.named_parameters())

    def train_step(batch: Batch) -> Dict[str, torch.Tensor]:
        batch = {k: v.to(device) for k, v in batch.items()}
        denominator = batch.pop("global_valid", None)
        if grid.nd > 1 and denominator is None:
            raise ValueError("a 2-D train step over several data shards needs "
                             "batch['global_valid'], the valid samples of the global batch")
        model.train()
        optimizer.zero_grad(set_to_none=True)
        with torch.enable_grad():
            outputs = seq_forward(cfg, model, batch, grid.seq_group)
            loss, aux = smin_loss(outputs, batch, denominator)
            (loss / grid.seq).backward()
        if grid.world_group is not None:
            mesh.all_reduce_gradients(named, grid.world_group)
        optimizer.step()
        with torch.no_grad():
            outputs = tuple(o.detach() for o in outputs)
            return _step_metrics(outputs, loss.detach(), aux, batch, False, 0.0)

    return train_step


def make_eval_step_2d(cfg: ModelConfig, model: SMIN, grid: mesh.Grid2D, use_nms: bool = False,
                      nms_sigma: float = 0.5, device: Union[str, torch.device] = "cuda"
                      ) -> Callable[[Batch], Dict[str, torch.Tensor]]:
    """Eval counterpart of `make_train_step_2d`: the sequence-parallel
    forward without a graph, the loss and the recall counts of this rank's
    data shard (summed over the data group by the caller)."""
    check_dtype(cfg)
    device = resolve_device(device, "make_eval_step_2d")
    model.to(device)

    @torch.no_grad()
    def eval_step(batch: Batch) -> Dict[str, torch.Tensor]:
        batch = {k: v.to(device) for k, v in batch.items()}
        batch.pop("global_valid", None)
        model.eval()
        outputs = seq_forward(cfg, model, batch, grid.seq_group)
        loss, aux = smin_loss(outputs, batch)
        return _step_metrics(outputs, loss, aux, batch, use_nms, nms_sigma)

    return eval_step


def put_batch_2d(batch: Dict[str, object], grid: mesh.Grid2D, device) -> Batch:
    """This rank's part of its data shard (the NumPy arrays of a
    `BatchLoader(shard_id=grid.data, num_shards=grid.nd)` batch) on its
    device (`mesh.put_batch`): its T chunk of ``video_features`` and
    ``video_mask``; everything else whole, the moment mask too, which the
    loss and the recall counts read whole (the dense forward takes its rows
    of it)."""
    out = dict(batch)
    for key in ("video_features", "video_mask"):
        v = batch[key]
        t_loc = v.shape[1] // grid.seq
        out[key] = np.ascontiguousarray(v[:, grid.seq_index * t_loc:(grid.seq_index + 1) * t_loc])
    return mesh.put_batch(out, device)

"""Analytic FLOP counts of the SMIN forward and train step.

Counterpart of ``video_moment_localization_tpu/utils/flops.py``, with the
same names and counts: matmul FLOPs (2 * M * N * K per product) of every
projection and attention contraction of the model, in the layout the config
selects (packed pairs or the dense L x L map); elementwise work (masks,
gates, softmax normalisation) is left out. ``chip_smoke.py`` divides these
counts by measured device times to report the serving forward's share of a
peak rate (MFU).
"""

from __future__ import annotations

from video_moment_localization_tpu_torch.config import ModelConfig


def _bilstm_flops(cfg: ModelConfig) -> int:
    """The 2-layer biLSTM over Nq steps (models/lstm.py)."""
    H = cfg.lstm_hidden_size
    Nq = cfg.max_query_length
    total = 0
    for in_dim in (cfg.word_dim, 2 * H):               # layer 1 and layer 2 inputs
        per_step = 2 * in_dim * 4 * H + 2 * H * 4 * H  # w_ih + w_hh
        total += 2 * Nq * per_step                     # 2 directions
    return total


def smin_forward_flops(cfg: ModelConfig, batch_size: int) -> int:
    """Matmul FLOPs of one forward pass at the given batch size."""
    T, L, C, D, dl = cfg.T, cfg.L, cfg.C, cfg.D, cfg.dl
    Nq = cfg.max_query_length
    n_pairs = L * (L + 1) // 2 if cfg.packed else L * L
    NC = n_pairs * C

    per_sample = 0
    per_sample += 2 * T * cfg.input_video_dim * D      # video encoder projection
    per_sample += _bilstm_flops(cfg)                   # query encoder
    # Proposal pooling, counted as the product with the averaging matrix of
    # the JAX kernel (the port's prefix sums do almost no multiplications,
    # but write the same rows): an upper bound.
    per_sample += 2 * NC * T * D

    per_layer = 0
    # ContentUnit
    per_layer += 2 * NC * D * dl          # c_hat
    per_layer += 2 * Nq * D * dl          # w_hat
    per_layer += 2 * D * dl               # s_hat
    per_layer += 2 * NC * dl * dl         # attn W_q
    per_layer += 2 * Nq * dl * dl         # attn W_k
    per_layer += 2 * NC * Nq * dl * 2     # word-attention logits + apply
    per_layer += 2 * NC * C * dl * 2      # intra-moment C x C logits + apply
    per_layer += 2 * NC * dl * D          # c_out
    # BoundaryUnit
    per_layer += 2 * L * D * D            # attn W_q on f_b
    per_layer += 2 * Nq * D * D           # attn W_k on f_w
    per_layer += 2 * L * Nq * D * 2       # word-attention logits + apply
    per_layer += 2 * L * L * D * 2        # boundary self-attention logits + f_bb
    per_layer += 2 * L * n_pairs * D      # moment -> boundary row aggregation
    # MomentUnit
    per_layer += 2 * n_pairs * D * D * 2  # conv_fb + conv_fc

    per_sample += cfg.num_smi_layers * per_layer
    per_sample += 2 * n_pairs * D + 3 * 2 * L * D      # localization heads
    return batch_size * per_sample


def smin_train_step_flops(cfg: ModelConfig, batch_size: int) -> int:
    """Matmul FLOPs of one train step (forward + backward + Adam): the
    backward of a product costs twice its forward (dX and dW), Adam is
    elementwise, and ``remat_smi`` adds one more forward."""
    mult = 4 if cfg.remat_smi else 3
    return mult * smin_forward_flops(cfg, batch_size)

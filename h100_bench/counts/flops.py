"""The benchmark's frozen count of the work of SMIN, and the peaks of one H100.

A copy of the port's ``utils/flops.py`` with three corrections, kept here so
that the yardstick does not move when the program changes, and reads the
same work whatever implements it:

* proposal pooling is counted as the work that averaging clips needs (prefix
  sums over T * D, then one difference and one scale for each of the
  N * C * D outputs), not as the dense product with an averaging matrix;
* the moment map is always its upper triangle, N = L (L + 1) / 2 pairs,
  whatever layout the program keeps;
* the moment-to-boundary message is a weighted sum of each pair's row into
  its start boundary, one multiply-add for each of the N * D elements, not
  the dense (L x N) one-hot product.

Products count 2 * M * N * K operations; elementwise work (masks, gates,
softmax normalisation) is left out, so the count is a lower bound of what
any implementation does. Bytes are the least that must cross device memory
once: each input read once, each output and parameter written or read once.
``cfg`` is a configuration file's dict (``h100_bench/configs/*.json``).
"""

from __future__ import annotations

from typing import Dict, Tuple

# Published peaks of one NVIDIA H100 SXM (data sheet, dense, 700 W).
PEAK_FLOPS = {"float32": 495e12,    # TF32 tensor peak: the fastest route for fp32 inputs
              "bfloat16": 989e12}
PEAK_BYTES_PER_S = 3.35e12
PEAK_NAMES = {"float32": "495 TFLOP/s (TF32 tensor peak)", "bfloat16": "989 TFLOP/s (bf16)"}


def sizes(cfg: Dict) -> Dict[str, int]:
    """The shape names of the count from a configuration file's keys."""
    return {"T": cfg["T"], "L": cfg["L"], "C": cfg["C"], "D": cfg["d"], "dl": cfg["dl"],
            "dv": cfg["input_video_dim"], "Nq": cfg["max_query_length"],
            "H": cfg["lstm_hidden_size"], "W": cfg["word_dim"], "layers": cfg["num_smi_layers"]}


def num_pairs(L: int) -> int:
    return L * (L + 1) // 2


def bilstm_flops(cfg: Dict) -> int:
    """The 2-layer biLSTM over Nq steps, one query."""
    s = sizes(cfg)
    H, total = s["H"], 0
    for in_dim in (s["W"], 2 * H):
        per_step = 2 * in_dim * 4 * H + 2 * H * 4 * H
        total += 2 * s["Nq"] * per_step
    return total


def video_encoder_flops(cfg: Dict) -> int:
    s = sizes(cfg)
    return 2 * s["T"] * s["dv"] * s["D"]


def pooling_flops(cfg: Dict) -> int:
    """Prefix sums over T * D, then a difference and a scale per output."""
    s = sizes(cfg)
    return s["T"] * s["D"] + 2 * num_pairs(s["L"]) * s["C"] * s["D"]


def smi_layer_flops(cfg: Dict) -> int:
    s = sizes(cfg)
    L, C, D, dl, Nq = s["L"], s["C"], s["D"], s["dl"], s["Nq"]
    N = num_pairs(L)
    NC = N * C
    f = 0
    # ContentUnit
    f += 2 * NC * D * dl          # c_hat
    f += 2 * Nq * D * dl          # w_hat
    f += 2 * D * dl               # s_hat
    f += 2 * NC * dl * dl         # attention W_q
    f += 2 * Nq * dl * dl         # attention W_k
    f += 2 * NC * Nq * dl * 2     # word-attention logits and apply
    f += 2 * NC * C * dl * 2      # intra-moment C x C logits and apply
    f += 2 * NC * dl * D          # c_out
    # BoundaryUnit
    f += 2 * L * D * D            # attention W_q on f_b
    f += 2 * Nq * D * D           # attention W_k on f_w
    f += 2 * L * Nq * D * 2       # word-attention logits and apply
    f += 2 * L * L * D * 2        # boundary self-attention logits and f_bb
    f += 2 * N * D                # moment -> boundary message: a multiply-add a pair element
    # MomentUnit
    f += 2 * N * D * D * 2        # conv_fb and conv_fc
    return f


def heads_flops(cfg: Dict) -> int:
    s = sizes(cfg)
    return 2 * num_pairs(s["L"]) * s["D"] + 3 * 2 * s["L"] * s["D"]


def forward_flops(cfg: Dict, pairs: int, videos: int | None = None) -> int:
    """One forward over ``pairs`` (video, query) pairs whose videos are
    encoded ``videos`` times (default: once a pair)."""
    videos = pairs if videos is None else videos
    per_pair = (bilstm_flops(cfg) + pooling_flops(cfg)
                + cfg["num_smi_layers"] * smi_layer_flops(cfg) + heads_flops(cfg))
    return pairs * per_pair + videos * video_encoder_flops(cfg)


def train_step_flops(cfg: Dict, samples: int) -> int:
    """Forward and backward (a product's backward costs twice its forward);
    Adam is elementwise."""
    return 3 * forward_flops(cfg, samples)


def param_count(cfg: Dict) -> int:
    s = sizes(cfg)
    D, dl, H = s["D"], s["dl"], s["H"]
    n = s["dv"] * D + D + s["T"] * D                               # video encoder
    for in_dim in (s["W"], 2 * H):                                  # biLSTM, 2 directions
        n += 2 * (4 * H * in_dim + 4 * H * H + 8 * H)
    layer = 3 * (D * dl + dl) + (dl * D + D) + 2 * (dl * dl + dl) + 2 * (D * D + D) \
        + 2 * (D * D + D)
    n += s["layers"] * layer
    n += 4 * (D + 1)                                                # heads
    return n


def serve_bytes(cfg: Dict, pairs: int, videos: int, chunks: int, top_k: int) -> int:
    """Inputs (sampled clip features, masks, word vectors), the top-k out,
    and the parameters read once a chunk, in fp32 / int64."""
    s = sizes(cfg)
    per_video = 4 * (s["T"] * s["dv"] + s["T"] + s["L"])
    per_pair = 4 * (s["Nq"] * s["W"] + s["Nq"]) + 12 * top_k
    return videos * per_video + pairs * per_pair + chunks * 4 * param_count(cfg)


def train_bytes(cfg: Dict, samples: int, steps: int) -> int:
    """Inputs and labels of each sample; per step the parameters, their
    gradients and Adam's two moments read and written (7 passes)."""
    s = sizes(cfg)
    N, L = num_pairs(s["L"]), s["L"]
    per_sample = 4 * (s["T"] * s["dv"] + s["T"] + s["Nq"] * s["W"] + s["Nq"] + 2 * N + 7 * L)
    return samples * per_sample + steps * 7 * 4 * param_count(cfg)


def least_time_s(flops: float, nbytes: float, dtype: str) -> Tuple[float, str]:
    """The least time the chip could take, and which bound sets it."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")

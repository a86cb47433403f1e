"""Plain PyTorch SMIN (Structured Multi-level Interaction Network, CVPR 2021).

The reference the benchmark holds the program to. It follows the published
model as ``ChanukyaVardhan/Video-Moment-Localization`` (models.py) writes
it, over the upper triangle of the moment map in row-major pair order:

* video encoder: masked linear projection plus a learned position table;
* query encoder: a 2-layer bidirectional LSTM over the valid words (the
  backward direction starts at each query's last word, as a packed
  sequence does), fs = [last forward state, backward state at word 0];
* fusion f = fv * fs; proposal features by the dense averaging weights of
  the reference (each pair's C clips of its frames; zero weight for a
  missing clip), the moment mean over the C clips, and the boundary means;
* three kinds of unit per SMI layer (content, boundary, moment) with the
  reference's masking: -1e9 before the word and boundary softmaxes, a
  multiply after the intra-moment clip softmax;
* four sigmoid heads; a pair's score pm * sqrt(ps[i]) * sqrt(pe[j]).

Parameters are a {name: tensor} dict under the reference's state_dict
names (`param_shapes`). Products run as the caller's process sets
``torch.backends.cuda.matmul.allow_tf32``: the benchmark runs the reference
with it off, and its control with it on.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from functools import lru_cache
from typing import Dict, Tuple

import numpy as np
import torch

NEG = -1e9


def param_shapes(cfg: Dict) -> "OrderedDict[str, Tuple[Tuple[int, ...], str, float]]":
    """name -> (shape, init, scale): ``uniform`` in [-scale, scale] (the
    library defaults: 1 / sqrt(fan_in) for linear and 1x1 convolution
    layers, 1 / sqrt(hidden) for the LSTM) or ``normal`` with that std."""
    D, dl, H = cfg["d"], cfg["dl"], cfg["lstm_hidden_size"]
    out: "OrderedDict" = OrderedDict()

    def linear(name, n_in, n_out, conv=0):
        b = 1.0 / math.sqrt(n_in)
        out[f"{name}.weight"] = ((n_out, n_in) + (1,) * conv, "uniform", b)
        out[f"{name}.bias"] = ((n_out,), "uniform", b)

    linear("backbone.videoencoder.ve", cfg["input_video_dim"], D)
    out["backbone.videoencoder.pe.weight"] = ((cfg["T"], D), "normal", 1.0)
    b = 1.0 / math.sqrt(H)
    for k in range(2):
        n_in = cfg["word_dim"] if k == 0 else 2 * H
        for sfx in ("", "_reverse"):
            p = f"backbone.queryencoder.lstm."
            out[f"{p}weight_ih_l{k}{sfx}"] = ((4 * H, n_in), "uniform", b)
            out[f"{p}weight_hh_l{k}{sfx}"] = ((4 * H, H), "uniform", b)
            out[f"{p}bias_ih_l{k}{sfx}"] = ((4 * H,), "uniform", b)
            out[f"{p}bias_hh_l{k}{sfx}"] = ((4 * H,), "uniform", b)
    for n in range(cfg["num_smi_layers"]):
        p = f"smis.{n}."
        for u in ("linear_c_hat", "linear_w_hat", "linear_s_hat"):
            linear(p + "content_unit." + u, D, dl)
        linear(p + "content_unit.linear_c", dl, D)
        linear(p + "content_unit.attn_layer.W_q", dl, dl)
        linear(p + "content_unit.attn_layer.W_k", dl, dl)
        linear(p + "boundary_unit.attn_layer.W_q", D, D)
        linear(p + "boundary_unit.attn_layer.W_k", D, D)
        linear(p + "moment_unit.conv_layer_fb", D, D, conv=2)
        linear(p + "moment_unit.conv_layer_fc", D, D, conv=2)
    linear("localization.conv_layer_pm", D, 1, conv=2)
    for h in ("ps", "pe", "pa"):
        linear(f"localization.conv_layer_{h}", D, 1, conv=1)
    return out


@lru_cache(maxsize=None)
def pairs(L: int) -> Tuple[np.ndarray, np.ndarray]:
    i, j = np.triu_indices(L)
    return i.astype(np.int64), j.astype(np.int64)


@lru_cache(maxsize=None)
def averaging_weights(T: int, L: int, C: int) -> np.ndarray:
    """(N, C, T): pair (i, j) covers frames [i T/L, (j+1) T/L), split into
    C clips of max(1, frames // C) frames; only min(C, frames) clips exist;
    each clip is the mean of its frames (reference models.py:88-98)."""
    tl = T // L
    i_idx, j_idx = pairs(L)
    W = np.zeros((len(i_idx), C, T), np.float32)
    for n, (i, j) in enumerate(zip(i_idx, j_idx)):
        frames = (j - i + 1) * tl
        size = max(1, frames // C)
        for c in range(min(C, frames)):
            start = i * tl + c * size
            W[n, c, start:start + size] = 1.0 / size
    return W


def lin(W, name, x):
    w = W[f"{name}.weight"]
    return x @ w.reshape(w.shape[0], w.shape[1]).t() + W[f"{name}.bias"]


def lstm_direction(x, lengths, p, H, reverse):
    """One direction over (B, S, in); rows past a query's length are zero.
    The backward direction runs each query's valid words in reverse."""
    B, S, _ = x.shape
    t_ar = torch.arange(S, device=x.device)
    valid = (t_ar[None, :] < lengths[:, None])
    if reverse:
        order = torch.where(valid, lengths[:, None] - 1 - t_ar[None, :], t_ar[None, :])
        x = x.gather(1, order[..., None].expand(-1, -1, x.shape[2]))
    xp = x @ p["w_ih"].t() + p["b_ih"] + p["b_hh"]
    h = x.new_zeros(B, H)
    c = x.new_zeros(B, H)
    ys = []
    for t in range(S):
        g = xp[:, t] + h @ p["w_hh"].t()
        i, f, gg, o = g.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        m = valid[:, t:t + 1].to(x.dtype)
        h = m * h_new + (1 - m) * h
        c = m * c_new + (1 - m) * c
        ys.append(h_new * m)
    y = torch.stack(ys, dim=1)
    if reverse:
        y = y.gather(1, order[..., None].expand(-1, -1, H))
    return y


def query_encoder(W, qf, qmask, H):
    lengths = qmask[..., 0].sum(1).long().clamp(min=1)
    x = qf
    for k in range(2):
        dirs = []
        for sfx, rev in (("", False), ("_reverse", True)):
            p = {a: W[f"backbone.queryencoder.lstm.{b}_l{k}{sfx}"]
                 for a, b in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
                              ("b_ih", "bias_ih"), ("b_hh", "bias_hh"))}
            dirs.append(lstm_direction(x, lengths, p, H, rev))
        x = torch.cat(dirs, dim=-1)
    B = x.shape[0]
    fs = torch.cat([x[torch.arange(B, device=x.device), lengths - 1, :H], x[:, 0, H:]], -1)
    return fs, x


def attend(W, name, query, key, value, key_mask, scale_dim):
    """Softmax(W_q q . W_k k / sqrt(d)) over the valid keys, applied to the
    raw value. query (B, ..., d), key / value (B, Nq, .), key_mask (B, Nq)."""
    q = lin(W, f"{name}.W_q", query)
    k = lin(W, f"{name}.W_k", key)
    B = q.shape[0]
    qf = q.reshape(B, -1, q.shape[-1])
    logits = qf @ k.transpose(1, 2) / math.sqrt(scale_dim)
    logits = logits.masked_fill(key_mask[:, None, :] <= 0, NEG)
    out = torch.softmax(logits, -1) @ value
    return out.reshape(*q.shape[:-1], value.shape[-1])


def smi_layer(W, p, fc, fm, fb, fw, fs, qmask, lm, vmask, L):
    """One SMI layer over packed pairs: fc (B, N, C, D), fm (B, N, D), fb
    (B, L, D) -> (fc', fm', fb')."""
    B, N, C, D = fc.shape
    dl = W[p + "content_unit.linear_c_hat.weight"].shape[0]
    i_idx, j_idx = (torch.from_numpy(a).to(fc.device) for a in pairs(L))
    qm = qmask[..., 0]
    fbar = torch.sigmoid(fm * fs[:, None, :]) * fm
    # content unit
    cmask = vmask[:, :, None, None]
    c_hat = lin(W, p + "content_unit.linear_c_hat", fc) * cmask
    w_hat = lin(W, p + "content_unit.linear_w_hat", fw) * qmask
    s_hat = lin(W, p + "content_unit.linear_s_hat", fs)
    f_caq = attend(W, p + "content_unit.attn_layer", c_hat, w_hat, w_hat, qm, dl) * cmask
    f_cq = c_hat * (f_caq + s_hat[:, None, None, :])
    A_c = torch.softmax(f_cq @ f_cq.transpose(-1, -2) / math.sqrt(dl), -1) * cmask
    f_cc = lin(W, p + "content_unit.linear_c", A_c @ c_hat) * cmask
    cu = f_cc + fc + fbar[:, :, None, :]
    # boundary unit
    bmask = lm[..., None]
    f_baq = attend(W, p + "boundary_unit.attn_layer", fb, fw, fw, qm, D) * bmask
    f_bq = fb * (f_baq + fs[:, None, :])
    logits = (f_bq @ f_bq.transpose(1, 2) / math.sqrt(D)).masked_fill(lm[:, None, :] <= 0, NEG)
    A_b = torch.softmax(logits, -1) * bmask
    f_bb = (A_b @ fb) * bmask
    msg = torch.zeros_like(fb).index_add_(1, i_idx, A_b[:, i_idx, j_idx][..., None] * fbar)
    bu = f_bb + fb + msg
    # moment unit
    mmask = vmask[..., None]
    outer = bu[:, i_idx] * bu[:, j_idx]
    mu = (lin(W, p + "moment_unit.conv_layer_fb", outer) * mmask
          + lin(W, p + "moment_unit.conv_layer_fc", cu.mean(2)) * mmask + fm)
    return cu, mu, bu


def forward(W, cfg, vf, vm, qf, qm, lm):
    """(pm (B, N), ps, pe, pa (B, L)) from the model inputs."""
    T, L, C, D = cfg["T"], cfg["L"], cfg["C"], cfg["d"]
    fv = (lin(W, "backbone.videoencoder.ve", vf) + W["backbone.videoencoder.pe.weight"][None]) * vm
    fs, fw = query_encoder(W, qf, qm, cfg["lstm_hidden_size"])
    f = fv * fs[:, None, :]
    Wc = torch.from_numpy(averaging_weights(T, L, C)).to(f.device)
    i_idx, j_idx = (torch.from_numpy(a).to(f.device) for a in pairs(L))
    vmask = lm[:, i_idx] * lm[:, j_idx]
    B = f.shape[0]
    fc = (Wc.reshape(-1, T) @ f).reshape(B, -1, C, D) * vmask[:, :, None, None]
    fm = fc.mean(2)
    fb = f.reshape(B, L, T // L, D).mean(2)
    for n in range(cfg["num_smi_layers"]):
        fc, fm, fb = smi_layer(W, f"smis.{n}.", fc, fm, fb, fw, fs, qm, lm, vmask, L)
    pm = torch.sigmoid(lin(W, "localization.conv_layer_pm", fm))[..., 0] * vmask
    heads = [torch.sigmoid(lin(W, f"localization.conv_layer_{h}", fb))[..., 0] * lm
             for h in ("ps", "pe", "pa")]
    return (pm, *heads)


def scores(pm, ps, pe, lm, L):
    """(B, N) final scores: pm * sqrt(ps[i]) * sqrt(pe[j]) on valid pairs."""
    i_idx, j_idx = (torch.from_numpy(a).to(pm.device) for a in pairs(L))
    return pm * torch.sqrt(ps[:, i_idx]) * torch.sqrt(pe[:, j_idx]) * lm[:, i_idx] * lm[:, j_idx]


def score_requests(W, cfg, inputs: Dict[str, np.ndarray], device, block: int) -> torch.Tensor:
    """(R, N) scores of featurized requests, ``block`` rows at a time."""
    out = []
    keys = ("video_features", "video_mask", "query_features", "query_mask", "length_mask")
    n = inputs["video_features"].shape[0]
    with torch.no_grad():
        for s in range(0, n, block):
            vf, vm, qf, qm, lm = (torch.from_numpy(inputs[k][s:s + block]).to(device) for k in keys)
            pm, ps, pe, _ = forward(W, cfg, vf, vm, qf, qm, lm)
            out.append(scores(pm, ps, pe, lm, cfg["L"]).cpu())
    return torch.cat(out)

"""The frozen count against the port's ``utils/flops.py``: equal once the
pooling product, the message's one-hot product and the dense layout's pairs
are taken back out."""

import json
import os

import pytest

from h100_bench.counts import flops as counts
from h100_bench.reference import smin as ref_smin

from video_moment_localization_tpu_torch.config import ModelConfig
from video_moment_localization_tpu_torch.utils import flops as port_flops

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(name):
    with open(os.path.join(BENCH, "configs", name + ".json")) as fh:
        return json.load(fh)


def model_cfg(cfg, packed=True):
    return ModelConfig(T=cfg["T"], L=cfg["L"], C=cfg["C"], D=cfg["d"], dl=cfg["dl"],
                       num_smi_layers=cfg["num_smi_layers"],
                       input_video_dim=cfg["input_video_dim"],
                       max_query_length=cfg["max_query_length"],
                       lstm_hidden_size=cfg["lstm_hidden_size"], packed=packed)


@pytest.mark.parametrize("name", ["charades", "activitynet"])
@pytest.mark.parametrize("batch", [1, 64, 512])
def test_forward_equals_port_count_with_corrections(name, batch):
    cfg = load(name)
    T, L, C, D = cfg["T"], cfg["L"], cfg["C"], cfg["d"]
    N = L * (L + 1) // 2
    port = port_flops.smin_forward_flops(model_cfg(cfg), batch)
    dense_pool = batch * 2 * N * C * T * D
    ours = counts.forward_flops(cfg, batch) - batch * counts.pooling_flops(cfg)
    assert ours == port - dense_pool - batch * cfg["num_smi_layers"] * one_hot_extra(cfg)


def one_hot_extra(cfg):
    """What the port's count adds for the message over its multiply-adds:
    the dense (L x N) product, 2 L N D, against 2 N D."""
    L, D = cfg["L"], cfg["d"]
    N = L * (L + 1) // 2
    return 2 * L * N * D - 2 * N * D


@pytest.mark.parametrize("name", ["charades", "activitynet"])
def test_message_is_a_multiply_add_a_pair_element(name):
    """The message is N * D multiply-adds a layer, whatever implements it:
    under a tenth of a percent of a layer, where the one-hot product reads
    0.6 % (Charades) to 2.7 % (ActivityNet)."""
    cfg = load(name)
    layer = counts.smi_layer_flops(cfg)
    assert one_hot_extra(cfg) / (layer + one_hot_extra(cfg)) > 0.005
    N = cfg["L"] * (cfg["L"] + 1) // 2
    assert 2 * N * cfg["d"] / layer < 0.001


@pytest.mark.parametrize("name", ["charades", "activitynet"])
def test_pairs_are_the_upper_triangle_in_every_layout(name):
    """The dense layout's count (L * L pairs) is larger; the frozen count
    has one answer, the packed count's."""
    cfg = load(name)
    packed = port_flops.smin_forward_flops(model_cfg(cfg, packed=True), 8)
    dense = port_flops.smin_forward_flops(model_cfg(cfg, packed=False), 8)
    assert dense > packed
    T, L, C, D = cfg["T"], cfg["L"], cfg["C"], cfg["d"]
    N = L * (L + 1) // 2
    assert counts.forward_flops(cfg, 8) - 8 * counts.pooling_flops(cfg) \
        == packed - 8 * 2 * N * C * T * D - 8 * cfg["num_smi_layers"] * one_hot_extra(cfg)


@pytest.mark.parametrize("name", ["charades", "activitynet"])
def test_train_step_is_three_forwards(name):
    cfg = load(name)
    assert counts.train_step_flops(cfg, 63) == 3 * counts.forward_flops(cfg, 63)


@pytest.mark.parametrize("name", ["charades", "activitynet"])
def test_param_count_matches_the_reference_shapes(name):
    import math

    cfg = load(name)
    n = sum(math.prod(shape) for shape, _, _ in ref_smin.param_shapes(cfg).values())
    assert counts.param_count(cfg) == n


def test_grouped_videos_are_encoded_once():
    cfg = load("charades")
    saved = (512 - 128) * counts.video_encoder_flops(cfg)
    assert counts.forward_flops(cfg, 512) - counts.forward_flops(cfg, 512, 128) == saved


def test_peaks_and_least_time():
    assert counts.PEAK_FLOPS["float32"] == 495e12
    assert counts.PEAK_FLOPS["bfloat16"] == 989e12
    assert counts.PEAK_BYTES_PER_S == 3.35e12
    t, bound = counts.least_time_s(495e12, 1.0, "float32")
    assert (t, bound) == (1.0, "operations")
    t, bound = counts.least_time_s(1.0, 3.35e12 * 2, "float32")
    assert (t, bound) == (2.0, "bytes")

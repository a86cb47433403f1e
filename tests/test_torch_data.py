"""The PyTorch port's config, static geometry and host data layer against
the JAX package: every array must be equal, not merely close."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from video_moment_localization_tpu import config as jconfig
from video_moment_localization_tpu.data import glove as jglove
from video_moment_localization_tpu.data import labels as jlabels
from video_moment_localization_tpu.data import sampler as jsampler
from video_moment_localization_tpu.data import tokenizer as jtokenizer
from video_moment_localization_tpu.ops.content_matrix import content_segments as j_content_segments
from video_moment_localization_tpu.ops import packing as jpacking
from video_moment_localization_tpu_torch import config as tconfig
from video_moment_localization_tpu_torch.data import glove as tglove
from video_moment_localization_tpu_torch.data import labels as tlabels
from video_moment_localization_tpu_torch.data import sampler as tsampler
from video_moment_localization_tpu_torch.data import tokenizer as ttokenizer
from video_moment_localization_tpu_torch.ops.content_matrix import content_segments as t_content_segments
from video_moment_localization_tpu_torch.ops import packing as tpacking

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", ["charadessta", "tacos", "activitynet"])
def test_configs_load_field_for_field(name):
    path = os.path.join(REPO, "config", f"{name}.yml")
    want, got = jconfig.load_config(path), tconfig.load_config(path)
    assert dataclasses.asdict(got.model) == dataclasses.asdict(want.model)
    got_rest = {k: v for k, v in dataclasses.asdict(got).items() if k != "model"}
    want_rest = {k: v for k, v in dataclasses.asdict(want).items() if k != "model"}
    assert got_rest == want_rest
    assert tconfig.REQUIRED_KEYS == jconfig.REQUIRED_KEYS


def test_config_errors_match():
    raw = jconfig.load_config(os.path.join(REPO, "config/charadessta.yml")).raw
    with pytest.raises(ValueError, match="Model FOO is not a valid model!"):
        tconfig.config_from_dict(dict(raw, model="FOO"))
    raw.pop("dl")
    with pytest.raises(KeyError, match="dl"):
        tconfig.config_from_dict(raw)
    with pytest.raises(ValueError, match="2\\*lstm_hidden_size"):
        tconfig.ModelConfig(D=512, lstm_hidden_size=128)


@pytest.mark.parametrize("T,L,C", [(64, 16, 4), (16, 8, 4), (128, 64, 4), (8, 8, 4)])
def test_content_segments_equal(T, L, C):
    want, got = j_content_segments(T, L, C), t_content_segments(T, L, C)
    for field in ("starts", "sizes", "weights"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
        assert getattr(got, field).dtype == getattr(want, field).dtype


@pytest.mark.parametrize("L", [1, 8, 16, 64])
def test_triu_packing_and_masks_equal(L):
    want, got = jpacking.triu_packing(L), tpacking.triu_packing(L)
    for field in ("i_idx", "j_idx", "flat_idx", "row_onehot"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    rng = np.random.default_rng(L)
    lm = (np.arange(L)[None, :] < rng.integers(0, L + 1, size=(5, 1))).astype(np.float32)
    np.testing.assert_array_equal(
        tpacking.packed_valid_mask(torch.from_numpy(lm)).numpy(),
        np.asarray(jpacking.packed_valid_mask(lm)))
    x = rng.standard_normal((5, want.N, 3)).astype(np.float32)
    np.testing.assert_array_equal(tpacking.unpack_map(torch.from_numpy(x), L).numpy(),
                                  np.asarray(jpacking.unpack_map(x, L)))


@pytest.mark.parametrize("nfeats", [1, 5, 31, 32, 33, 64, 100])
def test_build_masks_equal(nfeats):
    T, L = 32, 8
    for g, w in zip(tlabels.build_masks(min(nfeats, T), T, L),
                    jlabels.build_masks(min(nfeats, T), T, L)):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


@pytest.mark.parametrize("nfeats", [7, 64, 65, 150, 641])
def test_sample_fixed_length_features_equal(nfeats):
    """Eval sampling (offset 0) for nfeats below, at and above T."""
    T = 64
    feat = np.random.default_rng(nfeats).standard_normal((nfeats, 6)).astype(np.float32)
    for span in ((0.0, 1.0), (0.13, 0.61)):
        got = tsampler.sample_fixed_length_features(feat, T, *span)
        want = jsampler.sample_fixed_length_features(feat, T, *span, train=False)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]


def test_tokenizer_and_embedding_equal():
    queries = ["Person opens the DOOR.", "someone, (quickly) takes a xylophone!",
               "", "a b c d e f g h i j k l m n o p q"]
    words = ["person", "opens", "the", "door", "someone", "takes", "a", "b", "c"]
    temb = tglove.WordEmbedding.synthetic(words, dim=12, seed=3)
    jemb = jglove.WordEmbedding.synthetic(words, dim=12, seed=3)
    np.testing.assert_array_equal(temb.vectors, jemb.vectors)
    for q in queries:
        tokens = ttokenizer.get_tokens(q)
        assert tokens == jtokenizer.get_tokens(q)
        got_ids, got_f = temb.encode(tokens, 13)
        want_ids, want_f = jemb.encode(tokens, 13)
        np.testing.assert_array_equal(got_ids, want_ids)
        np.testing.assert_array_equal(got_f, want_f)
        np.testing.assert_array_equal(temb.query_mask(got_ids), jemb.query_mask(want_ids))


def test_glove_text_file_loads_equal(tmp_path):
    path = tmp_path / "glove.txt"
    path.write_text("door 0.5 -1.25 2.0\nperson 1e-3 0.0 -7.5\n")
    temb = tglove.WordEmbedding.load(str(path))
    jemb = jglove.WordEmbedding.from_npz(str(path) + ".npz")
    np.testing.assert_array_equal(temb.vectors, jemb.vectors)
    assert temb.stoi == jemb.stoi

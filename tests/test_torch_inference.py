"""The port's serving slice against the JAX package: `MomentLocalizer` on
the CPU against JAX `MomentLocalizer` on the same requests and weights
(identical top-k, scores within 1e-5), plain and soft-NMS, grouped and
ungrouped; checkpoints in the reference format; and the scoring helpers."""

import os

import jax
import numpy as np
import pytest
import torch

from video_moment_localization_tpu.config import ModelConfig as JaxModelConfig
from video_moment_localization_tpu.data.glove import WordEmbedding as JaxWordEmbedding
from video_moment_localization_tpu.inference import MomentLocalizer as JaxLocalizer
from video_moment_localization_tpu.models import init_smin_params
from video_moment_localization_tpu.models.port import torch_state_dict_from_params
from video_moment_localization_tpu.ops.nms import soft_nms_topk as jax_soft_nms
from video_moment_localization_tpu.train import metrics as jmetrics
from video_moment_localization_tpu_torch.config import ModelConfig
from video_moment_localization_tpu_torch.data.glove import WordEmbedding
from video_moment_localization_tpu_torch.inference import (
    MomentLocalizer,
    bucket_sizes,
    topk_lowest_index_first,
)
from video_moment_localization_tpu_torch.models.port import state_dict_from_jax_params
from video_moment_localization_tpu_torch.models.smin import SMIN
from video_moment_localization_tpu_torch.ops.nms import soft_nms_topk
from video_moment_localization_tpu_torch.train import metrics as tmetrics
from video_moment_localization_tpu_torch.utils.checkpoint import checkpoint_paths

SHAPE = dict(T=16, L=8, C=4, D=32, dl=8, num_smi_layers=2, input_video_dim=12,
             max_query_length=6, lstm_hidden_size=16)
JCFG, CFG = JaxModelConfig(**SHAPE), ModelConfig(**SHAPE)
WORDS = ["person", "opens", "the", "door", "sits", "down", "a", "cup", "is", "lifted",
         "closes", "laptop", "someone"]
QUERIES = ["person opens the door", "someone sits down", "a cup is lifted",
           "person closes a laptop", "the xylophone", "person person person person person "
           "person person opens"]
SCORE_TOL = 1e-5

TINY_YAML = """
model: "SMIN"
checkpoint_path: "{ckpt}"
resume_training: False
T: 16
L: 8
C: 4
d: 32
input_video_dim: 12
dl: 8
max_query_length: 6
lstm_hidden_size: 16
num_smi_layers: 2
dataset: "charadessta"
data_dir: "data/charades"
batch_size: 4
num_workers: 0
seed: 43
optimizer: "Adam"
lr: 0.001
num_epochs: 1
"""


@pytest.fixture(scope="module")
def shared():
    params = jax.tree.map(np.asarray, init_smin_params(jax.random.PRNGKey(5), JCFG))
    model = SMIN(CFG)
    model.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return params, model


def _requests(seed=0):
    rng = np.random.default_rng(seed)
    vids = [rng.standard_normal((int(n), 12)).astype(np.float32) for n in (5, 16, 40)]
    reqs = [(vids[k % 3], QUERIES[k % len(QUERIES)], 12.0 + k) for k in range(9)]
    reqs += [(rng.standard_normal((int(n), 12)).astype(np.float32), QUERIES[k % 4], 7.5)
             for k, n in enumerate((3, 9, 16, 23, 60))]
    return reqs


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [(m.start, m.end) for m in g] == [(m.start, m.end) for m in w]
        np.testing.assert_allclose([m.score for m in g], [m.score for m in w],
                                   rtol=0, atol=SCORE_TOL)


@pytest.mark.parametrize("use_nms", [False, True])
@pytest.mark.parametrize("serve_batch", [4, 8])
def test_localizer_matches_jax(shared, use_nms, serve_batch):
    params, model = shared
    emb_j = JaxWordEmbedding.synthetic(WORDS, dim=300, seed=1)
    emb_t = WordEmbedding.synthetic(WORDS, dim=300, seed=1)
    jloc = JaxLocalizer(JCFG, params, emb_j, serve_batch=serve_batch, use_nms=use_nms)
    tloc = MomentLocalizer(CFG, model, emb_t, serve_batch=serve_batch, use_nms=use_nms,
                           device="cpu")
    reqs = _requests()
    _assert_same(tloc.localize_batch(reqs, top_k=5), jloc.localize_batch(reqs, top_k=5))
    # a short video has fewer than k valid pairs: zero-score ties, lowest index first
    solo = tloc.localize(reqs[0][0], "the door", 10.0, top_k=12)
    _assert_same([solo], [jloc.localize(reqs[0][0], "the door", 10.0, top_k=12)])


def test_grouped_path_matches_ungrouped_and_jax(shared):
    """2 videos x 4 queries in a bucket of 8: the grouped path (the video
    encoder runs once per unique video) against distinct arrays per row."""
    params, model = shared
    tloc = MomentLocalizer(CFG, model, WordEmbedding.synthetic(WORDS, dim=300, seed=1),
                           serve_batch=8, device="cpu")
    jloc = JaxLocalizer(JCFG, params, JaxWordEmbedding.synthetic(WORDS, dim=300, seed=1),
                        serve_batch=8)
    rng = np.random.default_rng(3)
    vids = [rng.standard_normal((int(n), 12)).astype(np.float32) for n in (17, 41)]
    grouped = [(v, q, 12.0) for v in vids for q in QUERIES[:4]]
    plain = [(v.copy(), q, 12.0) for v, q, _ in grouped]
    keyed = [(v.copy(), q, 12.0, k) for k, v in enumerate(vids) for q in QUERIES[:4]]
    out = tloc.localize_batch(grouped, top_k=4)
    _assert_same(out, tloc.localize_batch(plain, top_k=4))
    _assert_same(out, tloc.localize_batch(keyed, top_k=4))
    _assert_same(out, jloc.localize_batch(grouped, top_k=4))


def test_from_checkpoint_reads_reference_format(tmp_path, shared):
    """A torch.save({epoch, model, optimizer}) file, as the reference and
    scripts/port_checkpoint.py --reverse write it, serves like the JAX
    localizer with the same weights."""
    params, _ = shared
    ckpt_dir = tmp_path / "ckpt"
    ckpt_dir.mkdir()
    cfg_path = tmp_path / "tiny.yml"
    cfg_path.write_text(TINY_YAML.format(ckpt=str(ckpt_dir)))
    glove = tmp_path / "glove.txt"
    emb = JaxWordEmbedding.synthetic(WORDS, dim=300, seed=2)
    glove.write_text("".join(w + " " + " ".join(repr(float(v)) for v in emb.vectors[i]) + "\n"
                             for w, i in emb.stoi.items()))
    sd = {k: torch.from_numpy(np.array(v)) for k, v in
          torch_state_dict_from_params(params, JCFG).items()}
    model_path, _ = checkpoint_paths(str(ckpt_dir), "tiny")
    torch.save({"epoch": 3, "model": sd, "optimizer": {}}, model_path)

    other = tmp_path / "other.yml"     # experiment "other" has no checkpoint
    other.write_text(cfg_path.read_text())
    with pytest.raises(FileNotFoundError, match="No saved model"):
        MomentLocalizer.from_checkpoint(str(other), glove_path=str(glove), device="cpu")
    loc = MomentLocalizer.from_checkpoint(str(cfg_path), glove_path=str(glove),
                                          serve_batch=4, device="cpu")
    assert loc.cfg.D == 32 and loc.bucket_sizes == [1, 2, 4]
    jloc = JaxLocalizer(JCFG, params, JaxWordEmbedding.load(str(glove)), serve_batch=4)
    reqs = _requests(seed=1)[:6]
    _assert_same(loc.localize_batch(reqs, top_k=3), jloc.localize_batch(reqs, top_k=3))


def test_reference_state_dict_loads_strictly(shared):
    """The JAX package's own export (reference key names) loads with
    strict=True, and a missing or extra key is refused."""
    params, model = shared
    sd = {k: torch.from_numpy(np.array(v))
          for k, v in torch_state_dict_from_params(params, JCFG).items()}
    fresh = SMIN(CFG)
    fresh.load_state_dict(sd, strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    assert set(sd) == set(state_dict_from_jax_params(params))
    with pytest.raises(RuntimeError, match="Missing key"):
        SMIN(CFG).load_state_dict({k: v for k, v in sd.items() if "pe.weight" not in k})
    with pytest.raises(RuntimeError, match="Unexpected key"):
        SMIN(CFG).load_state_dict(dict(sd, **{"backbone.extra": torch.zeros(1)}))


def test_scores_nms_and_topk_match_jax():
    rng = np.random.default_rng(7)
    L, B = 8, 5
    N = L * (L + 1) // 2
    pm = rng.uniform(size=(B, N)).astype(np.float32)
    ps, pe = rng.uniform(size=(2, B, L)).astype(np.float32)
    lm = (np.arange(L)[None, :] < np.array([[8], [3], [1], [8], [5]])).astype(np.float32)
    got = tmetrics.proposal_scores_packed(*map(torch.from_numpy, (pm, ps, pe, lm)), L)
    want = np.asarray(jmetrics.proposal_scores_packed(pm, ps, pe, lm, L))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    for k in (1, 5, N):
        gv, gi = soft_nms_topk(got, L, k, 0.5)
        wv, wi = jax_soft_nms(want, L, k, 0.5, packed=True)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=1e-6, atol=1e-7)
        tv, ti = topk_lowest_index_first(got, k)
        jv, ji = jax.lax.top_k(want, k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-7)
    assert tmetrics.metric_names() == jmetrics.metric_names()


def test_bucket_ladder_matches_jax(shared):
    params, _ = shared
    for serve_batch in (1, 5, 16):
        jloc = JaxLocalizer(JCFG, params, JaxWordEmbedding.synthetic(WORDS, dim=300),
                            serve_batch=serve_batch)
        assert bucket_sizes(serve_batch) == jloc.bucket_sizes
    assert checkpoint_paths("ck", "exp") == (os.path.join("ck", "exp_model.ckpt"),
                                             os.path.join("ck", "exp_stats.json"))

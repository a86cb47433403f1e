"""Replicated serving of the PyTorch port (`MomentLocalizer(...,
devices=[...])`, `from_checkpoint(..., num_devices=N)`) on the CPU, against
one device and against the JAX localizer over a 2-device mesh: the same
top-k (scores within 1e-5), plain, soft-NMS and on the dense layout, with
repeated videos; the buckets and the serve_batch rule of the JAX localizer's
mesh; one slice a replica, gathered in order; `AsyncLocalizer` over a
replicated localizer."""

import copy

import jax
import numpy as np
import pytest
import torch

from video_moment_localization_tpu.config import ModelConfig as JaxModelConfig
from video_moment_localization_tpu.data.glove import WordEmbedding as JaxWordEmbedding
from video_moment_localization_tpu.inference import MomentLocalizer as JaxLocalizer
from video_moment_localization_tpu.models import init_smin_params
from video_moment_localization_tpu.parallel.mesh import make_mesh
from video_moment_localization_tpu_torch.config import ModelConfig
from video_moment_localization_tpu_torch.data.glove import WordEmbedding
from video_moment_localization_tpu_torch.inference import (
    AsyncLocalizer,
    MomentLocalizer,
    bucket_sizes,
)
from video_moment_localization_tpu_torch.models.port import state_dict_from_jax_params
from video_moment_localization_tpu_torch.models.smin import SMIN

SHAPE = dict(T=16, L=8, C=4, D=32, dl=8, num_smi_layers=2, input_video_dim=12,
             max_query_length=6, lstm_hidden_size=16)
WORDS = ["person", "opens", "the", "door", "sits", "down", "a", "cup", "is", "lifted"]
QUERIES = ["person opens the door", "someone sits down", "a cup is lifted", "the xylophone"]
SCORE_TOL = 1e-5
MODES = {"packed": {}, "dense": dict(packed=False)}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads for this module's tiny models: the test workers
    share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def params():
    return jax.tree.map(np.asarray, init_smin_params(jax.random.PRNGKey(5),
                                                     JaxModelConfig(**SHAPE)))


def localizers(params, mode, use_nms, serve_batch=4):
    """(one CPU device, two CPU replicas, the JAX localizer over a 2-device
    mesh) on the same weights and GloVe table."""
    cfg = ModelConfig(**SHAPE, **MODES[mode])
    model = SMIN(cfg)
    model.load_state_dict(state_dict_from_jax_params(params), strict=True)
    emb = WordEmbedding.synthetic(WORDS, dim=300, seed=0)
    one = MomentLocalizer(cfg, model, emb, serve_batch=serve_batch, use_nms=use_nms,
                          device="cpu")
    two = MomentLocalizer(cfg, copy.deepcopy(model), emb, serve_batch=serve_batch,
                          use_nms=use_nms, devices=["cpu", "cpu"])
    jemb = JaxWordEmbedding.synthetic(WORDS, dim=300, seed=0)
    assert np.array_equal(jemb.vectors, emb.vectors)
    jloc = JaxLocalizer(JaxModelConfig(**SHAPE, **MODES[mode]), params, jemb,
                        serve_batch=serve_batch, use_nms=use_nms, mesh=make_mesh(2))
    return one, two, jloc


def requests(seed=0, n=11):
    """Requests on three shared videos (the single-device grouped path) and
    on distinct ones, of lengths below and above T."""
    rng = np.random.default_rng(seed)
    vids = [rng.standard_normal((int(k), 12)).astype(np.float32) for k in (5, 16, 40)]
    reqs = [(vids[k % 3], QUERIES[k % len(QUERIES)], 12.0 + k) for k in range(n - 4)]
    return reqs + [(rng.standard_normal((int(k), 12)).astype(np.float32), QUERIES[j % 4], 7.5)
                   for j, k in enumerate((3, 9, 23, 60))]


def assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [(m.start, m.end) for m in g] == [(m.start, m.end) for m in w]
        np.testing.assert_allclose([m.score for m in g], [m.score for m in w], atol=SCORE_TOL)


@pytest.mark.parametrize("use_nms", [False, True])
@pytest.mark.parametrize("mode", list(MODES))
def test_replicas_give_one_devices_top_k(params, mode, use_nms):
    one, two, _ = localizers(params, mode, use_nms)
    reqs = requests()
    assert_same(two.localize_batch(reqs, top_k=3), one.localize_batch(reqs, top_k=3))


def test_replicas_give_the_jax_meshs_top_k(params):
    _, two, jloc = localizers(params, "packed", False)
    reqs = requests()
    assert_same(two.localize_batch(reqs, top_k=3), jloc.localize_batch(reqs, top_k=3))


@pytest.mark.parametrize("serve_batch", [2, 4, 16])
def test_buckets_are_multiples_of_the_replicas_as_the_jax_meshs(params, serve_batch):
    _, two, jloc = localizers(params, "packed", False, serve_batch)
    assert two.bucket_sizes == jloc.bucket_sizes == bucket_sizes(serve_batch, 2)
    assert all(b % 2 == 0 for b in two.bucket_sizes)
    assert bucket_sizes(serve_batch) == bucket_sizes(serve_batch, 1)


def test_serve_batch_must_split_over_the_replicas(params):
    with pytest.raises(ValueError, match=r"serve_batch \(5\) must be a multiple of the mesh "
                                         r"size \(2\)"):
        JaxLocalizer(JaxModelConfig(**SHAPE), params, JaxWordEmbedding.synthetic(WORDS, dim=300),
                     serve_batch=5, mesh=make_mesh(2))
    model = SMIN(ModelConfig(**SHAPE))
    emb = WordEmbedding.synthetic(WORDS, dim=300)
    with pytest.raises(ValueError, match=r"serve_batch \(5\) must be a multiple of the device "
                                         r"count \(2\)"):
        MomentLocalizer(ModelConfig(**SHAPE), model, emb, serve_batch=5, devices=["cpu", "cpu"])


def test_a_chunk_splits_into_one_slice_a_replica_in_order(params):
    one, two, _ = localizers(params, "packed", False, serve_batch=8)
    reqs = requests(seed=3, n=7)   # 7 requests: bucket 8, 4 rows a replica
    chunk, top_k, parts = two.dispatch(reqs, top_k=2)
    assert [tuple(p[0].shape) for p in parts] == [(4, 2), (4, 2)]
    assert all(p[2] is None for p in parts)
    assert_same(two.collect((chunk, top_k, parts)), one.localize_batch(reqs, top_k=2))
    assert two._replicas[0] is two._replicas[1] is two.model   # one copy a device


def test_async_localizer_over_replicas(params):
    one, two, _ = localizers(params, "packed", False)
    reqs = requests(seed=4, n=16)
    with AsyncLocalizer(two, top_k=3, max_wait_ms=1.0, max_in_flight=2) as server:
        futures = [server.submit(*r) for r in reqs]
        answers = [f.result(timeout=60) for f in futures]
    assert server.stats.snapshot()["errors"] == 0
    assert_same(answers, two.localize_batch(reqs, top_k=3))
    assert_same(answers, one.localize_batch(reqs, top_k=3))


def test_from_checkpoint_serves_replicated(tmp_path, params):
    from video_moment_localization_tpu_torch.utils.checkpoint import checkpoint_paths

    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    cfg_path = tmp_path / "tiny.yml"
    cfg_path.write_text("\n".join(
        [f'checkpoint_path: "{ckpt}"', 'model: "SMIN"', 'dataset: "charadessta"',
         'data_dir: "data"', 'optimizer: "Adam"', "resume_training: False", "batch_size: 4",
         "num_workers: 0", "seed: 43", "lr: 0.001", "num_epochs: 1"]
        + [f"{'d' if k == 'D' else k}: {v}" for k, v in SHAPE.items()]))
    torch.save({"epoch": 1, "model": state_dict_from_jax_params(params), "optimizer": {}},
               checkpoint_paths(str(ckpt), "tiny")[0])
    glove = tmp_path / "glove.txt"
    emb = WordEmbedding.synthetic(WORDS, dim=300, seed=0)
    glove.write_text("".join(w + " " + " ".join(repr(float(x)) for x in emb.vectors[i]) + "\n"
                             for w, i in emb.stoi.items()))
    loc = MomentLocalizer.from_checkpoint(str(cfg_path), glove_path=str(glove), serve_batch=4,
                                          device="cpu", num_devices=2)
    assert [str(d) for d in loc.devices] == ["cpu", "cpu"] and loc.bucket_sizes == [2, 4]
    one = MomentLocalizer.from_checkpoint(str(cfg_path), glove_path=str(glove), serve_batch=4,
                                          device="cpu")
    reqs = requests(seed=5)
    assert_same(loc.localize_batch(reqs, top_k=3), one.localize_batch(reqs, top_k=3))
    with pytest.raises(ValueError, match="requested 2 devices, only .* available"):
        MomentLocalizer.from_checkpoint(str(cfg_path), glove_path=str(glove), num_devices=2)

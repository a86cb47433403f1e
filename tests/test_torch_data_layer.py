"""The PyTorch port's data layer (data/sampler.py train path, datasets.py,
pipeline.py, synthetic.py) against the JAX package's, bit for bit: the
training sampler's jitter and indices for the same generator; every batch of
the port's BatchLoader for the same (seed, epoch, index) on the three
synthetic ``write_*_style_dir`` fixtures and the committed real-format
fixture (tests/fixtures/realfmt), with packed and dense labels, shuffle on
and off, 1 and 4 workers, a padded last batch, on the native and the NumPy
path; and the synthetic writers' files byte for byte."""

import filecmp
import os
import subprocess
import sys

import numpy as np
import pytest

from _torch_train_common import load_jax_native
from video_moment_localization_tpu.data import datasets as jds
from video_moment_localization_tpu.data import sampler as jsampler
from video_moment_localization_tpu.data import synthetic as jsyn
from video_moment_localization_tpu.data.glove import WordEmbedding as JWordEmbedding
from video_moment_localization_tpu.data.pipeline import BatchLoader as JBatchLoader
from video_moment_localization_tpu_torch.data import datasets as tds
from video_moment_localization_tpu_torch.data import sampler as tsampler
from video_moment_localization_tpu_torch.data import synthetic as tsyn
from video_moment_localization_tpu_torch.data.glove import WordEmbedding
from video_moment_localization_tpu_torch.data.pipeline import BatchLoader, collate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    load_jax_native()
REALFMT = os.path.join(REPO, "tests", "fixtures", "realfmt")
SMALL = dict(T=16, L=8, max_query_length=6)


# --------------------------------------------------------------------- #
# Sampler, train path
# --------------------------------------------------------------------- #
# nfeats below, at and above T = 16; 24 and 40 make stride - 0.5 integral
# (1.0 and 2.0), the endpoint the reference shrinks by 1.
NFEATS = [1, 5, 15, 16, 17, 24, 31, 40, 57, 100, 333]


@pytest.mark.parametrize("native_on", ["1", "0"])
@pytest.mark.parametrize("nfeats", NFEATS)
def test_train_sampler_equals_jax(nfeats, native_on, monkeypatch):
    monkeypatch.setenv("VML_NATIVE", native_on)
    T = 16
    seen = set()
    for seed in range(40):
        s_n, e_n = 0.1 + 0.01 * seed, 0.95
        got = tsampler.sample_frame_indices(nfeats, T, s_n, e_n, True,
                                            np.random.default_rng(seed))
        want = jsampler.sample_frame_indices(nfeats, T, s_n, e_n, True,
                                             np.random.default_rng(seed))
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
        spos = tsampler.jitter_offset(nfeats, T, np.random.default_rng(seed))
        assert spos == want[0][0]     # the first index is the offset itself
        seen.add(spos)
    stride = max(1.0, nfeats / T)
    high = stride - 0.5 - (1.0 if (stride - 0.5).is_integer() else 0.0)
    assert seen <= set(range(int(high) + 1))
    if nfeats in (24, 40):
        assert max(seen) == int(stride - 1.5)   # the shrunk endpoint


def test_eval_sampler_keeps_the_serving_signature():
    feat = np.arange(10, dtype=np.float32)[:, None]
    out, nfeats, si, ei = tsampler.sample_fixed_length_features(feat, 4, 0.5, 0.9)
    want = jsampler.sample_fixed_length_features(feat, 4, 0.5, 0.9, train=False)
    np.testing.assert_array_equal(out, want[0])
    assert (nfeats, si, ei) == want[1:] == (4, 1, 3)


# --------------------------------------------------------------------- #
# Fixtures: the synthetic writers (JAX writer's files; the port's writers
# are held to them below) and the real-format shard
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def synth_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("layer")
    return {
        "charades": jsyn.write_charades_style_dir(str(root / "charades"), num_videos=6,
                                                  queries_per_video=2),
        "activitynet": jsyn.write_activitynet_style_dir(str(root / "anet")),
        "tacos": jsyn.write_tacos_style_dir(str(root / "tacos")),
    }


CLASSES = {"charades": "CharadesSTA", "activitynet": "ActivityNet", "tacos": "TACoS"}
CASES = [(name, real) for real in (False, True) for name in CLASSES]


def make_pair(name, real, synth_dirs, packed):
    """(port dataset, JAX dataset) of the same files and split, with the
    packed or dense labels."""
    if real:
        root, split, shape = os.path.join(REALFMT, name), "test", {}
        glove = os.path.join(REALFMT, "glove", "glove.6B.300d.txt")
    else:
        root, split, shape = synth_dirs[name], "train", SMALL
        glove = os.path.join(root, "glove", "glove.6B.300d.txt")
    ours = getattr(tds, CLASSES[name])(root, split=split, embedding=WordEmbedding.from_text(
        glove, cache=False), **shape)
    theirs = getattr(jds, CLASSES[name])(root, split=split, embedding=JWordEmbedding.from_text(
        glove, cache=False), **shape)
    ours.packed_labels = theirs.packed_labels = packed
    return ours, theirs


def assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k, v in w.items():
            if isinstance(v, np.ndarray):
                assert g[k].dtype == v.dtype and g[k].shape == v.shape, k
                np.testing.assert_array_equal(g[k], v, err_msg=k)
            else:
                assert g[k] == v, k


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("name,real", CASES)
def test_batches_equal_jax(name, real, packed, shuffle, workers, synth_dirs):
    ours, theirs = make_pair(name, real, synth_dirs, packed)
    B = 2 if real else 3
    kw = dict(shuffle=shuffle, num_workers=workers, seed=43)
    loader, jloader = BatchLoader(ours, B, **kw), JBatchLoader(theirs, B, **kw)
    assert len(loader) == len(jloader)
    for epoch in (1, 2):   # the second epoch runs the preallocated feature buffer
        got, want = list(loader.epoch(epoch)), list(jloader.epoch(epoch))
        assert_batches_equal(got, want)
        assert ("moment_mask" in got[0]) == (not packed)
    if len(ours) % B:
        assert got[-1]["sample_mask"].min() == 0.0   # a padded last batch


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("name,real", CASES)
def test_batches_equal_jax_on_the_numpy_path(name, real, packed, synth_dirs, monkeypatch):
    monkeypatch.setenv("VML_NATIVE", "0")
    ours, theirs = make_pair(name, real, synth_dirs, packed)
    kw = dict(shuffle=True, num_workers=4, seed=7)
    assert_batches_equal(list(BatchLoader(ours, 2, **kw).epoch(3)),
                         list(JBatchLoader(theirs, 2, **kw).epoch(3)))


def test_shards_equal_jax(synth_dirs):
    """Each shard of a global batch, and the dummy batch of an empty shard."""
    ours, theirs = make_pair("charades", False, synth_dirs, True)
    for shard in range(4):
        kw = dict(shuffle=True, num_workers=2, seed=1, shard_id=shard, num_shards=4)
        assert_batches_equal(list(BatchLoader(ours, 8, **kw).epoch(1)),
                             list(JBatchLoader(theirs, 8, **kw).epoch(1)))
    with pytest.raises(ValueError, match="divisible by num_shards"):
        BatchLoader(ours, 6, num_shards=4)


def test_same_batches_whatever_the_workers(synth_dirs):
    ours, _ = make_pair("tacos", False, synth_dirs, True)
    one = list(BatchLoader(ours, 4, shuffle=True, num_workers=1, seed=5).epoch(2))
    many = list(BatchLoader(ours, 4, shuffle=True, num_workers=8, seed=5).epoch(2))
    assert_batches_equal(many, one)
    other = list(BatchLoader(ours, 4, shuffle=True, num_workers=1, seed=5).epoch(3))
    assert not all(np.array_equal(a["video_features"], b["video_features"])
                   for a, b in zip(one, other))


def test_worker_error_reaches_the_consumer_and_the_producer_stops(synth_dirs):
    ours, _ = make_pair("charades", False, synth_dirs, True)

    def broken(index, rng=None, out=None):
        raise RuntimeError(f"bad sample {index}")

    ours.sample_core = ours.sample = broken
    with pytest.raises(RuntimeError, match="bad sample"):
        list(BatchLoader(ours, 3, num_workers=2).epoch(1))


def test_abandoned_epoch_stops_the_producer(synth_dirs):
    """A consumer that stops mid-epoch (a step raised) sets the stop event,
    and the producer thread exits instead of waiting on a full queue."""
    import threading
    import time

    ours, _ = make_pair("charades", False, synth_dirs, True)
    before = set(threading.enumerate())
    it = BatchLoader(ours, 1, num_workers=2, prefetch=1).epoch(1)
    next(it)
    assert set(threading.enumerate()) - before   # the producer and its pool run
    it.close()
    deadline = time.time() + 10
    while set(threading.enumerate()) - before and time.time() < deadline:
        time.sleep(0.05)
    assert not set(threading.enumerate()) - before


def test_collate_pads_with_zeros_and_masks():
    s = {"video_features": np.ones((4, 3), np.float32), "sm": np.ones(6, np.float32),
         "video_id": "v", "times": [0.0, 1.0], "duration": 1.0, "start_index": 0,
         "end_index": 3}
    batch = collate([s, s], 3)
    np.testing.assert_array_equal(batch["sample_mask"], [1, 1, 0])
    assert batch["video_features"].shape == (3, 4, 3) and not batch["video_features"][2].any()
    assert batch["video_id"] == ["v", "v"]


def test_synthetic_dataset_equals_jax():
    kw = dict(num_videos=3, T=16, L=8, max_query_length=6, input_video_dim=12)
    for split in ("train", "test"):
        ours = tsyn.SyntheticDataset(split=split, **kw)
        theirs = jsyn.SyntheticDataset(split=split, **kw)
        assert len(ours) == len(theirs) == 6
        for i in range(len(ours)):
            g = ours.sample(i, np.random.default_rng(i))
            w = theirs.sample(i, np.random.default_rng(i))
            assert_batches_equal([g], [w])


def test_dataset_factory_matches_jax():
    for name in ("charadessta", "activitynet", "tacos"):
        assert tds.get_dataset_class(name).__name__ == jds.get_dataset_class(name).__name__
        assert tds.get_dataset_class(name).DEFAULTS == jds.get_dataset_class(name).DEFAULTS
    assert tds.TENSOR_KEYS == jds.TENSOR_KEYS
    with pytest.raises(ValueError, match="is not a valid dataset"):
        tds.get_dataset_class("kinetics")


def test_charades_path_needs_no_h5py():
    code = ("import sys\n"
            "from video_moment_localization_tpu_torch.data.datasets import CharadesSTA\n"
            "from video_moment_localization_tpu_torch.data.glove import WordEmbedding\n"
            "from video_moment_localization_tpu_torch.data.pipeline import BatchLoader\n"
            f"root = {os.path.join(REALFMT, 'charades')!r}\n"
            f"glove = {os.path.join(REALFMT, 'glove', 'glove.6B.300d.txt')!r}\n"
            "emb = WordEmbedding.from_text(glove, cache=False)\n"
            "ds = CharadesSTA(root, split='test', embedding=emb)\n"
            "n = sum(1 for _ in BatchLoader(ds, 2).epoch(0))\n"
            "print(n, 'h5py' in sys.modules, 'torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         check=True, timeout=300).stdout
    assert out.split() == ["2", "False", "False"]


# --------------------------------------------------------------------- #
# Synthetic writers: byte-identical files
# --------------------------------------------------------------------- #
def assert_same_tree(got, want):
    got_files = sorted(os.path.relpath(os.path.join(d, f), got)
                       for d, _, fs in os.walk(got) for f in fs)
    want_files = sorted(os.path.relpath(os.path.join(d, f), want)
                        for d, _, fs in os.walk(want) for f in fs)
    assert got_files == want_files and got_files
    for rel in want_files:
        assert filecmp.cmp(os.path.join(got, rel), os.path.join(want, rel), shallow=False), rel


@pytest.mark.parametrize("writer,kw", [
    ("write_charades_style_dir", {}),
    ("write_charades_style_dir", dict(input_video_dim=64, signal_strength=2.5,
                                      videos_per_split={"train": 5, "test": 3},
                                      queries_per_video=3, seed=4)),
    ("write_activitynet_style_dir", {}),
    ("write_activitynet_style_dir", dict(num_videos=3, input_video_dim=10, seed=2)),
    ("write_tacos_style_dir", {}),
    ("write_tacos_style_dir", dict(num_videos=2, splits=("train", "test"), seed=9)),
])
def test_writers_byte_identical(writer, kw, tmp_path):
    getattr(tsyn, writer)(str(tmp_path / "port"), **kw)
    getattr(jsyn, writer)(str(tmp_path / "jax"), **kw)
    assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_glove_writer_byte_identical(tmp_path):
    tsyn.write_glove_txt(str(tmp_path / "a" / "g.txt"), dim=7, seed=3)
    jsyn.write_glove_txt(str(tmp_path / "b" / "g.txt"), dim=7, seed=3)
    assert filecmp.cmp(tmp_path / "a" / "g.txt", tmp_path / "b" / "g.txt", shallow=False)

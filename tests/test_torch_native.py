"""The PyTorch port's native host-pipeline binding (data/native.py, its own
copy of csrc/vml_native.cpp) against the JAX package's: every native entry
point returns the same arrays bit for bit, the NumPy paths (VML_NATIVE=0)
equal the JAX NumPy paths bit for bit and the native results within the
JAX test_native.py tolerances, and the port builds its library in its own
_build/ directory and says which path it took."""

import os
import subprocess
import sys

import numpy as np
import pytest

from _torch_train_common import load_jax_native
from video_moment_localization_tpu.data import labels as j_labels
from video_moment_localization_tpu.data import native as jn
from video_moment_localization_tpu_torch.data import native as tn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    load_jax_native()


def spans(seed, n=30):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        duration = float(rng.uniform(2, 300))
        spos = float(rng.uniform(0, duration * 0.8))
        epos = float(rng.uniform(spos + duration * 0.01, duration))
        yield spos, epos, duration


def assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.fixture
def numpy_path(monkeypatch):
    monkeypatch.setenv("VML_NATIVE", "0")


def test_both_packages_run_native():
    assert jn.available() and tn.available()
    assert tn.backend().startswith("native (libvml_native-")
    so = tn.get_lib()._name
    assert os.path.dirname(so) == os.path.join(REPO, "video_moment_localization_tpu_torch",
                                               "_build")


def test_numpy_path_is_reported(numpy_path):
    assert not tn.available()
    assert tn.backend() == "numpy (VML_NATIVE=0)"
    assert tn.assemble_batch_packed([0.0], [1.0], [1.0], [4], 8, 4) is None
    assert tn.sample_indices(10, 8, 0, 0.1, 0.9) is None


def test_source_is_the_jax_packages():
    with open(os.path.join(REPO, "csrc", "vml_native.cpp")) as fh:
        want = fh.read()
    with open(os.path.join(REPO, "video_moment_localization_tpu_torch", "csrc",
                           "vml_native.cpp")) as fh:
        got = fh.read()
    # The copy differs only in its header comment, which names its binding.
    body = lambda s: s[s.index("#include"):]  # noqa: E731
    assert body(got) == body(want)


@pytest.mark.parametrize("L", [8, 16, 32, 64])
@pytest.mark.parametrize("packed", [False, True])
def test_labels_equal_jax_native(L, packed):
    t_fn = tn.generate_labels_packed if packed else tn.generate_labels
    j_fn = jn.generate_labels_packed if packed else jn.generate_labels
    for spos, epos, duration in spans(L):
        assert_same(t_fn(spos, epos, duration, L), j_fn(spos, epos, duration, L))


@pytest.mark.parametrize("L", [8, 16, 64])
@pytest.mark.parametrize("packed", [False, True])
def test_numpy_labels_equal_jax_numpy_and_native(L, packed, monkeypatch):
    t_fn = tn.generate_labels_packed if packed else tn.generate_labels
    j_fn = jn.generate_labels_packed if packed else jn.generate_labels
    for spos, epos, duration in spans(100 + L):
        monkeypatch.setenv("VML_NATIVE", "0")
        got = t_fn(spos, epos, duration, L)
        assert_same(got, j_fn(spos, epos, duration, L))
        monkeypatch.setenv("VML_NATIVE", "1")
        native = t_fn(spos, epos, duration, L)
        for k, (g, n) in enumerate(zip(got, native)):
            if k in (0, 2, 4):   # sm, ss, se: the JAX test_native.py tolerance
                np.testing.assert_allclose(n, g, rtol=1e-6, atol=1e-6)
        # ya is exact; the binary labels equal the thresholds of the numpy scores
        np.testing.assert_array_equal(native[6], got[6])
        want_sm = j_labels.iou_target_map(spos, epos, duration, L)
        if packed:
            want_sm = j_labels.pack_triu(want_sm)
        np.testing.assert_array_equal(native[1], (want_sm > 0.5).astype(np.float32))


@pytest.mark.parametrize("T,L", [(64, 16), (128, 64), (16, 8)])
def test_masks_equal_jax_both_paths(T, L, monkeypatch):
    for native_on in ("1", "0"):
        monkeypatch.setenv("VML_NATIVE", native_on)
        for nfeats in (1, 3, T // 2, T - 1, T, T + 5):
            assert_same(tn.build_masks(nfeats, T, L), jn.build_masks(nfeats, T, L))
            assert_same(tn.build_masks_packed(nfeats, T, L), jn.build_masks_packed(nfeats, T, L))
            assert_same(tn.build_masks(nfeats, T, L), j_labels.build_masks(nfeats, T, L))


@pytest.mark.parametrize("T,L", [(64, 16), (16, 8), (128, 64)])
def test_assemble_batch_packed_equals_jax(T, L):
    rng = np.random.default_rng(T + L)
    B = 7
    s = list(spans(T, B))
    nfeats = rng.integers(1, 3 * T, size=B).astype(np.int32)
    nfeats[-2:] = -1   # padded rows
    args = ([x[0] for x in s], [x[1] for x in s], [x[2] for x in s], nfeats)
    got, want = tn.assemble_batch_packed(*args, T, L), jn.assemble_batch_packed(*args, T, L)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(ValueError, match="differ in length"):
        tn.assemble_batch_packed(args[0][:3], *args[1:], T, L)


def test_sample_indices_equal_jax():
    rng = np.random.default_rng(1)
    for _ in range(200):
        nfeats = int(rng.integers(2, 400))
        T = int(rng.choice([16, 64, 128]))
        stride = 1.0 if nfeats <= T else nfeats / T
        spos = int(rng.integers(0, max(1, int(stride))))
        s_n = float(rng.uniform(0, 0.7))
        e_n = float(rng.uniform(s_n + 0.05, 1.0))
        got = tn.sample_indices(nfeats, T, spos, s_n, e_n)
        want = jn.sample_indices(nfeats, T, spos, s_n, e_n)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[0].dtype == want[0].dtype
        assert got[1:] == want[1:], (nfeats, T, spos)


def test_second_process_loads_the_built_library():
    """A second process loads the library the first built, by its hashed
    name, without building again."""
    code = ("from video_moment_localization_tpu_torch.data import native\n"
            "import os\n"
            "print(native.backend(), os.path.getmtime(native.get_lib()._name))\n")
    first = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                           text=True, check=True, timeout=300).stdout
    second = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                            text=True, check=True, timeout=300).stdout
    assert first == second and first.startswith("native (libvml_native-")

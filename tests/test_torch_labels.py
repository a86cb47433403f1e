"""The port's training-target generators against the JAX package's: the
same arithmetic in numpy, so the arrays are equal bit for bit."""

import numpy as np
import pytest

from video_moment_localization_tpu.data import labels as jlabels
from video_moment_localization_tpu_torch.data import labels as tlabels


def _spans(seed, count=25):
    rng = np.random.default_rng(seed)
    spans = []
    for _ in range(count):
        duration = float(rng.uniform(2.0, 120.0))
        s = float(rng.uniform(0.0, duration))
        e = float(rng.uniform(s, duration))
        spans.append((s, e, duration))
    spans.append((0.0, 0.0, 0.0))           # zero-length union everywhere at i = 0
    spans.append((3.0, 3.0, 10.0))          # zero-length GT span (sigma = 0)
    return spans


@pytest.mark.parametrize("L", [4, 16])
@pytest.mark.parametrize("fn", ["iou_target_map", "boundary_penalties", "snippet_labels"])
def test_label_generators_equal_jax_bit_for_bit(fn, L):
    for s, e, duration in _spans(L):
        with np.errstate(divide="ignore", invalid="ignore"):
            got = getattr(tlabels, fn)(s, e, duration, L)
            want = getattr(jlabels, fn)(s, e, duration, L)
        for g, w in zip(np.atleast_2d(got), np.atleast_2d(want)):
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("L", [1, 5, 16])
def test_pack_triu_equals_jax(L):
    arr = np.random.default_rng(L).standard_normal((L, L)).astype(np.float32)
    got, want = tlabels.pack_triu(arr), jlabels.pack_triu(arr)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (L * (L + 1) // 2,) and got.flags["C_CONTIGUOUS"]

"""The port's packed recall counts against the JAX package's: exactly
equal, with plain top-k (ties to the lower index) and with soft-NMS."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_moment_localization_tpu.train import metrics as jmetrics
from video_moment_localization_tpu_torch.train import metrics as tmetrics

from _torch_train_common import CFG, N, make_batch


def _scores(seed, B):
    rng = np.random.default_rng(seed)
    pm = rng.uniform(size=(B, N)).astype(np.float32)
    ps = rng.uniform(size=(B, CFG.L)).astype(np.float32)
    pe = rng.uniform(size=(B, CFG.L)).astype(np.float32)
    pm[1, : N // 2] = 0.25            # ties: the lower index wins
    return pm, ps, pe


@pytest.mark.parametrize("use_nms", [False, True])
@pytest.mark.parametrize("with_sample_mask", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_recall_counts_packed_equal_jax(use_nms, with_sample_mask, seed):
    B = 6
    batch = make_batch(B=B, seed=seed)
    pm, ps, pe = _scores(seed, B)
    lm = batch["length_mask"]
    pm, ps, pe = pm * 1.0, ps * lm, pe * lm
    sample_mask = batch["sample_mask"] if with_sample_mask else None
    want = jmetrics.recall_counts_packed(
        jnp.asarray(pm), jnp.asarray(ps), jnp.asarray(pe), jnp.asarray(lm),
        jnp.asarray(batch["sm"]), None if sample_mask is None else jnp.asarray(sample_mask),
        use_nms=use_nms)
    t = torch.from_numpy
    got = tmetrics.recall_counts_packed(
        t(pm), t(ps), t(pe), t(lm), t(batch["sm"]),
        None if sample_mask is None else t(sample_mask), use_nms=use_nms)
    assert tuple(got.shape) == (len(tmetrics.METRIC_NS), len(tmetrics.METRIC_MS))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(got.max()) <= B


def test_counts_to_dict_names():
    counts = np.arange(8, dtype=np.float32).reshape(2, 4)
    got = tmetrics.counts_to_dict(torch.from_numpy(counts))
    assert got == jmetrics.counts_to_dict(counts)
    assert list(got) == tmetrics.metric_names()

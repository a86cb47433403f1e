"""The 2-D (data x seq) train and eval steps of the PyTorch port
(parallel/model_parallel.py `make_train_step_2d`, `make_eval_step_2d`,
`put_batch_2d`) on the CPU against the JAX package's ``make_train_step_2d``
/ ``make_eval_step_2d`` on the same (data x seq) mesh of its virtual CPU
devices.

Ranks: gloo processes that `parallel.mesh.spawn` starts (two for the
(1 x 2) grid, four for (2 x 2); rank functions in
tests/_torch_seq_workers.py, no JAX); a rank holds its data shard of each
global batch and its T chunk of it. From the same weights
(`state_dict_from_jax_params`) and seeded NumPy batches, three Adam steps:

* the global losses within rel 2e-4 and the recall counts equal, each step;
* the parameters after the last step within rtol 3e-4 / atol 3e-5 (packed)
  and 5e-4 / 5e-5 (dense, compat), as tests/test_seq_packed.py:97 and
  tests/test_train_2d.py:63 hold the JAX 2-D step to one device;
* the step-1 gradients, summed over the world, at GRAD_TOL (rtol 5e-4 /
  atol 5e-5) against the JAX gradient of the same loss;
* the parameters equal bit for bit across all ranks after every step;
* a global batch whose second data shard is empty;
* the ``compat_head`` route (dense, densified labels) and one bf16 case at
  the JAX bf16 criterion (each step's loss within rtol 2e-2);
* the eval step's loss sum, valid count and counts, summed over the data
  groups, against JAX ``make_eval_step_2d``.
"""

import numpy as np
import pytest
import torch

from _torch_seq_common import (
    COMPAT,
    DENSE,
    LR,
    PACKED,
    PARAM_TOL,
    assert_equal_across_ranks,
    assert_grads,
    batch,
    init,
    jax_2d,
    spawn,
)
from _torch_train_common import GRAD_TOL

BF16 = dict(PACKED, compute_dtype="bfloat16")
# (name, shape, data shards, seq ranks, batches of B=2 a data shard).
CASES = {
    "packed_1x2": (PACKED, 1, 2), "dense_1x2": (DENSE, 1, 2), "compat_1x2": (COMPAT, 1, 2),
    "bf16_1x2": (BF16, 1, 2), "packed_2x2": (PACKED, 2, 2), "dense_2x2": (DENSE, 2, 2),
    "empty_2x2": (PACKED, 2, 2),
}
EVAL = ("packed_1x2", "packed_2x2")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads for these tiny models (each spawned rank takes
    its own share): the test workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def batches_of(name):
    shape, nd, _ = CASES[name]
    B = 2 * nd
    if name.startswith("empty"):
        b = batch(shape, B, seed=30)
        for v in b.values():     # the second data shard all padding, as the loader emits it
            v[2:] = 0
        return [b]
    return [batch(shape, B, seed=20 + k) for k in range(3)]


def case(name):
    shape, nd, seq = CASES[name]
    return dict(kind="train", name=name, seq=seq, model=shape, state=init(shape, 7)[1],
                batches=batches_of(name), lr=LR, eval=name in EVAL)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each case's results on every rank of its world (2 or 4)."""
    out = {}
    for world in (2, 4):
        names = [n for n, (_, nd, seq) in CASES.items() if nd * seq == world]
        results = spawn(tmp_path_factory.mktemp(f"train{world}"), world, [case(n) for n in names])
        out.update({n: [r[n] for r in results] for n in names})
    return out


@pytest.fixture(scope="module")
def jax_runs():
    cache = {}

    def run(name):
        if name not in cache:
            shape, nd, seq = CASES[name]
            cache[name] = jax_2d(shape, init(shape, 7)[0], batches_of(name), nd, seq,
                                 evaluate=name in EVAL)
        return cache[name]
    return run


@pytest.mark.parametrize("name", [n for n in CASES if n != "bf16_1x2"])
def test_steps_match_the_jax_2d_step(ranks, jax_runs, name):
    got, want = ranks[name][0], jax_runs(name)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=2e-4)
    for sums, counts in zip(got["sums"], want["counts"]):
        np.testing.assert_array_equal(sums[2:].numpy().reshape(counts.shape), counts)
    layout = "packed" if CASES[name][0].get("packed", True) and "compat" not in name else "dense"
    for key, p in got["params"][-1].items():
        np.testing.assert_allclose(p.numpy(), want["params"][key].numpy(), **PARAM_TOL[layout],
                                   err_msg=key)


@pytest.mark.parametrize("name", [n for n in CASES if n != "bf16_1x2"])
def test_step1_gradients_match_jax(ranks, jax_runs, name):
    assert_grads(ranks[name][0]["grads"], jax_runs(name)["grads"], GRAD_TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_parameters_equal_across_ranks_after_every_step(ranks, name):
    assert_equal_across_ranks([{name: res} for res in ranks[name]], name)
    for res in ranks[name][1:]:
        assert res["loss"] == ranks[name][0]["loss"]


def test_empty_data_shard_takes_the_global_batch(ranks):
    b = batches_of("empty_2x2")[0]
    assert b["sample_mask"][:2].sum() == 2 and b["sample_mask"][2:].sum() == 0
    sums = ranks["empty_2x2"][0]["sums"][0]
    assert float(sums[1]) == 2.0


def test_bf16_steps_meet_the_jax_bf16_criterion(ranks, jax_runs):
    got, want = ranks["bf16_1x2"][0], jax_runs("bf16_1x2")
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=2e-2)
    assert all(torch.isfinite(p).all() for p in got["params"][-1].values())


@pytest.mark.parametrize("name", EVAL)
def test_eval_step_sums_match_jax(ranks, jax_runs, name):
    loss, counts = jax_runs(name)["eval"]
    b = batches_of(name)[0]
    for res in ranks[name]:
        sums = res["eval"].numpy()
        assert sums[1] == b["sample_mask"].sum()
        np.testing.assert_allclose(sums[0] / sums[1], loss, rtol=1e-5)
        np.testing.assert_array_equal(sums[2:].reshape(counts.shape), counts)

"""Sequence parallelism of the PyTorch port, forward (parallel/sequence.py,
parallel/model_parallel.py) on the CPU against the JAX package's ``seq``
mesh of its virtual CPU devices.

The port's ranks are gloo processes that `parallel.mesh.spawn` starts (rank
functions in tests/_torch_seq_workers.py, no JAX), two in one spawn and four
in another; a rank's seq group is its contiguous ranks of the (data x seq)
grid (`mesh.make_grid_2d`). From the same seeded NumPy inputs and the same
weights (`state_dict_from_jax_params`):

* the row-sharded pooling `proposal_features_seq_sharded` at n = 2 and 4
  (rtol = atol = 2e-5, tests/test_sequence_parallel.py; at bf16 2e-2) and
  the packed pair-chunk pooling against JAX's ``_local_pool_packed`` under
  its ``shard_map`` (padded pairs included);
* the packed forward against ``smin_forward_seq_sharded_packed`` at n = 2
  and 4, and at L=6, T=24 (N=21 pairs padded to 22): rtol 2e-5 / atol 2e-6
  (tests/test_seq_packed.py:62);
* the dense forward against ``smin_forward_seq_sharded`` at n = 2 and 4:
  rtol 1e-4 / atol 1e-5 (tests/test_model_parallel.py:53-56), pm as row
  blocks; a seq group of 3 over L=8 raises the JAX message.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from _torch_seq_common import DENSE, PACKED, batch, configs, init, seq_mesh, spawn
from video_moment_localization_tpu.ops.packing import packed_valid_mask as j_packed_valid_mask
from video_moment_localization_tpu.parallel import model_parallel as jmp
from video_moment_localization_tpu.parallel.sequence import (
    proposal_features_seq_sharded as j_pool,
)

POOL = dict(T=64, L=16, C=4, D=32, B=3)
SHORT = dict(PACKED, T=24, L=6)
FORWARD = {"packed": PACKED, "short": SHORT, "dense": DENSE}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads here, so each spawned rank takes one: the test
    workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def pool_inputs(seed=0):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((POOL["B"], POOL["T"], POOL["D"])).astype(np.float32)
    length = np.ones((POOL["B"], POOL["L"]), np.float32)
    length[1, POOL["L"] // 2:] = 0
    mm = np.triu(np.einsum("bi,bj->bij", length, length)).astype(np.float32)
    return f, length, mm


def padded_vmask(length, n):
    N = POOL["L"] * (POOL["L"] + 1) // 2
    N_pad = -(-N // n) * n
    return np.pad(np.asarray(j_packed_valid_mask(jnp.asarray(length))), ((0, 0), (0, N_pad - N)))


def cases(n, names):
    """The pooling and forward cases at seq width n (``names``: the forward
    shapes of FORWARD to run)."""
    f, length, mm = pool_inputs()
    out = [dict(kind="pool", name="pool", seq=n, f=f, moment_mask=mm, L=POOL["L"], C=POOL["C"]),
           dict(kind="pool_packed", name="pool_packed", seq=n, f=f, L=POOL["L"], C=POOL["C"],
                vmask_padded=padded_vmask(length, n))]
    if n == 2:
        out.append(dict(out[0], name="pool_bf16", dtype="bfloat16"))
    for name in names:
        shape = FORWARD[name]
        out.append(dict(kind="forward_dense" if name == "dense" else "forward_packed",
                        name=name, seq=n, model=shape, state=init(shape, 0)[1],
                        batch=batch(shape, 3, seed=4)))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Rank results of one spawn of two ranks and one of four."""
    two = spawn(tmp_path_factory.mktemp("seq2"), 2, cases(2, ["packed", "short", "dense"]))
    four_cases = cases(4, ["packed", "dense"])
    four_cases.append(dict(kind="bad_width", name="bad_width", ranks=[0, 1, 2], model=DENSE,
                           state=init(DENSE, 0)[1], batch=batch(DENSE, 3, seed=4)))
    four = spawn(tmp_path_factory.mktemp("seq4"), 4, four_cases)
    return {2: two, 4: four}


def gathered(results, name, n, dim=1):
    """The seq group of ranks 0..n-1's outputs, each concatenated along dim."""
    outs = [r[name] for r in results[:n]]
    return [torch.cat([o[i] for o in outs], dim=dim).float().numpy()
            for i in range(len(outs[0]))]


@pytest.mark.parametrize("n", [2, 4])
def test_pooling_matches_jax(ranks, n):
    f, _, mm = pool_inputs()
    want = jax.jit(lambda f_, m_: j_pool(f_, m_, POOL["L"], POOL["C"], seq_mesh(n)))(
        jnp.asarray(f), jnp.asarray(mm))
    for got, ref in zip(gathered(ranks[n], "pool", n), want):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_pooling_bf16_matches_jax(ranks):
    f, _, mm = pool_inputs()
    fb = jnp.asarray(f).astype(jnp.bfloat16)
    want = j_pool(fb, jnp.asarray(mm), POOL["L"], POOL["C"], seq_mesh(2))
    outs = [r["pool_bf16"] for r in ranks[2][:2]]
    assert all(t.dtype == torch.bfloat16 for o in outs for t in o)
    for got, ref in zip(gathered(ranks[2], "pool_bf16", 2), want):
        np.testing.assert_allclose(got, np.asarray(ref, np.float32), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("n", [2, 4])
def test_packed_chunk_pooling_matches_jax(ranks, n):
    f, length, _ = pool_inputs()
    L, C = POOL["L"], POOL["C"]
    starts, ends, weights, _, _, _, N_pad = jmp._packed_seq_constants(POOL["T"], L, C, n)

    def body(f_, vm_, w_):
        return jmp._local_pool_packed(f_, vm_, jnp.asarray(starts), jnp.asarray(ends), w_, L=L,
                                      C=C, n=n, N_pad=N_pad)

    fn = shard_map(body, mesh=seq_mesh(n), in_specs=(P(None, "seq", None), P(None, "seq"),
                                                     P("seq", None)),
                   out_specs=(P(None, "seq", None, None), P(None, "seq", None),
                              P(None, "seq", None)))
    want = jax.jit(fn)(jnp.asarray(f), jnp.asarray(padded_vmask(length, n)),
                       jnp.asarray(weights))
    for got, ref in zip(gathered(ranks[n], "pool_packed", n), want):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=2e-5, atol=2e-5)


def jax_forward(shape, n):
    jcfg = configs(shape)[0]
    params = init(shape, 0)[0]
    b = {k: jnp.asarray(v) for k, v in batch(shape, 3, seed=4).items()}
    args = [b[k] for k in ("video_features", "video_mask", "query_features", "query_mask",
                           "length_mask")]
    if jcfg.packed:
        return jax.jit(lambda p, *a: jmp.smin_forward_seq_sharded_packed(
            p, jcfg, *a, mesh=seq_mesh(n)))(params, *args)
    return jax.jit(lambda p, *a: jmp.smin_forward_seq_sharded(
        p, jcfg, *a, mesh=seq_mesh(n)))(params, *args, b["moment_mask"])


@pytest.mark.parametrize("name,n", [("packed", 2), ("packed", 4), ("short", 2)])
def test_packed_forward_matches_jax(ranks, name, n):
    want = jax_forward(FORWARD[name], n)
    got = [r[name] for r in ranks[n][:n]]
    for r in got[1:]:
        for a, b in zip(r, got[0]):
            assert torch.equal(a, b)         # pm gathered, heads replicated: the same bits
    N = FORWARD[name]["L"] * (FORWARD[name]["L"] + 1) // 2
    assert got[0][0].shape == (3, N)
    for a, c in zip(got[0], want):
        assert a.shape == c.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("n", [2, 4])
def test_dense_forward_matches_jax(ranks, n):
    want = jax_forward(DENSE, n)
    pm = torch.cat([r["dense"][0] for r in ranks[n][:n]], dim=1)
    assert ranks[n][0]["dense"][0].shape == (3, DENSE["L"] // n, DENSE["L"])
    np.testing.assert_allclose(pm.numpy(), np.asarray(want[0]), rtol=1e-4, atol=1e-5)
    for r in ranks[n][:n]:
        for a, c in zip(r["dense"][1:], want[1:]):
            np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-4, atol=1e-5)


def test_bad_width_raises_the_jax_message(ranks):
    msgs = [r.get("bad_width") for r in ranks[4]]
    assert msgs[:3] == ["seq mesh size 3 must divide L (8) and T (32)"] * 3
    assert "bad_width" not in ranks[4][3]
    with pytest.raises(ValueError) as jax_error:
        jmp.smin_forward_seq_sharded(init(DENSE, 0)[0], configs(DENSE)[0], *([None] * 6),
                                     mesh=seq_mesh(3))
    assert str(jax_error.value) == msgs[0]

"""K1's function in the port (its plain version, on the CPU) against the JAX
package's `proposal_features_rows` run in interpret mode: the forward, and
the gradient of a random linear functional of (fc, fm, fb) through the
custom VJP. The JAX kernel emits fc in c-major rows; the port keeps n-major
and `pack_rows` / `unpack_rows` convert. Tolerance: the rows interface's of
tests/test_smin_train_pallas.py (rtol 5e-4, atol 1e-5); the forward is a
short mean, rtol 1e-5 / atol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_moment_localization_tpu.ops.proposal_pallas import (
    proposal_features_rows as j_proposal_rows,
)
from video_moment_localization_tpu.ops.smin_train_pallas import pack_rows as j_pack_rows
from video_moment_localization_tpu_torch.ops import proposal_cuda
from video_moment_localization_tpu_torch.ops.packing import pack_rows, unpack_rows

GEOMETRIES = [dict(T=16, L=8, C=4, D=32), dict(T=16, L=4, C=2, D=16), dict(T=8, L=8, C=4, D=8)]


def _inputs(geo, B, seed):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((B, geo["T"], geo["D"])).astype(np.float32)
    lmask = np.ones((B, geo["L"]), np.float32)
    lmask[1, geo["L"] // 2:] = 0
    lmask[2, 1:] = 0
    N = geo["L"] * (geo["L"] + 1) // 2
    cots = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, N, geo["C"], geo["D"]), (B, N, geo["D"]), (B, geo["L"], geo["D"]))]
    return f, lmask, cots


@pytest.mark.parametrize("geo", GEOMETRIES, ids=lambda g: f"T{g['T']}L{g['L']}C{g['C']}")
def test_proposal_rows_forward_and_grad_match_jax_kernel(geo):
    B = 3
    f, lmask, cots = _inputs(geo, B, seed=geo["L"])
    L, C = geo["L"], geo["C"]
    N = L * (L + 1) // 2
    jcots = [j_pack_rows(jnp.asarray(cots[0])), jnp.asarray(cots[1]), jnp.asarray(cots[2])]

    def jfn(f_):
        out = j_proposal_rows(f_, jnp.asarray(lmask), L, C, True)
        return sum(jnp.sum(o * c) for o, c in zip(out, jcots)), out

    (_, want), dwant = jax.value_and_grad(jfn, has_aux=True)(jnp.asarray(f))

    before = (proposal_cuda.proposal_rows_forward.launches,
              proposal_cuda.proposal_rows_backward.launches)
    ft = torch.from_numpy(f).requires_grad_(True)
    got = proposal_cuda.proposal_features_rows(ft, torch.from_numpy(lmask), L, C)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(got, cots)).backward()
    assert (proposal_cuda.proposal_rows_forward.launches,
            proposal_cuda.proposal_rows_backward.launches) == before   # CPU: plain versions

    assert tuple(got[0].shape) == (B, N, C, geo["D"])
    np.testing.assert_allclose(pack_rows(got[0]).detach().numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[1].detach().numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[2].detach().numpy(), np.asarray(want[2]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(dwant), rtol=5e-4, atol=1e-5)
    assert (got[0][2, 1:] == 0).all()          # pairs past a one-snippet video are masked


def test_pack_unpack_rows_roundtrip_and_order():
    x = torch.arange(2 * 6 * 3 * 2, dtype=torch.float32).reshape(2, 6, 3, 2)
    rows = pack_rows(x)
    assert torch.equal(unpack_rows(rows, 6, 3), x)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(j_pack_rows(jnp.asarray(x.numpy()))))
    assert torch.equal(rows[:, 1 * 6 + 4], x[:, 4, 1])      # row c * N + n


def test_backward_wrapper_equals_autograd_of_plain():
    geo = GEOMETRIES[0]
    f, lmask, cots = _inputs(geo, 3, seed=1)
    t = torch.from_numpy
    df = proposal_cuda.proposal_rows_backward(t(lmask), geo["T"], geo["L"], geo["C"],
                                              *map(t, cots))
    ft = t(f).requires_grad_(True)
    out = proposal_cuda.proposal_features_packed(ft, t(lmask), geo["L"], geo["C"])
    want = torch.autograd.grad(out, ft, [t(c) for c in cots])[0]
    torch.testing.assert_close(df, want, rtol=1e-6, atol=1e-6)


def test_wrappers_reject_other_devices_and_bad_geometry():
    f = torch.zeros(2, 16, 8, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        proposal_cuda.proposal_rows_forward(f, torch.ones(2, 8, device="meta"), 8, 4)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        proposal_cuda.proposal_rows_backward(
            torch.ones(2, 8, device="meta"), 16, 8, 4, torch.zeros(2, 36, 4, 8, device="meta"),
            torch.zeros(2, 36, 8, device="meta"), torch.zeros(2, 8, 8, device="meta"))
    with pytest.raises(ValueError, match="multiple of L"):
        proposal_cuda._check_geometry(10, 4, 2)

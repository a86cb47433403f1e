"""The port's losses against the JAX package's: value and gradient of
`scaled_bce` and `smin_loss` vs jax.value_and_grad. Tolerance: fp32
elementwise math and short sums, rtol 1e-5 / atol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_moment_localization_tpu.train import loss as jloss
from video_moment_localization_tpu_torch.train import loss as tloss

from _torch_train_common import CFG, N, make_batch, to_torch

TOL = dict(rtol=1e-5, atol=1e-6)


def _case(seed, with_s, all_masked_row, clamp):
    rng = np.random.default_rng(seed)
    B, K = 5, 11
    p = rng.uniform(0.02, 0.98, (B, K)).astype(np.float32)
    if clamp:
        p[0, :3] = 0.0      # below the clamp: constant, zero gradient
        p[1, :3] = 1.0
    y = (rng.uniform(size=(B, K)) > 0.5).astype(np.float32)
    s = rng.uniform(size=(B, K)).astype(np.float32) if with_s else None
    mask = (rng.uniform(size=(B, K)) > 0.3).astype(np.float32)
    if all_masked_row:
        mask[2] = 0.0
    return p, y, s, mask


@pytest.mark.parametrize("with_s", [True, False])
@pytest.mark.parametrize("all_masked_row,clamp", [(False, False), (True, False), (False, True)])
def test_scaled_bce_value_and_grad_match_jax(with_s, all_masked_row, clamp):
    p, y, s, mask = _case(3, with_s, all_masked_row, clamp)
    w = np.linspace(0.5, 1.5, p.shape[0]).astype(np.float32)

    def jfn(p_):
        per = jloss.scaled_bce(p_, y, s, mask)
        return (per * w).sum(), per

    (_, want), gwant = jax.value_and_grad(jfn, has_aux=True)(jnp.asarray(p))
    pt = torch.from_numpy(p).requires_grad_(True)
    got = tloss.scaled_bce(pt, torch.from_numpy(y), None if s is None else torch.from_numpy(s),
                           torch.from_numpy(mask))
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(gwant), **TOL)
    assert torch.isfinite(got).all() and torch.isfinite(pt.grad).all()
    if all_masked_row:
        assert float(got[2].detach()) == 0.0


@pytest.mark.parametrize("with_sample_mask", [True, False])
def test_smin_loss_value_and_grad_match_jax(with_sample_mask):
    batch = make_batch(B=4, seed=2)
    if not with_sample_mask:
        del batch["sample_mask"]
    rng = np.random.default_rng(9)
    outs = [rng.uniform(0.01, 0.99, (4, k)).astype(np.float32) for k in (N, CFG.L, CFG.L, CFG.L)]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def jfn(o):
        return jloss.smin_loss(tuple(o), jbatch)

    (want, aux), gwant = jax.value_and_grad(jfn, has_aux=True)([jnp.asarray(o) for o in outs])
    touts = [torch.from_numpy(o).requires_grad_(True) for o in outs]
    got, taux = tloss.smin_loss(tuple(touts), to_torch(batch))
    got.backward()
    np.testing.assert_allclose(float(got), float(want), **TOL)
    np.testing.assert_allclose(taux["per_sample"].detach().numpy(),
                               np.asarray(aux["per_sample"]), **TOL)
    assert float(taux["num_valid"]) == float(aux["num_valid"])
    for t, g in zip(touts, gwant):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **TOL)

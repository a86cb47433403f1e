"""The port's biLSTM (plain `bilstm` and the CPU route of `bilstm_fused`)
against the JAX package's `bilstm` and its Pallas kernel in interpret mode.
Tolerance rtol = atol = 2e-5, that of tests/test_lstm_pallas.py."""

import jax
import numpy as np
import pytest
import torch

from video_moment_localization_tpu.models.lstm import bilstm as jax_bilstm
from video_moment_localization_tpu.models.lstm import init_bilstm_params
from video_moment_localization_tpu.ops import lstm_pallas
from video_moment_localization_tpu_torch.models.lstm import BiLSTMParams, bilstm, lstm_layers
from video_moment_localization_tpu_torch.ops import lstm_cuda

TOL = dict(rtol=2e-5, atol=2e-5)


def _data(B=8, S=13, Din=36, H=128, seed=0):
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, init_bilstm_params(jax.random.PRNGKey(seed), Din, H, 2))
    x = rng.standard_normal((B, S, Din)).astype(np.float32)
    lengths = rng.integers(1, S + 1, size=B)
    lengths[0], lengths[-1] = 1, S            # ragged, including length 1
    mask = (np.arange(S)[None, :] < lengths[:, None]).astype(np.float32)
    layers = [{d: {k: torch.from_numpy(np.array(v)) for k, v in p[d].items()}
               for d in ("fwd", "bwd")} for p in params]
    return x, mask, params, layers


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_bilstm_matches_jax(seed):
    x, mask, params, layers = _data(seed=seed)
    want = np.asarray(jax_bilstm(x, mask, params))
    got = bilstm(torch.from_numpy(x), torch.from_numpy(mask), layers).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_fused_cpu_route_matches_pallas_interpret():
    x, mask, params, layers = _data(seed=2)
    want = np.asarray(lstm_pallas.bilstm_fused(x, mask, params, interpret=True))
    before = lstm_cuda.bilstm_fused.launches
    got = lstm_cuda.bilstm_fused(torch.from_numpy(x), torch.from_numpy(mask), layers).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert np.all(got[mask == 0] == 0.0)
    assert lstm_cuda.bilstm_fused.launches == before   # the CPU route launches nothing


def test_params_container_matches_nn_lstm_names_and_init():
    module = BiLSTMParams(36, 16, 2)
    ref = torch.nn.LSTM(36, 16, num_layers=2, bidirectional=True, batch_first=True)
    assert {k: v.shape for k, v in module.state_dict().items()} == \
           {k: v.shape for k, v in ref.state_dict().items()}
    bound = 1.0 / np.sqrt(16)
    assert all(float(p.detach().abs().max()) <= bound for p in module.parameters())
    layers = lstm_layers(module)
    assert layers[1]["bwd"]["w_ih"] is module.weight_ih_l1_reverse


def test_plain_bilstm_matches_torch_packed_lstm():
    """The masked-carry recurrence equals nn.LSTM on a packed sequence."""
    x, mask, _, _ = _data(B=5, S=7, Din=10, H=16, seed=4)
    ref = torch.nn.LSTM(10, 16, num_layers=2, bidirectional=True, batch_first=True)
    module = BiLSTMParams(10, 16, 2)
    module.load_state_dict(ref.state_dict())
    lengths = torch.from_numpy(mask.sum(1).astype(np.int64))
    packed = torch.nn.utils.rnn.pack_padded_sequence(torch.from_numpy(x), lengths,
                                                     batch_first=True, enforce_sorted=False)
    with torch.no_grad():
        want = torch.nn.utils.rnn.pad_packed_sequence(ref(packed)[0], batch_first=True,
                                                      total_length=7)[0]
        got = bilstm(torch.from_numpy(x), torch.from_numpy(mask), lstm_layers(module))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_fused_rejects_other_devices():
    x, mask, _, layers = _data(B=2, S=3, Din=4, H=32)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        lstm_cuda.bilstm_fused(torch.from_numpy(x).to("meta"),
                               torch.from_numpy(mask).to("meta"), layers)

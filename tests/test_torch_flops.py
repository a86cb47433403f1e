"""The port's FLOP counts against the JAX package's `utils/flops.py`: equal,
as integers, for the three shipped configs x packed / dense x remat_smi x
three batch sizes."""

import dataclasses
import os

import pytest

from video_moment_localization_tpu.config import load_config as jax_load_config
from video_moment_localization_tpu.utils import flops as jflops
from video_moment_localization_tpu_torch.config import load_config
from video_moment_localization_tpu_torch.utils import flops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ("charadessta", "activitynet", "tacos")


@pytest.mark.parametrize("batch", [1, 64, 512])
@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("name", CONFIGS)
def test_flops_equal_jax(name, packed, remat, batch):
    path = os.path.join(REPO, "config", f"{name}.yml")
    jcfg = dataclasses.replace(jax_load_config(path).model, packed=packed, remat_smi=remat)
    tcfg = dataclasses.replace(load_config(path).model, packed=packed, remat_smi=remat)
    fwd = flops.smin_forward_flops(tcfg, batch)
    assert fwd == jflops.smin_forward_flops(jcfg, batch) and fwd > 0
    assert flops.smin_train_step_flops(tcfg, batch) == jflops.smin_train_step_flops(jcfg, batch)
    assert flops._bilstm_flops(tcfg) == jflops._bilstm_flops(jcfg)

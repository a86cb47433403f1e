"""The port's kernel-time report (`utils/profile_serving.py`), on the CPU:
which rows of ``torch.profiler``'s ``key_averages()`` count as device work,
which count as the GEMM's, and the command line of `utils/profile_train.py`
(its kernel modes). The card test of the same on real profiles is in
tests/test_torch_cuda.py."""

import types

import pytest
import torch

from video_moment_localization_tpu_torch.utils import profile_train
from video_moment_localization_tpu_torch.utils.profile_serving import device_rows, is_product

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def _event(key, device_type, us, count=1, **kw):
    return types.SimpleNamespace(key=key, device_type=device_type, count=count,
                                 self_device_time_total=us, **kw)


def test_device_rows_leave_out_user_annotations():
    """A user annotation's span on the device timeline (``Optimizer.step#Adam.step``
    covers every Adam kernel and the gaps between them) is not counted
    beside the kernels it spans; kernels, idle rows and host events are
    told apart as before, and an event without the attribute (an older
    profiler) counts as work."""
    events = [
        _event("Optimizer.step#Adam.step", CUDA, 18_687.0, is_user_annotation=True),
        _event("multi_tensor_apply_kernel", CUDA, 1_294.0, count=4, is_user_annotation=False),
        _event("vml::pool_kernel", CUDA, 250.0, count=3),
        _event("aten::add", CPU, 0.0, is_user_annotation=False),
        _event("cudaLaunchKernel", CUDA, 0.0, is_user_annotation=False),
    ]
    rows = device_rows(events)
    assert rows == [("multi_tensor_apply_kernel", 4, 1.294), ("vml::pool_kernel", 3, 0.25)]


@pytest.mark.parametrize("key,product", [
    ("void vml::gemm_bf16_wg_kernel<true, true, 0>(vml::GemmBf16WgParams)", True),
    ("void vml::gemm_tc_kernel<128, 128, false, true, true>(vml::GemmParams)", True),
    ("vml::reduce_partials_kernel(int, unsigned long, float const*, float*)", True),
    ("void vml::content_attn_bwd_kernel<true, true>(vml::CaArgs)", False),
    ("void vml::dcut_kernel<8, __nv_bfloat16>(int, int, int)", False),
])
def test_split_counts_the_gemm_and_its_reductions_as_products(key, product):
    """The split's "products" are the shared GEMM's kernels and the
    fixed-order reduction of their split-K partials, nothing else."""
    assert is_product(key) is product


@pytest.mark.parametrize("argv,mode", [
    ([], None),
    (["--layer-forward"], "layer_forward"),
    (["--layer-backward", "--compute_dtype", "bfloat16"], "layer_backward"),
    (["--unit-backward"], "unit_backward"),
    (["--unit-backward", "--compute_dtype", "bfloat16", "--batch", "8", "64"], "unit_backward"),
])
def test_profile_train_modes(argv, mode):
    """Each kernel mode of `utils/profile_train.py` alone, at either type and
    several batches; the train step when none is given."""
    args = profile_train.parse_args(argv)
    modes = [m for m in ("layer_forward", "layer_backward", "unit_backward") if getattr(args, m)]
    assert modes == ([mode] if mode else [])
    assert args.compute_dtype in ("float32", "bfloat16") and args.batch


@pytest.mark.parametrize("argv", [["--unit-backward", "--layer-backward"],
                                  ["--layer-forward", "--unit-backward"],
                                  ["--unit-backward", "--compute_dtype", "float16"]])
def test_profile_train_refuses_two_modes_or_another_dtype(argv):
    with pytest.raises(SystemExit):
        profile_train.parse_args(argv)


def test_profile_train_needs_a_card():
    """The CPU has no card: the mode stops before building anything."""
    assert profile_train.main(["--unit-backward", "--compute_dtype", "bfloat16"]) == 1

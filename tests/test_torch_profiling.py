"""The port's kernel-time report (`utils/profile_serving.py`), on the CPU:
which rows of ``torch.profiler``'s ``key_averages()`` count as device work,
how the device's busy time counts kernels on two streams at once, which
count as the GEMM's, which part of K5 a kernel row is and how the
serving forward's K5 inputs are caught, and the command line of
`utils/profile_train.py` (its kernel modes). The card test of the same on real profiles is in
tests/test_torch_cuda.py."""

import types

import pytest
import torch

from video_moment_localization_tpu_torch.models.lstm import BiLSTMParams, lstm_layers
from video_moment_localization_tpu_torch.ops import lstm_cuda
from video_moment_localization_tpu_torch.utils import profile_train
from video_moment_localization_tpu_torch.utils.profile_serving import (
    covered_ms,
    device_intervals,
    device_rows,
    is_product,
    k5_calls,
    k5_part,
)

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


def _span(device_type, start, end, **kw):
    return types.SimpleNamespace(device_type=device_type,
                                 time_range=types.SimpleNamespace(start=start, end=end), **kw)


@pytest.mark.parametrize("intervals,ms", [
    ([], 0.0),
    ([(0.0, 10.0)], 0.01),
    ([(0.0, 10.0), (20.0, 25.0)], 0.015),                # a gap between launches
    ([(0.0, 10.0), (4.0, 12.0)], 0.012),                 # two streams overlap
    ([(5.0, 6.0), (0.0, 10.0), (2.0, 3.0)], 0.01),       # one kernel inside another's span
    ([(0.0, 10.0), (10.0, 14.0), (30.0, 31.0)], 0.015),  # back to back, then alone
])
def test_covered_ms_counts_overlapping_kernels_once(intervals, ms):
    """The busy time is the union of the kernels' intervals: the sum of their
    durations would count twice what two streams run at once."""
    assert covered_ms(intervals) == pytest.approx(ms)


def test_device_intervals_take_device_work_only():
    """Kernels and copies on the device count; host events, empty spans and a
    user annotation's span on the device timeline (which covers the kernels
    inside it and the gaps between them) do not."""
    events = [
        _span(CUDA, 0.0, 10.0, is_user_annotation=False),
        _span(CUDA, 4.0, 12.0),
        _span(CUDA, 0.0, 50.0, is_user_annotation=True),
        _span(CPU, 0.0, 40.0, is_user_annotation=False),
        _span(CUDA, 20.0, 20.0),
    ]
    assert device_intervals(events) == [(0.0, 10.0), (4.0, 12.0)]
    assert covered_ms(device_intervals(events)) == pytest.approx(0.012)


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


@pytest.mark.parametrize("key,part", [
    ("void (anonymous namespace)::lstm_layer_mma_kernel<2>(int, int, int, int, ...)",
     "recurrence"),
    ("void (anonymous namespace)::lstm_layer_kernel<10>(int, int, int, int, int, ...)",
     "recurrence"),
    ("void vml::gemm_bf16_wg_kernel<false, false, 0>(vml::GemmBf16WgParams)", "layer-2 GEMM"),
    ("void vml::gemm_tc_kernel<128, 128, false, false, true>(vml::GemmParams)", "layer-2 GEMM"),
    ("nvjet_tst_128x64_64x6_1x2_h_bz_coopA_NNT", "layer-1 projections"),
    ("void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda",
     "layer-1 projections"),
])
def test_k5_parts(key, part):
    """K5's kernels by part: the recurrence (both layer kernels), the
    layer-2 GEMM (gemm.cuh), the rest (the library's layer-1 products and
    the casts of b_ih)."""
    assert k5_part(key) == part


def test_k5_calls_catch_the_inputs_and_keep_the_counters():
    """The serving forward's `bilstm_fused` inputs are caught while the
    wrapper keeps counting on its own attributes, and the wrapper is put
    back after."""
    torch.manual_seed(0)
    layers = lstm_layers(BiLSTMParams(8, 32, 2))
    x, mask = torch.randn(2, 3, 8), torch.ones(2, 3)
    real = lstm_cuda.bilstm_fused
    before = real.launches
    seen = k5_calls(lambda: lstm_cuda.bilstm_fused(x, mask, layers))
    assert lstm_cuda.bilstm_fused is real and real.launches == before
    assert len(seen) == 1 and seen[0][0] is x and seen[0][1] is mask and seen[0][2] is layers

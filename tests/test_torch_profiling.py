"""The port's kernel-time report (`utils/profile_serving.py`), on the CPU:
which rows of ``torch.profiler``'s ``key_averages()`` count as device work.
The card test of the same on real profiles is in tests/test_torch_cuda.py."""

import types

import torch

from video_moment_localization_tpu_torch.utils.profile_serving import device_rows

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

"""The metric arithmetic: the interval union, idle gaps, the shares of a
peak or roofline, and which union of device work each metric reads."""

import pytest

from h100_bench.counts import flops as counts
from h100_bench.lib import readers
from h100_bench.lib.harness import Record
from h100_bench.lib.trace import Tracer, idle_gaps, is_copy, span_at, union_length


@pytest.mark.parametrize("intervals,covered", [
    ([], 0.0),
    ([(0, 1)], 1.0),
    ([(0, 1), (2, 3)], 2.0),
    ([(0, 2), (1, 3)], 3.0),                 # overlap counts once (two streams)
    ([(0, 4), (1, 2), (3, 3.5)], 4.0),       # nested
    ([(5, 6), (0, 1), (0.5, 5.5)], 6.0),     # unsorted
])
def test_union_length(intervals, covered):
    assert union_length(intervals) == pytest.approx(covered)


def test_idle_gaps_and_their_spans():
    busy = [(1, 2), (1.5, 3), (5, 6)]
    assert idle_gaps(busy, 0, 8) == [(0, 1), (3, 5), (6, 8)]
    spans = [("window", 0, 8), ("dispatch", 2.5, 4.5), ("collect", 4.5, 6)]
    assert [span_at(spans, (a + b) / 2) for a, b in idle_gaps(busy, 0, 8)] == \
        ["window", "dispatch", "window"]


def record(**kw):
    base = dict(e2e={}, attempted=1, failed=0, units=100, flops=495e12, nbytes=1.0, steps=4,
                window_s=10.0, busy_s=5.0, kernel_s=4.0, dtype="float32")
    base.update(kw)
    return Record(**base)


def test_mfu_and_roofline_shares():
    r = record()
    assert readers.mfu(r) == pytest.approx(10.0)              # 1 s of peak in 10 s
    assert readers.kernel_roofline(r) == pytest.approx(25.0)  # 1 s of least time in 4 of kernels
    assert readers.device_idle(r) == pytest.approx(50.0)      # 5 s of all device work in 10
    assert readers.device_ms_per_step(r) == pytest.approx(1000.0)
    bytes_bound = record(flops=0.0, nbytes=3.35e12 * 2)
    assert readers.kernel_roofline(bytes_bound) == pytest.approx(50.0)
    bf16 = record(dtype="bfloat16", flops=989e12)
    assert readers.mfu(bf16) == pytest.approx(10.0)


def test_readers_return_nothing_without_a_trace():
    r = record(busy_s=None, kernel_s=None)
    assert readers.kernel_roofline(r) is None
    assert readers.device_idle(r) is None
    assert readers.device_ms_per_step(r) is None
    assert readers.mfu(record(units=0)) is None
    assert readers.span_ms_per_call(r, "dispatch") is None


def test_span_ms_per_call():
    r = record(spans=[("dispatch", 0.0, 0.010), ("collect", 0.0, 1.0), ("dispatch", 1.0, 1.030)])
    assert readers.span_ms_per_call(r, "dispatch") == pytest.approx(20.0)


def test_roofline_is_at_most_the_whole_chip():
    """A device that ran exactly the count's work at the peak reads 100 %."""
    cfg = {"T": 8, "L": 4, "C": 2, "d": 32, "dl": 16, "input_video_dim": 24,
           "max_query_length": 6, "lstm_hidden_size": 16, "word_dim": 300, "num_smi_layers": 2}
    f = counts.forward_flops(cfg, 64)
    r = record(flops=f, nbytes=0.0, kernel_s=f / counts.PEAK_FLOPS["float32"])
    assert readers.kernel_roofline(r) == pytest.approx(100.0)


class Event:
    """A profiler event as ``Tracer._read`` sees it (times in ns)."""

    def __init__(self, name, start, dur, device, annotation=False):
        self._name, self._start, self._dur = name, start, dur
        self._device, self._annotation = device, annotation

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def device_type(self):
        return self._device

    def is_user_annotation(self):
        return self._annotation


def test_copies_count_as_busy_and_not_as_kernel_time():
    """The idle share reads every work on the device; the roofline and the
    step's device time read the kernel launches alone, so a change in how
    the host stages its copies moves neither."""
    import types

    import torch

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    s = 10 ** 9
    events = [Event("bench/window", 0, 10 * s, cpu),
              Event("bench/dispatch", 0, 2 * s, cpu),
              Event("Memcpy HtoD (Pinned -> Device)", 1 * s, 2 * s, cuda),
              Event("gemm_tc_kernel", 2 * s, 2 * s, cuda),
              Event("Memset (Device)", 6 * s, s // 2, cuda),
              Event("bench/step", 2 * s, 3 * s, cuda, annotation=True),
              Event("pair_fwd_kernel", 8 * s, s, cuda)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    tracer = Tracer(device=True)
    tracer._read(prof)
    assert tracer.busy_s() == pytest.approx(4.5)     # [1, 4] + [6, 6.5] + [8, 9]
    assert tracer.kernel_s() == pytest.approx(3.0)   # [2, 4] + [8, 9]
    gaps = tracer.breakdown()["idle_gaps"]
    assert [g[0] for g in gaps][:2] == ["window", "window"]
    assert sum(g[1] for g in gaps) == pytest.approx(10 - 4.5)
    r = record(busy_s=tracer.busy_s(), kernel_s=tracer.kernel_s(), flops=0.75 * 495e12,
               nbytes=0.0)
    assert readers.device_idle(r) == pytest.approx(55.0)
    assert readers.kernel_roofline(r) == pytest.approx(25.0)
    assert readers.device_ms_per_step(r) == pytest.approx(750.0)


@pytest.mark.parametrize("name,copy", [
    ("Memcpy HtoD (Pinned -> Device)", True),
    ("Memcpy DtoH (Device -> Pageable)", True),
    ("Memcpy DtoD (Device -> Device)", True),
    ("Memset (Device)", True),
    ("gemm_tc_kernel", False),
    ("void at::native::vectorized_elementwise_kernel<4>", False),
])
def test_is_copy(name, copy):
    assert is_copy(name) is copy

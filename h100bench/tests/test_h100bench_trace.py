"""The profile's arithmetic on synthetic events: busy time is a union, a
gap is named by the host's last operation before it."""

import pytest
from torch.autograd import DeviceType

from h100bench import trace


class Event:
    def __init__(self, name, device, start, end):
        self._n, self._d, self._s, self._e = name, device, start, end

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e


def test_union_and_gaps():
    ms = 1_000_000
    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    events = [Event("kernel_a", cuda, 0, 4 * ms),
              Event("kernel_b", cuda, 2 * ms, 5 * ms),  # overlaps a
              Event("kernel_a", cuda, 9 * ms, 10 * ms),
              Event("aten::_local_scalar_dense", cpu, 4 * ms, 6 * ms),
              Event("cudaMemcpyAsync", cpu, 4 * ms + 10, 5 * ms),
              Event("aten::add", cpu, 8 * ms, 9 * ms)]
    p = trace.summarize(events, 0.012)
    assert p.busy_s == pytest.approx(6e-3)  # [0, 5] and [9, 10]
    assert p.window_s == 0.012
    assert p.device_ops[0] == ["kernel_a", pytest.approx(5e-3)]
    assert p.idle_gaps == [["after aten::_local_scalar_dense",
                            pytest.approx(4e-3)]]


def test_nothing_on_the_card():
    assert trace.summarize([Event("aten::add", DeviceType.CPU, 0, 1)],
                           1.0) is None

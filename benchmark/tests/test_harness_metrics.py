"""The trace reduction and each per-layer metric reader on a synthetic trace."""

import pytest
import torch

from benchmark import counts, spec, trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Event:
    def __init__(self, name, kind, start, dur, corr=0, linked=0, device=CPU):
        self._v = (name, kind, start, dur, corr, linked, device)

    def name(self):
        return self._v[0]

    def activity_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def device_type(self):
        return self._v[6]


class Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type("K", (), {
            "events": lambda _self: events})()})()


def synthetic():
    """Host: frontend [0, 100) us, decoder [100, 1000) us. Device: one
    frontend kernel of 20 us, four decoder kernels of 50 us, one copy of
    10 us launched from the decoder, and a kernel with no launch record."""
    us = 1000
    ev = [Event("frontend", "user_annotation", 0, 100 * us),
          Event("decoder", "user_annotation", 100 * us, 900 * us),
          Event("cudaLaunchKernel", "cuda_runtime", 10 * us, 5 * us, corr=1),
          Event("mfcc", "kernel", 30 * us, 20 * us, corr=1, device=CUDA),
          Event("aten::item", "cpu_op", 800 * us, 190 * us)]
    for i in range(4):
        t = (150 + 150 * i) * us
        ev.append(Event("cudaLaunchKernel", "cuda_runtime", t, 5 * us, corr=10 + i))
        ev.append(Event(f"step{i % 2}", "kernel", t + 20 * us, 50 * us, corr=10 + i, device=CUDA))
    ev.append(Event("cudaMemcpyAsync", "cuda_runtime", 760 * us, 5 * us, corr=20))
    ev.append(Event("Memcpy DtoH", "gpu_memcpy", 780 * us, 10 * us, corr=20, device=CUDA))
    ev.append(Event("decoder", "gpu_user_annotation", 100 * us, 899 * us, device=CUDA))
    ev.append(Event("orphan", "kernel", 900 * us, 1 * us, corr=99, device=CUDA))
    return Prof(ev)


def test_summary_attributes_device_time_to_the_launching_span():
    s = trace.summarize(synthetic(), ("frontend", "decoder"))
    assert s.spans["frontend"].device_s == pytest.approx(20e-6)
    assert s.spans["frontend"].kernels == 1
    assert s.spans["decoder"].device_s == pytest.approx(210e-6)
    assert s.spans["decoder"].kernels == 4  # the copy is not a launch
    assert s.unmatched == 1
    assert s.window_s == pytest.approx(1000e-6)
    assert s.busy_s == pytest.approx(20e-6 + 200e-6 + 10e-6 + 1e-6)
    assert dict(s.device_ops)["step0"] == pytest.approx(100e-6)
    gaps = dict(s.idle_gaps)
    assert sum(gaps.values()) == pytest.approx(s.window_s - s.busy_s)
    assert gaps["decoder:aten::item"] > 0


def test_readers():
    s = trace.summarize(synthetic(), ("frontend", "decoder", "scorer"))
    inputs = {"summary": s, "steps": {"decoder": 2},
              "work": {"frontend": counts.Work({}, 3.35e12 * 10e-6)},
              "window": {"decode": (counts.Work({"bf16": 989e12 * 0.5}), 2.0)}}
    assert spec.reader("frontend_roofline")(inputs) == pytest.approx(50.0)
    assert spec.reader("scorer_roofline")(inputs) is None  # no work and no device time
    assert spec.reader("decoder.launches_per_step")(inputs) == pytest.approx(2.0)
    assert spec.reader("mfu.decode")(inputs) == pytest.approx(25.0)
    assert spec.reader("device_idle.decode")(inputs) == pytest.approx(100 * (1 - 231e-6 / 1e-3))
    assert spec.reader("mfu.train")(inputs) is None
    assert spec.reader("device_idle.train")(inputs) is None


def test_every_per_layer_metric_has_a_reader():
    for m in spec.benchmark()["per_layer"]:
        assert callable(spec.reader(m["name"]))

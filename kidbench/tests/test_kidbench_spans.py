"""The program's spans (``kid_tpu_torch/spans.py``) in the harness's trace
reduction: a span drawn by the profiler, on the host and as a user
annotation on the device, is never counted as a device activity, on a
made-up timeline and on the card."""
from types import SimpleNamespace

import pytest
import torch

from kidbench import trace
from kid_tpu_torch import spans


@pytest.fixture
def spans_on():
    """The program's spans on for the test, and nothing of them left."""
    was = spans.ON
    spans.enable()
    yield
    spans.disable()
    spans.take()
    if was:
        spans.enable()


class FakeProfile:
    """``torch.profiler.profile`` with a made-up timeline: a kernel, the
    program's span on the host and, as the profiler draws it, on the
    device (a user annotation), and a gap inside that span."""

    def __init__(self, activities):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def events(self):
        from torch.autograd import DeviceType

        def ev(name, a, b, dev, annotation=False):
            return SimpleNamespace(name=name, device_type=dev,
                                   time_range=SimpleNamespace(start=a,
                                                              end=b),
                                   is_user_annotation=annotation)
        return [ev("kid.chunk.replay", 0.0, 1000.0, DeviceType.CPU, True),
                ev("kid.chunk.replay", 0.0, 1000.0, DeviceType.CUDA, True),
                ev("void fused_step_kernel<float>", 0.0, 300.0,
                   DeviceType.CUDA),
                ev("void fused_step_kernel<float>", 700.0, 1000.0,
                   DeviceType.CUDA)]


def test_a_program_span_is_never_a_device_activity(monkeypatch):
    import torch.profiler
    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    s = trace.traced(lambda: None, 2, None)
    assert s.busy_s == pytest.approx(600e-6)
    assert sum(s.by_class.values()) == pytest.approx(600e-6)
    assert [n for n, _ in s.device_ops] == ["void fused_step_kernel<float>"]
    assert s.idle_gaps == [["kid.chunk.replay", pytest.approx(400e-6)]]


@pytest.mark.card
def test_the_cards_trace_counts_no_program_span(card, spans_on):
    x = torch.ones(1 << 22, device=card)

    def work():
        for _ in range(3):
            with spans.span("kid.chunk.replay"):
                x.mul_(1.0000001)

    s = trace.traced(work, 3, card)
    names = [n for n, _ in s.device_ops]
    assert names and not [n for n in names if n.startswith(spans.PREFIX)]
    assert s.busy_s <= s.window_s

"""The reduction of a device trace: busy as a union, the profiler's
copies of host ranges left out, device time by span through the launch
call's thread and time, idle gaps named by the host's range."""
import pytest

from port_bench import devtrace
from port_bench.devtrace import Event

MS = 1_000_000


def _events():
    main, grad = 1, 2
    return [
        Event("aten::mm", False, 2 * MS, 3 * MS, main, 4, 0),
        Event("cudaLaunchKernel", False, 2 * MS, 3 * MS, 9999, 500, 4),
        Event("gemm", True, 10 * MS, 30 * MS, 7, 500, 4),
        # backward on the autograd thread: the node's range encloses the
        # span, and the kernel links to the node's range
        Event("FooBackward", False, 40 * MS, 55 * MS, grad, 5, 0),
        Event("pb.span:foo_bwd", False, 41 * MS, 54 * MS, grad, 6, 0),
        Event("cudaLaunchKernel", False, 42 * MS, 43 * MS, 9998, 501, 5),
        Event("foo_bwd_kernel", True, 35 * MS, 50 * MS, 7, 501, 5),
        # a launch in the node but outside the span
        Event("cudaLaunchKernel", False, 54.5 * MS, 54.6 * MS, 9998, 502, 5),
        Event("copy", True, 70 * MS, 80 * MS, 7, 502, 5),
        # the profiler's copy of a host range on the device's timeline
        Event("pb.span:foo_bwd", True, 35 * MS, 50 * MS, 7, 6, 0),
    ]


MARKS = [("step", 1 * MS, 60 * MS), ("read", 60 * MS, 99 * MS)]


def test_device_summary():
    window, busy, ops, gaps = devtrace.device_summary(
        _events(), 0, 100 * MS, MARKS)
    assert window == pytest.approx(0.1)
    assert busy == pytest.approx(0.045)         # 10-30 u 35-50, 70-80
    assert dict(ops) == pytest.approx({"gemm": 0.02, "foo_bwd_kernel": 0.015,
                                       "copy": 0.01})
    assert gaps[0] == ("read", pytest.approx(0.02))     # 50-70 or 80-100
    assert [g[0] for g in gaps] == ["read", "read", "step", "step"]
    assert sum(g[1] for g in gaps) == pytest.approx(0.055)


def test_span_seconds():
    assert devtrace.span_seconds(_events()) == pytest.approx(
        {"foo_bwd": 0.015})


def test_marks_only_while_on():
    marks = devtrace.Marks()
    with marks.mark("feed"):
        pass
    marks.on = True
    with marks.mark("step"):
        pass
    assert [m[0] for m in marks.log] == ["step"]
    assert marks.log[0][1] <= marks.log[0][2]


class Holder:
    @staticmethod
    def back(ctx, grad):
        return grad + 1


def test_spans_wrap_record_and_restore():
    spans = devtrace.Spans({"b": f"{__name__}:Holder.back"})
    raw = Holder.__dict__["back"]
    with devtrace.installed(spans):
        assert Holder.__dict__["back"] is not raw
        Holder.back(None, 1)
        spans.recording = True

        class Ctx:
            pass
        ctx = Ctx()
        ctx.causal, ctx.window, ctx.saved = True, 8, object()
        assert Holder.back(ctx, 2) == 3
    assert Holder.__dict__["back"] is raw
    assert spans.calls["b"] == [(({"causal": True, "window": 8}, 2),
                                 {"items": 0})]

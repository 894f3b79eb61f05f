"""Kernel and idle time put down to the program's spans (``spantrace``)
and the four readers of it, on a synthetic trace with a span list: a
kernel launched inside and outside ``model.mixer``, one launched from the
autograd thread inside ``model.mixer.backward``, an idle gap inside
``train.optimizer``, the fallback to the roots' thread; the join of the
program's spans with a trace's clock, and its witness."""
import time

import pytest

from perfbench import devtrace, harness, spantrace
from perfbench.spantrace import Rec
from repro_torch.telemetry import SpanTracer

MAIN, AUTOGRAD = 1, 9
MIXER_METRICS = ("mixer_kernel_ms", "mixer_idle_ms", "optimizer_kernel_ms",
                 "optimizer_idle_ms")


def _kernel(name, ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def _launch(tid, ts, corr, name="cudaLaunchKernel", dur=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "tid": tid,
            "ts": ts, "dur": dur, "args": {"correlation": corr}}


def _marker(i, host, dev):
    return [_launch(MAIN, host, 1000 + i),
            _kernel(f"at::cuda::{devtrace.MARKER}(long)", dev, 1, 1000 + i)]


def _step_spans(off=0.0):
    """One step's spans, host times 10 .. 90 (+ ``off``)."""
    s = ("train.step",)
    f, b = s + ("train.forward",), s + ("train.backward",)
    return [Rec("train.step", 10 + off, 90 + off, MAIN, s),
            Rec("train.forward", 11 + off, 40 + off, MAIN, f),
            Rec("model.mixer", 15 + off, 25 + off, MAIN,
                f + ("model.mixer",)),
            Rec("train.backward", 41 + off, 70 + off, MAIN, b),
            Rec("model.mixer.backward", 45 + off, 55 + off, AUTOGRAD,
                b + ("model.mixer.backward",)),
            Rec("train.optimizer", 71 + off, 88 + off, MAIN,
                s + ("train.optimizer",))]


def _events():
    """One profiled step between two markers. Kernels (launch on the
    host, run on the device, us): forward outside the mixer 12 -> 12..17
    (5); inside ``model.mixer`` 20 -> 20..27 (7); from the autograd thread
    inside ``model.mixer.backward`` 50 -> 50..61 (11); from the autograd
    thread outside its intervals (to ``train.backward`` on the roots'
    thread) 60 -> 61..74 (13); inside ``train.optimizer`` 75 -> 82..99
    (17). The window runs from the first marker's start, 4, to the last
    one's end, 100."""
    return [
        *_marker(0, 2, 4),
        _launch(MAIN, 12, 1), _kernel("fwd", 12, 5, 1),
        _launch(MAIN, 20, 2), _kernel("attn_fwd", 20, 7, 2),
        _launch(AUTOGRAD, 50, 3), _kernel("attn_bwd", 50, 11, 3),
        _launch(AUTOGRAD, 60, 4), _kernel("norm_bwd", 61, 13, 4),
        _launch(MAIN, 75, 5), _kernel("adam", 82, 17, 5),
        *_marker(1, 95, 99)]


def _attribution():
    tr = devtrace.Trace(_events(), 1)
    return spantrace.Attribution(tr, _step_spans())


def test_kernels_by_innermost_span_with_the_roots_thread_as_fallback():
    a = _attribution()
    got = {(None if r is None else r.name): us for r, us in a.kernel}
    assert got == {"train.forward": 5, "model.mixer": 7,
                   "model.mixer.backward": 11, "train.backward": 13,
                   "train.optimizer": 17}
    assert a.kernel_ms(*spantrace.MIXER) == pytest.approx(18e-3)
    assert a.kernel_ms(*spantrace.OPTIMIZER) == pytest.approx(17e-3)
    assert a.kernel_ms("train.step") == pytest.approx(53e-3)
    assert a.step_share() == 1.0


def test_idle_gaps_by_the_span_open_at_their_middle():
    a = _attribution()
    idle = [(None if r is None else r.name, us) for r, us in a.idle]
    # busy 12..17, 20..27, 50..74, 82..99; the step's root is 10..90
    assert idle == [(None, 8), ("model.mixer", 3), ("train.forward", 23),
                    ("train.optimizer", 8), (None, 1)]
    assert a.idle_ms(*spantrace.OPTIMIZER) == pytest.approx(8e-3)
    assert a.idle_ms(*spantrace.MIXER) == pytest.approx(3e-3)
    table = {name: (k, i) for name, k, i in a.by_span()}
    assert table["train.forward"] == pytest.approx((5e-3, 23e-3))
    assert table["(no span)"] == pytest.approx((0.0, 9e-3))
    assert a.by_span()[0][0] == "train.forward"


def test_an_idle_gap_on_the_autograd_thread_goes_to_its_interval():
    """The device idle at 50..52 while the autograd thread is inside
    ``model.mixer.backward`` and the main thread inside
    ``train.backward``: the autograd thread's span takes it."""
    ev = [*_marker(0, 2, 4), _launch(AUTOGRAD, 46, 1),
          _kernel("a", 46, 4, 1), _launch(AUTOGRAD, 52, 2),
          _kernel("b", 52, 43, 2), *_marker(1, 95, 95)]
    tr = devtrace.Trace(ev, 1)
    a = spantrace.Attribution(tr, _step_spans())
    assert [(None if r is None else r.name, us) for r, us in a.idle] == [
        ("train.forward", 42), ("model.mixer.backward", 2), (None, 1)]
    assert a.idle_ms(*spantrace.MIXER) == pytest.approx(2e-3)


def _ctx(trace, spans, cuda=True):
    return type("Ctx", (), dict(cuda=cuda, trace=trace, spans=spans))()


def test_the_four_readers():
    tr = devtrace.Trace(_events(), 1)
    ctx = _ctx(tr, _step_spans())
    read = {n: harness.metric_reader(n).read(ctx) for n in MIXER_METRICS}
    assert read == pytest.approx({"mixer_kernel_ms": 18e-3,
                                  "mixer_idle_ms": 3e-3,
                                  "optimizer_kernel_ms": 17e-3,
                                  "optimizer_idle_ms": 8e-3})
    for c in (_ctx(tr, []), _ctx(None, _step_spans()),
              _ctx(tr, _step_spans(), cuda=False),
              _ctx(devtrace.Trace(_events()[2:], 1), _step_spans())):
        for n in MIXER_METRICS:
            assert harness.metric_reader(n).read(c) is None, n


def test_two_steps_are_averaged():
    ev = [*_marker(0, 2, 4),
          _launch(MAIN, 75, 5), _kernel("adam", 82, 17, 5),
          *_marker(1, 95, 99),
          _launch(MAIN, 175, 6), _kernel("adam", 182, 13, 6),
          *_marker(2, 195, 199)]
    a = spantrace.Attribution(devtrace.Trace(ev, 2),
                              _step_spans() + _step_spans(100.0))
    assert a.kernel_ms(*spantrace.OPTIMIZER) == pytest.approx(15e-3)
    # the narrowest bracket: root 0's end 90 to root 1's start 110, less
    # the launch's 1 us
    assert a.join_witness() == (3, 3, 0.0, 19.0)


@pytest.mark.parametrize("ident,tid", [
    (0x7F3E_B1CC_0300, 1_312_029_952),      # the main thread, on the card
    (0x7F3E_057F_F6C0, 92_272_320),         # the autograd thread
    (0x7F3E_8000_0000, 1 << 31), (0x7F3E_0000_0001, 1)])
def test_trace_tid_of_a_thread(ident, tid):
    assert spantrace.trace_tid(ident) == tid


def test_program_spans_join_the_trace_clock():
    """Spans of the program's tracer, on a trace whose base is Kineto's
    (a multiple of ``KINETO_BASE_S`` seconds): each span's start lands
    where the trace's clock puts it, the witness holds, and a clock
    milliseconds off shows in it."""
    tr = SpanTracer(enabled=True)
    period = spantrace.KINETO_BASE_S * 10 ** 9
    roots, marks = [], []
    for i in range(3):
        marks.append(time.time_ns())
        time.sleep(0.002)
        with tr.span("train.step", step=i) as root:
            with tr.span("train.optimizer"):
                time.sleep(0.002)
        roots.append(root)
        time.sleep(0.002)
    marks.append(time.time_ns())
    base = marks[0] // period * period
    ident = spantrace.trace_tid(roots[0].ident)

    def events(shift_ns=0):
        ev = []
        for i, m in enumerate(marks):
            ts = (m - base + shift_ns) / 1e3
            ev += [_launch(ident, ts, 1000 + i, dur=1),
                   _kernel(devtrace.MARKER, ts + 5, 1, 1000 + i)]
        t_opt = roots[1].children[0]
        ts = (t_opt.wall_ns(t_opt.t_start) - base) / 1e3 + 100
        return ev + [_launch(ident, ts, 7), _kernel("adam", ts + 3, 4, 7)]

    trace = devtrace.Trace(events(), 3)
    recs = spantrace.program_records(trace, roots)
    assert [r.name for r in recs] == ["train.step", "train.optimizer"] * 3
    assert {r.thread for r in recs} == {ident}
    for r, sp in zip(recs[::2], roots):
        assert r.start == pytest.approx(
            (sp.wall_ns(sp.t_start) - base) / 1e3)
    a = spantrace.Attribution(trace, recs)
    assert a.kernel_ms(*spantrace.OPTIMIZER) == pytest.approx(4e-3 / 3)
    inside, n, worst, room = a.join_witness()
    assert (inside, n, worst) == (4, 4, 0.0) and room > 1000
    # the trace's clock behind the spans' by the time from the middle of
    # step 0 to the marker after it: every marker but the first falls
    # inside a step's root
    r0 = roots[0]
    shift = (r0.wall_ns(r0.t_start) + r0.wall_ns(r0.t_end)) // 2 - marks[1]
    off = spantrace.Attribution(
        devtrace.Trace(events(shift), 3), recs).join_witness()
    assert off[0] == 1 and off[2] > 500
    # no clock on the spans (a program whose tracer has none): nothing
    assert spantrace.program_records(trace, [object()]) == []

"""The ``rwkv6-3b.train-4x512`` cell at the smoke size on the CPU: a whole
run, the float32 program against the reference, the control and the
faults the check must catch (the planted time-mix faults among them), the
scan's work counted by hand, and the cell's span readers on a synthetic
trace."""
import dataclasses
import json

import pytest
import torch

from perfbench import compare, devtrace, harness, run, scanwork
from perfbench.spantrace import Rec
from perfbench.tools import readings, timemix_faults
from repro_torch.configs import get_config

NAME = "rwkv6-3b.train-4x512"
CPU = torch.device("cpu")
# Limits at the smoke size (d 64, 4 heads of 16, 2 layers, 2 rows of 32
# tokens), over the numbers the full cell judges, set as the cell's are:
# between the sound program's largest reading on seeds 1-12 and the
# smallest of the control or of a fault on seeds 1-7 (CPU, torch 2.13):
#   grad_leaf 2.97e-3 / control 1.67e-2 (the scan's dw dropped 0.147, the
#   bonus dropped 6.96e-2, half batch 0.510, a state unchanged 1.0);
#   grad_median 4.02e-4 / control 2.17e-3;
#   delta_leaf, which precision hardly moves (the control 1.18e-2),
#   between the program's 9.08e-3 and a state unchanged or a leaf unmoved,
#   1.0.
SMOKE_LIMITS = {"grad_leaf": 9e-3, "grad_median": 1e-3, "delta_leaf": 3e-2}
FAULTS = dict(readings.FAULTS, **timemix_faults.FAULTS)


def smoke_cell(dtype: str = "bfloat16") -> harness.Cell:
    """The cell with the smoke config's sizes and the published block,
    2 rows of 32 tokens, held to ``SMOKE_LIMITS``."""
    full = harness.Cell.load(NAME)
    cfg = dataclasses.replace(get_config("rwkv6-3b", smoke=True),
                              rwkv_block="finch",
                              dtype=dtype)
    model = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    return harness.Cell(f"{NAME}.smoke", full.spec,
                        {"reference": full.config["reference"],
                         "model": model},
                        dict(full.traffic, batch=2, seq=32), SMOKE_LIMITS,
                        full.end_to_end, full.per_layer)


def test_full_cell_is_the_published_model():
    cell = harness.Cell.load(NAME)
    assert cell.config["reference"] == "rwkv6"
    assert cell.model["rwkv_block"] == "finch"
    assert harness.yardstick.param_count(cell.specs) == \
        cell.config["parameters"] == 3_099_855_360
    assert set(SMOKE_LIMITS) == set(cell.limits)


@pytest.mark.parametrize("trace", [0, 1])
def test_smoke_run_on_cpu(trace):
    cell = smoke_cell()
    result, lines = harness.run_cell(cell.name, 2 ** 31 + 4321, 0.3,
                                     bool(trace), "cpu", cell=cell)
    line = json.loads(json.dumps(run.plain(result)))
    assert line["correct"] is True and line["failed"] == 0
    assert line["metrics"] == ({} if trace else {
        "step_ms": line["metrics"]["step_ms"],
        "setup_s": line["metrics"]["setup_s"]})
    assert [ln.split()[1] for ln in lines] == list(SMOKE_LIMITS)


def test_reference_equals_program_in_float32():
    cell = smoke_cell("float32")
    cell.specs = cell.arch.param_specs(cell.model)
    for seed in (3, 2 ** 33 + 1):
        batches = cell.batches(seed, CPU)
        _, _, got = cell.program(seed, CPU, batches)
        values, _ = compare.numbers(got, cell.reference(seed, CPU, batches))
        assert max(values.values()) < 2e-5, values


@pytest.mark.parametrize("fault", list(FAULTS))
def test_faults_come_out_incorrect(fault):
    """``readings.py``'s faults and the three planted in the time mix:
    the scan's gradient of the decay dropped (a gradient through
    ``wkv6_scan``), the bonus dropped, one leaf left unmoved."""
    cell = smoke_cell()
    result, _ = harness.run_cell(cell.name, 77, 0.2, False, "cpu",
                                 step_hook=FAULTS[fault], cell=cell)
    assert result["correct"] is False


def test_scan_dw_dropped_leaves_the_forward_and_zeroes_the_decays():
    """The planted scan fault changes no loss of the first step and
    takes every gradient of the decays away."""
    cell = smoke_cell("float32")
    cell.specs = cell.arch.param_specs(cell.model)
    batches = cell.batches(5, CPU)
    _, _, good = cell.program(5, CPU, batches)
    _, _, bad = cell.program(5, CPU, batches,
                             timemix_faults.FAULTS["scan_dw_dropped"])
    assert bad["loss"][0] == good["loss"][0]
    decays = [k for k in good["grad"] if ".decay" in k]
    assert decays and all(good["grad"][k] > 0 for k in decays)
    assert all(bad["grad"][k] == 0 for k in decays)


def test_control_comes_out_incorrect():
    cell = smoke_cell()
    for seed in (5, 6, 7):
        batches = cell.batches(seed, CPU)
        ref = cell.reference(seed, CPU, batches)
        ctl = cell.reference(seed, CPU, batches, "fp8")
        values, _ = compare.numbers(ctl, ref)
        assert not compare.judge(values, SMOKE_LIMITS), values


def test_scan_work_counted_by_hand():
    # B 1, S 2, H 1, Dh 2: n = 4 elements a tensor, a state of 4
    assert scanwork.wkv6_bytes(1, 2, 1, 2) == {
        "forward": 4 * (5 * 4 + 2 + 2 * 4),
        "backward": 4 * (9 * 4 + 2 * 2 + 3 * 4)}
    assert scanwork.wkv6_flops(1, 2, 1, 2) == {
        "forward": 5 * 4 * 2 + 5 * 4, "backward": 14 * 4 * 2 + 16 * 4}
    # the cell's layer (4 x 512, 40 heads of 64): operations bound it,
    # (5 + 14) n Dh + 21 n over 67 TFLOP/s, 0.0968 ms a call
    n = 4 * 512 * 40 * 64
    assert scanwork.bound_s(4, 512, 40, 64) == pytest.approx(
        (19 * n * 64 + 21 * n) / 67e12)
    assert scanwork.bound_s(4, 512, 40, 64) * 1e3 == pytest.approx(
        0.0968, abs=5e-5)
    cell = harness.Cell.load(NAME)
    assert scanwork.step_bound_s(cell.model, cell.traffic) == \
        pytest.approx(32 * scanwork.bound_s(4, 512, 40, 64))


def _kernel(name, ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def _launch(tid, ts, corr):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "tid": tid, "ts": ts, "dur": 1, "args": {"correlation": corr}}


def test_cell_readers_on_a_synthetic_trace():
    """One profiled step: kernels inside ``model.ddlerp`` (3 us) and
    ``model.wkv6`` (5) within ``model.mixer``, inside
    ``model.channel_mix`` (7), and on the autograd thread inside
    ``model.wkv6.backward`` (11), ``model.ddlerp.backward`` (13) and
    ``model.channel_mix.backward`` (17); an idle gap inside the scan's
    backward (device idle 60 .. 64)."""
    main, grad = 1, 9
    s = ("train.step",)
    f, b = s + ("train.forward",), s + ("train.backward",)
    mix = f + ("model.mixer",)
    spans = [Rec("train.step", 1, 99, main, s),
             Rec("train.forward", 2, 40, main, f),
             Rec("model.mixer", 3, 20, main, mix),
             Rec("model.ddlerp", 4, 9, main, mix + ("model.ddlerp",)),
             Rec("model.wkv6", 10, 15, main, mix + ("model.wkv6",)),
             Rec("model.channel_mix", 21, 30, main,
                 f + ("model.channel_mix",)),
             Rec("train.backward", 41, 95, main, b),
             Rec("model.channel_mix.backward", 42, 50, grad,
                 b + ("model.channel_mix.backward",)),
             Rec("model.mixer.backward", 51, 90, grad,
                 b + ("model.mixer.backward",)),
             Rec("model.wkv6.backward", 55, 70, grad,
                 b + ("model.wkv6.backward",)),
             Rec("model.ddlerp.backward", 75, 85, grad,
                 b + ("model.ddlerp.backward",))]
    ev = [_launch(main, 0, 100), _kernel(devtrace.MARKER, 0, 1, 100),
          _launch(main, 98, 101), _kernel(devtrace.MARKER, 98, 1, 101)]
    for corr, (tid, t, dur) in enumerate(
            [(main, 5, 3), (main, 11, 5), (main, 22, 7), (grad, 43, 17),
             (grad, 56, 4), (grad, 64, 7), (grad, 76, 13)], start=1):
        ev += [_launch(tid, t, corr), _kernel("k", t, dur, corr)]
    cell = harness.Cell.load(NAME)
    ctx = type("Ctx", (), dict(
        cuda=True, trace=devtrace.Trace(ev, 1), spans=spans,
        model=cell.model, traffic=cell.traffic, specs=cell.specs))
    read = lambda n: harness.metric_reader(n).read(ctx)
    assert read("wkv6_kernel_ms") == pytest.approx((5 + 4 + 7) / 1e3)
    assert read("ddlerp_kernel_ms") == pytest.approx((3 + 13) / 1e3)
    assert read("channel_mix_kernel_ms") == pytest.approx((7 + 17) / 1e3)
    assert read("wkv6_idle_ms") == pytest.approx(4 / 1e3)
    assert read("wkv6_roofline") == pytest.approx(
        100 * scanwork.step_bound_s(cell.model, cell.traffic) / 16e-6)
    # nothing of the scan in the trace (a program without its spans):
    # no reading, never a 0
    ctx.spans = [r for r in spans if "wkv6" not in r.name]
    ctx.span_attribution = None
    for name in ("wkv6_kernel_ms", "wkv6_idle_ms", "wkv6_roofline"):
        assert read(name) is None, name

"""The harness at the port's smoke sizes on the CPU: a whole run, its
result line, the reference against the program, the control and the
faults the check must catch."""
import dataclasses
import json
import math
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from perfbench import compare, devtrace, harness, run
from perfbench.tools import readings
from repro_torch.configs import get_config

ROOT = Path(__file__).resolve().parents[2]
BENCH = harness.benchmark()
# each cell at the port's smoke config, with the cell's batch rows and
# 32 or 64 tokens a row
SMOKE = {"internlm2-1.8b.train-4x512": (2, 32),
         "internlm2-1.8b.train-1x4096": (1, 64)}
ID = {"internlm2-1.8b.train-4x512": "internlm2",
      "internlm2-1.8b.train-1x4096": "internlm2-1x4096"}
RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device",
               "checks"}
CPU = torch.device("cpu")


# Limits at the smoke size, over the numbers the full cell judges, set as
# the cells' are: between the sound program's largest reading on seeds
# 1-12 and the smallest of the control (the reference with float8
# operands) or of a fault on seeds 1-4 (CPU, torch 2.13):
#   4x512 loss 2.37e-4 / control 1.92e-3; grad_leaf 2.83e-3 / control
#   8.66e-3; delta_leaf 5.89e-3 / half batch 0.124 (control 1.06e-2);
#   1x4096 loss and loss1 4.14e-4 / control 1.21e-3; grad_leaf 2.30e-3 /
#   control 1.36e-2; delta_leaf 5.51e-3 / a state unchanged or a leaf
#   unmoved 1.0 (control 9.72e-3).
SMOKE_LIMITS = {"internlm2-1.8b.train-4x512": {
                    "loss": 7e-4, "grad_leaf": 5e-3, "delta_leaf": 4e-2},
                "internlm2-1.8b.train-1x4096": {
                    "loss": 8e-4, "loss1": 8e-4, "grad_leaf": 5e-3,
                    "delta_leaf": 4e-2}}


def smoke_cell(name: str, dtype: str | None = None) -> harness.Cell:
    """The cell ``name`` with the port's smoke config in place of the
    full one and its rows of ``SMOKE``'s length, held to the same numbers
    as the full cell at the smoke size's limits."""
    full = harness.Cell.load(name)
    assert set(SMOKE_LIMITS[name]) == set(full.limits)
    cfg = get_config(full.spec["config"], smoke=True)
    model = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    if dtype:
        model["dtype"] = dtype
    rows, seq = SMOKE[name]
    return harness.Cell(f"{name}.smoke", full.spec,
                        {"reference": full.config["reference"],
                         "model": model},
                        dict(full.traffic, batch=rows, seq=seq),
                        SMOKE_LIMITS[name], full.end_to_end, full.per_layer)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", list(SMOKE), ids=ID.get)
def test_smoke_run_on_cpu(name, trace):
    cell = smoke_cell(name)
    result, lines = harness.run_cell(cell.name, 2 ** 31 + 12345, 0.3,
                                     bool(trace), "cpu", cell=cell)
    line = json.loads(json.dumps(run.plain(result)))
    # the CPU has no device trace: no breakdown, no busy or window time
    assert set(line) == RESULT_KEYS
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if trace:
        # no device metric is read from a CPU run
        assert line["metrics"] == {}
    else:
        assert set(line["metrics"]) == {"step_ms", "setup_s"}
        assert all(v["value"] > 0 for v in line["metrics"].values())
    assert [ln.split()[1] for ln in lines] == list(cell.limits)
    for name, c in line["checks"].items():
        assert c["value"] <= c["limit"], name


@pytest.mark.parametrize("name", list(SMOKE), ids=ID.get)
def test_reference_equals_program_in_float32(name):
    """The reference's layer equations are the program's: with the
    program's weights in float32 every compared number is rounding."""
    cell = smoke_cell(name, "float32")
    cell.specs = cell.arch.param_specs(cell.model)
    for seed in (3, 2 ** 33 + 1):
        batches = cell.batches(seed, CPU)
        _, _, got = cell.program(seed, CPU, batches)
        values, _ = compare.numbers(got, cell.reference(seed, CPU, batches))
        assert max(values.values()) < 2e-5, values
        assert compare.judge(values, cell.limits)


def _one_leaf_unmoved(step):
    """The update of one layer's query matrix dropped: an answer altered
    where the step produces it."""
    def broken(p, o, b):
        new_p, new_o, met = step(p, o, b)
        mixer = new_p["main"]["sub0"]["mixer"]
        w = mixer["wq"].clone()
        w[0] = p["main"]["sub0"]["mixer"]["wq"][0]
        mixer["wq"] = w
        return new_p, new_o, met
    return broken


FAULTS = dict(readings.FAULTS, one_leaf_unmoved=_one_leaf_unmoved)
# a batch of one row has no half to leave out
CASES = [(name, fault) for name in SMOKE for fault in FAULTS
         if SMOKE[name][0] > 1 or fault != "half_batch"]


@pytest.mark.parametrize("name,fault", CASES,
                         ids=[f"{ID[n]}-{f}" for n, f in CASES])
def test_faults_come_out_incorrect(name, fault):
    cell = smoke_cell(name)
    result, _ = harness.run_cell(cell.name, 77, 0.2, False, "cpu",
                                 step_hook=FAULTS[fault], cell=cell)
    assert result["correct"] is False


@pytest.mark.parametrize("name", list(SMOKE), ids=ID.get)
def test_control_comes_out_incorrect(name):
    """The reference computed with float8 operands in the program's
    place fails the cell's limits."""
    cell = smoke_cell(name)
    for seed in (5, 6, 7):
        batches = cell.batches(seed, CPU)
        ref_out = cell.reference(seed, CPU, batches)
        ctl = cell.reference(seed, CPU, batches, "fp8")
        values, _ = compare.numbers(ctl, ref_out)
        assert not compare.judge(values, cell.limits), values


def test_compare_counts_nan_and_missing_leaves_as_worst():
    ref = {"loss": [2.0], "gnorm": [1.0],
           "grad": {"a": 1.0, "b": 2.0, "c": 1.0},
           "delta": {"a": 1.0, "b": 1.0, "c": 1.0}}
    got = {"loss": [math.nan], "gnorm": [1.0],
           "grad": {"a": 1.0, "c": 1.0},
           "delta": {"a": 1.0, "b": math.nan, "c": 1.0}}
    values, where = compare.numbers(got, ref)
    assert values["loss"] == math.inf and values["grad_leaf"] == math.inf
    assert values["delta_leaf"] == math.inf
    assert where["grad_leaf"] == "b" and where["delta_leaf"] == "b"
    assert not compare.judge(values, {k: 1.0 for k in compare.NAMES})


def _kernel(name, ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def _launch(tid, ts, corr, name="cudaLaunchKernel", dur=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "tid": tid,
            "ts": ts, "dur": dur, "args": {"correlation": corr}}


def _marked(events, marks):
    """``events`` with a marker kernel (``devtrace.MARKER``) launched at
    each host time of ``marks`` [(launch ts, kernel ts)] by thread 1."""
    out = list(events)
    for i, (host, dev) in enumerate(marks):
        out += [_launch(1, host, 1000 + i),
                _kernel(f"at::cuda::{devtrace.MARKER}(long)", dev, 1,
                        1000 + i)]
    return out


def test_trace_phases_busy_and_idle():
    """One step between two markers: two forward kernels from the main
    thread, one from the autograd thread, one after it (the optimizer);
    the host in a synchronising call during one gap."""
    ev = _marked([
        _launch(1, 1, 1), _launch(1, 2, 2), _launch(7, 30, 3),
        _launch(1, 60, 4), _launch(1, 52, 5, "cudaMalloc", 20),
        _kernel("void (anonymous namespace)::fwd<4>(float*)", 10, 10, 1),
        _kernel("fwd2", 20, 5, 2), _kernel("attn_backward", 30, 20, 3),
        _kernel("adam", 80, 10, 4),
        {"cat": "gpu_memset", "name": "Memset", "ts": 5, "dur": 2}],
        [(0, 0), (90, 99)])
    tr = devtrace.Trace(ev, 1)
    assert tr.n_steps == 1 and tr.window == (0, 100)
    assert len(tr.kernels) == 4          # the markers are not counted
    assert tr.phase_us("forward") == 15 and tr.phase_us("backward") == 20
    assert tr.phase_us("after") == 10
    assert tr.busy_us() == 2 + 15 + 20 + 10
    assert [k for k, _ in tr.top_ops(2)] == ["attn_backward", "fwd"]
    assert [s for _, s in tr.top_ops(2)] == pytest.approx([20e-6, 10e-6])
    idle = dict(tr.idle_by_host())
    assert idle["cudaMalloc"] == pytest.approx(30e-6)     # 50 .. 80
    assert sum(idle.values()) == pytest.approx(53e-6)


def test_trace_without_markers_reads_nothing():
    tr = devtrace.Trace([_launch(1, 1, 1), _kernel("k", 5, 5, 1)], 2)
    assert tr.window is None and tr.phase_us("after") is None


@pytest.mark.parametrize("events", [
    [_launch(1, 1, 1), _kernel("k", 5, 5, 1)],     # no markers
    _marked([], [(0, 0), (9, 9)])])                  # no kernel
def test_a_trace_with_nothing_to_read_fails_the_run(events):
    with pytest.raises(RuntimeError, match="nothing to read"):
        harness.check_trace(devtrace.Trace(events, 1))
    ok = _marked([_launch(1, 1, 1), _kernel("k", 5, 5, 1)], [(0, 0), (9, 9)])
    harness.check_trace(devtrace.Trace(ok, 1))


def test_metric_readers_on_a_synthetic_trace():
    ev = _marked([
        _launch(1, 1, 1), _launch(9, 2, 2), _launch(1, 3, 3),
        _kernel("f", 0, 100, 1), _kernel("attn_backward", 100, 300, 2),
        _kernel("adam", 400, 200, 3)], [(0, 0), (900, 999)])
    cell = harness.Cell.load(list(SMOKE)[0])
    # ten unprofiled steps of 0.8 ms; the profiled step is busy 0.6 ms
    ctx = type("Ctx", (), dict(
        cuda=True, trace=devtrace.Trace(ev, 1), timed_steps=10,
        timed_s=8e-3, alloc_retries=3, peak_bytes=2 ** 31,
        specs=cell.specs, model=cell.model, traffic=cell.traffic,
        yard=harness.yardstick, tokens_per_step=cell.tokens_per_step()))
    read = lambda n: harness.metric_reader(n).read(ctx)
    assert read("launches_per_step") == 3
    assert read("model_kernel_ms") == pytest.approx(0.4)
    assert read("adamw_ms") == pytest.approx(0.2)
    assert read("idle_share") == pytest.approx(25.0)
    assert read("alloc_retries") == pytest.approx(0.3)
    assert read("peak_mem_gib") == pytest.approx(2.0)
    y = harness.yardstick
    assert read("adamw_roofline") == pytest.approx(
        100 * y.adamw_bytes(cell.specs) / y.H100["hbm_bps"] / 200e-6)
    assert read("step_mfu") == pytest.approx(
        100 * y.train_flops(cell.specs, 2048) / 0.8e-3
        / y.H100["bf16_flops"])
    # nothing to read: no metric, never a 0
    ctx.trace, ctx.cuda, ctx.peak_bytes = None, False, 0
    for m in BENCH["per_layer"]:
        assert read(m["name"]) is None, m["name"]


def _run(cwd: Path, *extra) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, str(cwd / "perfbench" / "run.py"), "--workload",
         list(SMOKE)[0], "--seed", "1", "--seconds", "1", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=120)


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_run_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_banned_modules_compare_whole_top_level_names():
    names = ["reprox", "repro_torch.models", "torch", "jaxx.y"]
    assert run.banned_modules(names) == []
    assert run.banned_modules(names + ["repro.core", "jaxlib.xla",
                                       "flax"]) == ["flax", "jaxlib", "repro"]

"""A training cell: set-up, the measured window, the profiled stretch and
the check against the plain reference.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives:
``configs/<config>.json`` (the sizes; ``reference`` names the module of
``reference/`` that holds the architecture's plain layer),
``traffic/<traffic>.json`` (batch, sequence, microbatches, optimizer),
``limits/<workload>.json`` (the limit of each compared number) and
``metrics/<metric>.py`` (a ``read(ctx)`` and its ``MOVES``).

Set-up builds the program's model (``repro_torch``), hands it weights
drawn from the seed (``weights.py``), initialises AdamW and the step of
``launch.steps.make_train_step``, and drives that step through its first
three steps on three different batches. Those steps warm every shape the
window uses and give the readings the reference is compared with. The
window runs whole steps until ``seconds`` have passed and ends on a
device synchronise. A traced run then profiles a few more steps. Once
the program's state is freed, the reference follows the same three steps
from the same weights and batches.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
import time
import types
from pathlib import Path

import torch

from . import compare, devtrace, tokens, weights, yardstick
from .reference import adamw as ref_adamw
from .reference.train import change_norms, follow, leaf_norms

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FIRST = 3          # steps set-up drives and the reference follows
POOL = 8           # distinct batches, cycled through by the window
PROFILED = 4       # steps under the profiler in a traced run


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def log(msg: str) -> None:
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


def metric_reader(name: str) -> types.ModuleType:
    """``metrics/<name>.py``, loaded by its file."""
    spec = importlib.util.spec_from_file_location(
        f"perfbench.metrics.{name}", HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------- program
def flat_paths(tree, prefix: str = "") -> list:
    """[(dotted path, leaf)] of a tree of dicts (keys in sorted order, as
    the program's ``_tree`` orders them) and lists."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in flat_paths(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree)
                for x in flat_paths(t, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def place(abstract, flat: dict):
    """``abstract`` (the program's parameter tree on the meta device) with
    each leaf replaced by the drawn tensor of its path; the two must
    agree on every path, shape and dtype."""
    paths = dict(flat_paths(abstract))
    if set(paths) != set(flat):
        raise ValueError(f"the program's parameters {sorted(paths)} are not "
                         f"the reference's {sorted(flat)}")
    for path, leaf in paths.items():
        got = flat[path]
        if tuple(leaf.shape) != tuple(got.shape) or leaf.dtype != got.dtype:
            raise ValueError(f"{path}: the program holds {tuple(leaf.shape)} "
                             f"{leaf.dtype}, the reference {tuple(got.shape)} "
                             f"{got.dtype}")

    def build(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: build(v, f"{prefix}{k}.") for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(build(t, f"{prefix}{i}.")
                              for i, t in enumerate(tree))
        return flat[prefix[:-1]]

    return build(abstract)


class Cell:
    """One workload and its files: its ``BENCHMARK.json`` entry, the
    configuration, the traffic mix, the limits and the metrics it
    reports."""

    def __init__(self, name: str, spec: dict, config: dict, traffic: dict,
                 limits: dict, end_to_end: list, per_layer: list):
        self.name, self.spec = name, spec
        self.config, self.traffic, self.limits = config, traffic, limits
        self.end_to_end, self.per_layer = end_to_end, per_layer
        self.arch = importlib.import_module(
            f"perfbench.reference.{config['reference']}")
        self.model = config["model"]
        self.specs = self.arch.param_specs(self.model)
        self.hp = ref_adamw.Hyper(**traffic["optimizer"])

    @classmethod
    def load(cls, name: str, bench: dict | None = None) -> "Cell":
        """The workload ``name`` of ``BENCHMARK.json``, its files found by
        the names it gives."""
        bench = bench or benchmark()
        by_name = {w["name"]: w for w in bench["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        spec = by_name[name]
        return cls(
            name, spec,
            load_json(HERE / "configs" / f"{spec['config']}.json"),
            load_json(HERE / "traffic" / f"{spec['traffic']}.json"),
            load_json(HERE / "limits" / f"{name}.json")["limits"],
            [m for m in bench["end_to_end"]
             if name in m.get("workloads", [name])],
            [m for m in bench["per_layer"]
             if name in m.get("workloads", [name])])

    def batches(self, seed: int, device, n: int = POOL) -> list:
        t = self.traffic
        return [{k: v.to(device) for k, v in tokens.batch(
            self.model["vocab"], t["batch"], t["seq"], seed, i).items()}
            for i in range(n)]

    def program(self, seed: int, device, batches: list, step_hook=None):
        """Set-up on the program: (its state after the first steps, the
        step, the readings of those steps)."""
        from repro_torch.launch.steps import make_train_step
        from repro_torch.launch.train import _grow_segments
        from repro_torch.models import ModelConfig, build
        from repro_torch.models.common import InitKey
        from repro_torch.optim import AdamWConfig, adamw_init

        if device.type == "cuda":
            _grow_segments()
        t0 = time.perf_counter()
        cfg = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in self.model.items()})
        model = build(cfg)
        params = place(model.init(InitKey.abstract()),
                       weights.draw(self.specs, seed, device))
        opt = adamw_init(params)
        _sync(device)
        log(f"weights and moments: {time.perf_counter() - t0:.3f} s")
        step = make_train_step(model,
                               AdamWConfig(**self.traffic["optimizer"]),
                               accum_steps=self.traffic["accum_steps"])
        if step_hook is not None:
            step = step_hook(step)
        got = {"loss": [], "gnorm": []}
        for t in range(FIRST):
            t0 = time.perf_counter()
            params, opt, met = step(params, opt, batches[t])
            got["loss"].append(float(met["loss"]))
            got["gnorm"].append(float(met["gnorm"]))
            log(f"first step {t + 1}: {time.perf_counter() - t0:.3f} s")
            if t == 0:
                # m = (1 - b1) g s after one step, s the clipping scale
                clip = min(1.0, self.hp.clip_norm
                           / max(got["gnorm"][0], 1e-9))
                scale = 1.0 / ((1.0 - self.hp.b1) * clip)
                moment = dict(flat_paths(opt["m"]))
                got["grad"] = leaf_norms(moment, scale)
                del moment
        t0 = time.perf_counter()
        flat = dict(flat_paths(params))
        got["delta"] = {}
        for path, spec in self.specs.items():
            before = weights.draw_one(spec, seed, path, device)
            got["delta"].update(change_norms({path: flat[path]},
                                             {path: before}))
            del before
        log(f"readings of the first steps: {time.perf_counter() - t0:.3f} s")
        return (params, opt), step, got

    def reference(self, seed: int, device, batches: list,
                  prec: str = "f32", note=None) -> dict:
        return follow(self.arch, self.model,
                      weights.draw(self.specs, seed, device),
                      batches[:FIRST], self.hp, prec, note)

    def tokens_per_step(self) -> int:
        return self.traffic["batch"] * self.traffic["seq"]


# ---------------------------------------------------------------- window
def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(step, box: list, batches, seconds: float, first: int, device):
    """Whole steps until ``seconds`` have passed, from a synchronised
    device to a synchronised device: (steps, seconds). ``box`` holds the
    state and is the only reference to it, so the state a step replaces
    is freed as the step ends."""
    _sync(device)
    t0 = time.perf_counter()
    n = 0
    while True:
        params, opt, _ = step(*box.pop(), batches[(first + n) % len(batches)])
        box.append((params, opt))
        del params, opt
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(device)
    return n, time.perf_counter() - t0


def profiled(step, box: list, batches, first: int, device):
    """``PROFILED`` steps under ``torch.profiler``'s CUDA activity, a
    marker kernel before the first and after each: (steps run, the
    ``devtrace.Trace``). On the card a trace with no kernel or without
    its markers raises: the traced run fails rather than report nothing.
    On the CPU: the steps, and a trace with nothing to read."""
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    mark = (lambda: torch.cuda._sleep(1)) if cuda else (lambda: None)
    _sync(device)
    with profile(activities=[ProfilerActivity.CUDA if cuda
                             else ProfilerActivity.CPU]) as prof:
        mark()
        for i in range(PROFILED):
            params, opt, _ = step(*box.pop(),
                                  batches[(first + i) % len(batches)])
            box.append((params, opt))
            del params, opt
            mark()
        _sync(device)
    tr = devtrace.Trace(devtrace.export_events(prof), PROFILED)
    if cuda:
        check_trace(tr)
    return PROFILED, tr


def check_trace(tr: "devtrace.Trace") -> None:
    """Raise where the profiler saw no kernel, or not the markers that
    bound the profiled steps."""
    if not tr.kernels or tr.window is None:
        raise RuntimeError(
            f"the profiler's trace holds {len(tr.kernels)} kernels and "
            f"{'no' if tr.window is None else 'its'} markers: nothing to "
            f"read the per-layer metrics from")


def _memory(device) -> tuple:
    if device.type != "cuda":
        return 0, 0
    return (torch.cuda.max_memory_allocated(device),
            torch.cuda.memory_stats(device).get("num_alloc_retries", 0))


def _power_limit() -> str | None:
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None,
             step_hook=None, cell: Cell | None = None) -> tuple:
    """One run of a cell: (the result line's object, the stderr lines of
    the compared numbers, last)."""
    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    cell = cell or Cell.load(name)
    batches = cell.batches(seed, dev)
    state, step, got = cell.program(seed, dev, batches, step_hook)
    setup_s = time.perf_counter() - t_start
    log(f"{name} seed {seed}: set-up {setup_s:.3f} s")

    peak_setup, _ = _memory(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _, retries0 = _memory(dev)
    box = [state]
    del state
    n, window_s = timed(step, box, batches, seconds, FIRST, dev)
    peak_window, retries1 = _memory(dev)
    ctx = types.SimpleNamespace(
        cuda=dev.type == "cuda", trace=None, timed_steps=n,
        timed_s=window_s,
        alloc_retries=retries1 - retries0, peak_bytes=peak_window,
        specs=cell.specs, model=cell.model, traffic=cell.traffic,
        yard=yardstick, tokens_per_step=cell.tokens_per_step())
    attempted = n
    if trace:
        ran, ctx.trace = profiled(step, box, batches, FIRST + n, dev)
        attempted += ran
        tr = ctx.trace
        phases = {}
        for p in tr.phase.values():
            phases[p[1]] = phases.get(p[1], 0) + 1
        log(f"profiled {ran} steps: {len(tr.kernels)} kernels, "
            f"{len(tr.ops)} device ops, phases {phases}, window "
            f"{None if tr.window is None else tr.window[1] - tr.window[0]} us")
    log(f"{name}: {n} steps in {window_s:.3f} s "
        f"({1e3 * window_s / n:.3f} ms a step)")
    peak = max(peak_setup, peak_window, _memory(dev)[0])

    del box, step
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = cell.reference(seed, dev, batches, note=log)
    values, where = compare.numbers(got, ref)
    log(f"reference {time.perf_counter() - t_ref:.3f} s; losses "
        f"{got['loss']} / {ref['loss']}; gradient norms {got['gnorm']} / "
        f"{ref['gnorm']}; worst leaves {where}; largest gaps (leaf, "
        f"program, reference): {compare.top_gaps(got, ref, 'grad')}")
    correct = compare.judge(values, cell.limits)

    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = metric_reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        given = {"step_ms": 1e3 * window_s / n, "setup_s": setup_s}
        metrics = {m["name"]: {"value": given[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": torch.cuda.get_device_name(dev)
                if dev.type == "cuda" else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": attempted, "failed": 0,
              "metrics": metrics, "device": dev_info}
    if trace and ctx.trace is not None and ctx.trace.window is not None:
        dev_info["busy_s"] = ctx.trace.busy_us() * 1e-6
        dev_info["window_s"] = (ctx.trace.window[1]
                                - ctx.trace.window[0]) * 1e-6
        result["breakdown"] = {"device_ops": ctx.trace.top_ops(),
                               "idle_gaps": ctx.trace.idle_by_host()}
    if dev.type == "cuda":
        dev_info["power_limit"] = _power_limit()
    log("every number: " + json.dumps(values))
    result["checks"] = {k: {"value": values[k], "limit": lim}
                        for k, lim in cell.limits.items()}
    lines = [f"check {k} {values[k]!r} limit {lim!r}"
             for k, lim in cell.limits.items()]
    return result, lines

"""Measurement harness for tuning survivors, on the card.

The counterpart of ``repro.tuning.measure``. Inputs are made on the card
from ``seed`` (a CUDA ``torch.Generator``), once per geometry, so every
candidate of a geometry is timed on the same work. A gather geometry
(``fused_layer``, ``csr_aggregate``) takes the neighbour and weight tables
it is given, as ``autotune.tune_plan`` gives it a served plan's own: the
padding slots a served graph holds change which launch is fastest. ``time_callable`` takes
CUDA events around each call after a warm-up, synchronises before it reads
them and reports the minimum of ``iters`` calls. The runners call the
port's kernel wrappers with the candidate's launch choice;
``crossbar_runner``, ``fused_runner``, ``aggregate_runner`` and
``cam_runner`` are the reference's names for them, each over
``make_inputs`` and ``make_runner``.

Measuring needs a CUDA device: no kernel runs on the CPU, so ``measure``
and ``measurer`` raise there (the tests inject a ``measure_fn``, as the
reference's do).
"""
from __future__ import annotations

import torch

from .._device import resolve_device


def time_callable(fn, iters: int = 3, warmup: int = 1) -> float:
    """Min seconds of ``fn()`` over ``iters`` calls, each between two CUDA
    events on the current stream, after ``warmup`` calls."""
    for _ in range(max(warmup, 1)):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(max(iters, 1)):
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return best


def cuda_device(device="cuda") -> torch.device:
    """``device`` as a CUDA device; raises on the CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"measuring a kernel needs a CUDA device, got "
                           f"{dev}: no kernel runs on the CPU")
    return dev


def make_inputs(geom, seed: int = 0, device="cuda", tables=None) -> dict:
    """The tensors one launch of ``geom`` takes, made on ``device`` from
    ``seed``. ``tables``: a gather geometry's (neighbors [nd, sample],
    weights [nd, sample]) to time on, in place of uniform random neighbours
    with every slot live."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def ints(high, *shape):
        return torch.randint(0, max(high, 1), shape, generator=gen,
                             device=dev, dtype=torch.int32)

    if geom.kernel in ("fused_layer", "csr_aggregate"):
        f = geom.f_in if geom.kernel == "fused_layer" else geom.f
        if tables is None:
            nbr = ints(geom.n, geom.nd, geom.sample)
            wts = normal(geom.nd, geom.sample).abs()
        else:
            nbr = torch.as_tensor(tables[0]).to(dev, torch.int32)
            wts = torch.as_tensor(tables[1]).to(dev, torch.float32)
            if nbr.shape != (geom.nd, geom.sample) or wts.shape != nbr.shape:
                raise ValueError(f"tables {tuple(nbr.shape)}, "
                                 f"{tuple(wts.shape)} are not those of "
                                 f"{geom.key()}")
        out = {"x": normal(geom.n, f), "nbr": nbr.contiguous(),
               "wts": wts.contiguous()}
        if geom.kernel == "fused_layer":
            out["w"] = normal(f, geom.f_out) * 0.05
            out["b"] = torch.zeros(geom.f_out, device=dev)
        return out
    if geom.kernel == "cam_match":
        return {"ci": ints(geom.e, geom.e), "queries": ints(geom.e, geom.q)}
    from ..kernels.crossbar_mvm import CrossbarNumerics
    from ..kernels.crossbar_mvm.ops import (Conductances, conductance_digits,
                                            digit_tiles)
    cfg = CrossbarNumerics(in_bits=geom.in_bits,
                           rows_per_xbar=geom.rows_per_xbar)
    wq = (ints(15, geom.k, geom.n) - 7).float()
    digits, kp = (digit_tiles(conductance_digits(wq, 1), cfg.rows_per_xbar)
                  if dev.type == "cuda" else (None, 0))
    return {"xq": ints(1 << geom.in_bits, geom.m, geom.k), "cfg": cfg,
            "codes": Conductances(wq, torch.ones((), device=dev), digits,
                                  kp)}


def make_runner(geom, config, inputs: dict):
    """() -> output of one launch of ``geom`` at ``config`` on
    ``inputs`` (``make_inputs``)."""
    if geom.kernel == "fused_layer":
        from ..kernels.crossbar_mvm import CrossbarNumerics
        from ..kernels.fused_layer import fused_gnn_layer
        cfg = (CrossbarNumerics(ideal=True) if geom.ideal
               else CrossbarNumerics(rows_per_xbar=geom.rows_per_xbar))
        i = inputs
        return lambda: fused_gnn_layer(i["x"], i["nbr"], i["wts"], i["w"],
                                       i["b"], cfg, relu=True, config=config)
    if geom.kernel == "csr_aggregate":
        from ..kernels.csr_aggregate.ops import csr_aggregate
        return lambda: csr_aggregate(inputs["x"], inputs["nbr"],
                                     inputs["wts"], config=config)
    if geom.kernel == "cam_match":
        from ..kernels.cam_match.ops import cam_search
        return lambda: cam_search(inputs["ci"], inputs["queries"],
                                  config=config)
    from ..kernels.crossbar_mvm.ops import crossbar_matmul_programmed
    return lambda: crossbar_matmul_programmed(
        inputs["xq"], inputs["codes"], inputs["cfg"], config=config)


def _runner(geom, config, seed: int, interpret, device):
    """``make_runner`` on ``make_inputs(geom, seed, device)``, the inputs
    kept on the runner (``run.inputs``). ``interpret`` is the reference's
    switch for its Pallas interpreter: the port has none (a CPU tensor
    runs the plain version), so it is taken and not read."""
    del interpret
    inputs = make_inputs(geom, seed, device)
    run = make_runner(geom, config, inputs)
    run.inputs = inputs
    return run


def crossbar_runner(geom, config, seed: int = 0,
                    interpret: bool | None = None, device="cuda"):
    """() -> y for one quantized crossbar MVM launch at ``config`` (the
    reference's name, over ``make_inputs`` / ``make_runner``)."""
    return _runner(geom, config, seed, interpret, device)


def fused_runner(geom, config, seed: int = 0, interpret: bool | None = None,
                 device="cuda"):
    """() -> h for one fused GNN-layer launch at ``config``."""
    return _runner(geom, config, seed, interpret, device)


def aggregate_runner(geom, config, seed: int = 0,
                     interpret: bool | None = None, device="cuda"):
    """() -> z for one standalone aggregation launch at ``config``."""
    return _runner(geom, config, seed, interpret, device)


def cam_runner(geom, config, seed: int = 0, interpret: bool | None = None,
               device="cuda"):
    """() -> (match, counts) for one CAM search launch at ``config``."""
    return _runner(geom, config, seed, interpret, device)


def measurer(seed: int = 0, iters: int = 3, warmup: int = 1,
             device="cuda", tables=None):
    """A ``measure_fn(geom, config) -> seconds`` that makes each
    geometry's inputs once (on ``tables``, see ``make_inputs``) and times
    every config on them."""
    dev = cuda_device(device)
    made: dict = {}

    def measure_fn(geom, config) -> float:
        if geom not in made:
            made.clear()                    # one geometry's inputs at a time
            made[geom] = make_inputs(geom, seed, dev, tables)
        return time_callable(make_runner(geom, config, made[geom]),
                             iters=iters, warmup=warmup)
    return measure_fn


def measure(geom, config, seed: int = 0, iters: int = 3, warmup: int = 1,
            device="cuda") -> float:
    """Seconds of one launch of ``geom`` at ``config`` on the card."""
    return measurer(seed, iters, warmup, device)(geom, config)

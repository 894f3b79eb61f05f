"""The tuning loop: enumerate -> roofline-prune -> measure -> cache.

The counterpart of ``repro.tuning.autotune``. ``tune`` decides one
(geometry, platform); ``tune_plan`` walks an ``ExecutionPlan``'s per-layer
kernel geometries and returns the ``TunedKernels`` bundle the plan threads
into its forwards, timing each gather geometry on the neighbour and weight
tables the plan serves at that shape. A candidate takes the default's
place only where it beats the default by more than the run-to-run spread
of its lead, timed in turns with the default for ``CONFIRM_ROUNDS`` more
rounds; the default stays otherwise. Winners are cached (``TuneCache``) keyed by (geometry,
platform); a cache hit skips measurement entirely.

Determinism contract (tests/test_torch_tuning.py): with a deterministic
``measure_fn``, the winner, the cache record and the serialized cache bytes
are pure functions of (geometry, platform, seed). With the real timer the
candidate set is still deterministic (roofline arithmetic); only the
measured ranking depends on the card.
"""
from __future__ import annotations

from .._device import resolve_device
from ..analysis.roofline import H100, HW
from . import registry
from .cache import TuneCache
from .measure import measurer
from .prune import prune
from .space import (AggregateGeometry, FusedGeometry, TunedKernels,
                    default_config)

CONFIRM_ROUNDS = 2      # rounds of the default and the fastest, in turns


def current_platform(device="cuda") -> str:
    """Cache/registry platform tag: ``cuda:<device name>`` for a CUDA
    device, ``cpu`` otherwise."""
    import torch
    dev = resolve_device(device)
    if dev.type == "cuda":
        return "cuda:" + torch.cuda.get_device_name(dev)
    return "cpu"


def tune(geom, *, cache: TuneCache | None = None, hw: HW = H100,
         seed: int = 0, iters: int = 3, warmup: int = 1,
         slack: float = 2.0, max_survivors: int = 4,
         measure_fn=None, force: bool = False,
         register_result: bool = True, device="cuda", tables=None):
    """Decide the launch choice of one kernel geometry on ``device``.

    Returns ``(config, info)``; ``info`` records whether the cache
    answered (``cached``), the deterministic survivor list with roofline
    bounds, and — when measurement ran — per-survivor seconds including
    the default's (``default_s`` / ``winner_s``, the least of each one's
    timings), the spread of the fastest's lead that it had to beat
    (``spread_s``), the sweep's fastest (``fastest``) with its mean lead
    (``lead_s``), and the timings made (``n_timed``). Without
    ``measure_fn`` the survivors are timed on the card
    (``measure.measurer``, on ``tables`` where given)."""
    platform = current_platform(device)
    info = {"platform": platform, "cached": False}
    if cache is not None and not force:
        hit = cache.get(geom, platform)
        if hit is not None:
            if register_result:
                registry.register(geom.key(), hit)
            info["cached"] = True
            return hit, info

    survivors = prune(geom, hw=hw, slack=slack, max_survivors=max_survivors)
    info["survivors"] = [(c.as_dict(), b) for c, b in survivors]
    measure_fn = measure_fn or measurer(seed=seed, iters=iters,
                                        warmup=warmup, device=device,
                                        tables=tables)
    timed = [(measure_fn(geom, c), c, b) for c, b in survivors]
    # fastest, ties broken by config order so reruns agree
    t_win, winner, bound = min(timed, key=lambda r: (r[0], r[1]))
    fastest, lead = winner, 0.0
    default = default_config(geom)
    t_default, _, b_default = next(r for r in timed if r[1] == default)
    spread, n_timed = 0.0, len(timed)
    if winner != default:
        # the default and the fastest again, in turns, for CONFIRM_ROUNDS
        # more rounds: the fastest takes the default's place only where its
        # lead, paired round by round, is on average larger than the lead's
        # spread across the rounds (max - min), which also makes every
        # round's lead positive
        t_d, t_w = [t_default], [t_win]
        for _ in range(CONFIRM_ROUNDS):
            t_d.append(measure_fn(geom, default))
            t_w.append(measure_fn(geom, winner))
        n_timed += 2 * CONFIRM_ROUNDS
        leads = [d - w for d, w in zip(t_d, t_w)]
        spread, lead = max(leads) - min(leads), sum(leads) / len(leads)
        t_default, t_win = min(t_d), min(t_w)
        if lead <= spread:
            t_win, winner, bound = t_default, default, b_default
    info.update(winner_s=t_win, default_s=t_default, fastest=fastest,
                lead_s=lead, spread_s=spread,
                measured=[(c.as_dict(), t) for t, c, _ in timed],
                n_candidates=len(survivors), n_timed=n_timed)
    if cache is not None:
        cache.put(geom, platform, winner, bound_s=bound,
                  measured_s=round(t_win, 6), default_s=round(t_default, 6),
                  n_measured=len(timed), seed=seed,
                  fastest=fastest.as_dict(), lead_s=round(lead, 9),
                  spread_s=round(spread, 9))
        if cache.path is not None:
            cache.save()
    if register_result:
        registry.register(geom.key(), winner)
    return winner, info


def plan_tables(plan) -> dict:
    """The launch shapes of an ExecutionPlan's forward, ``(rows, table
    rows, sample) -> (neighbors, weights)`` of the first cluster the plan
    serves at that shape: the tables the tuner times the shape on. One
    shape for a dense plan (owned plus halo rows on distributed settings);
    one per distinct capacity bucket, in order, for a bucketed plan."""
    if getattr(plan, "bucketed", None) is not None:
        bp = plan.bucketed
        found: dict = {}
        for b in range(bp.n_buckets):
            key = (int(bp.n_caps[b]), int(bp.n_caps[b] + bp.h_caps[b]),
                   int(bp.s_caps[b]))
            found.setdefault(key, (plan.neighbors[b][0], plan.weights[b][0]))
        return {key: found[key] for key in sorted(found)}
    nd, s = (int(v) for v in plan.neighbors.shape[-2:])
    # gather table rows: owned + halo rows on distributed settings
    n = nd + (int(plan.part.h_max) if plan.part is not None else 0)
    return {(nd, n, int(plan.sample)): (plan.neighbors.reshape(-1, nd, s)[0],
                                        plan.weights.reshape(-1, nd, s)[0])}


def plan_geometries(plan, cfg) -> list:
    """Per-layer kernel geometries an ExecutionPlan's forward launches.

    ``fused`` launches the fused GNN-layer kernels, composed ``pallas``
    the standalone aggregation kernel (its crossbar stage is the plain
    version); ``jnp`` launches no kernel, so it tunes nothing — an empty
    bundle, not an error. Bucketed plans launch one kernel shape per
    capacity bucket, so every distinct (rows, table, width) triple gets
    its own geometry."""
    if cfg.backend not in ("fused", "pallas"):
        return []
    dims = cfg.dims
    geoms = []
    for nd, n, s in plan_tables(plan):
        for f_in, f_out in zip(dims[:-1], dims[1:]):
            if cfg.backend == "fused":
                geoms.append(FusedGeometry(
                    nd=nd, n=n, f_in=int(f_in), f_out=int(f_out), sample=s,
                    ideal=bool(cfg.numerics.ideal),
                    rows_per_xbar=int(cfg.numerics.rows_per_xbar)))
            else:
                geoms.append(AggregateGeometry(nd=nd, n=n, f=int(f_in),
                                               sample=s))
    return geoms


def tune_plan(plan, cfg, *, cache: TuneCache | None = None,
              **tune_kw) -> TunedKernels:
    """Tune every kernel geometry of one plan on the tables the plan
    serves (``plan_tables``); returns the TunedKernels bundle (also
    registered process-wide and cached when ``cache``)."""
    tables = plan_tables(plan)
    mapping = {}
    for geom in plan_geometries(plan, cfg):
        key = geom.key()
        if key in mapping:
            continue
        config, _ = tune(geom, cache=cache,
                         tables=tables[(geom.nd, geom.n, geom.sample)],
                         **tune_kw)
        mapping[key] = config
    return TunedKernels.of(mapping)

"""Decentralized and two-tier semi-decentralized GNN runtimes.

The counterpart of ``repro.distributed.halo``. One cluster per edge
device; each layer needs the remote neighbor rows of its cluster (the
paper's e_ij), exchanged in either strategy:

  * ``allgather`` — every device gathers all owned tables and picks its
    halo rows out of them.
  * ``alltoall``  — each device sends only the rows its peers need (send
    lists); the received rows are scattered into the halo table: the
    same tables the wire traffic is billed on.

Both give identical halos, on both runtimes:

  * the SPMD runtime (``make_decentralized_forward``,
    ``make_semi_forward``): one process per cluster on a
    ``launch.mesh.Mesh``, each holding only its own cluster's tables; the
    exchange is ``torch.distributed`` collectives (``all_gather``,
    ``all_to_all_single``) and the output is all-gathered to the full
    ``[K, n_max, out]`` on every rank, as JAX assembles its global array.
  * the emulated runtime: the clusters lie along a leading axis of one
    tensor on one device and the exchange is gathers over that axis; the
    single-process oracle, and the runtime when no mesh of ``K`` ranks
    is given.

The **semi** setting adds tier 0, the spoke->head gather that assembles
each region's table from its spokes (local to a head's process in SPMD),
and runs tier 1 as the decentralized exchange over the region partition.

The capacity-bucketed layout (``core.partition.BucketedPartition``) runs
one layer step per bucket over ``[K_b, n_cap + h_cap]`` tables; its halo
rows come from one gather per bucket out of a flat table of every
bucket's owned rows (``BucketedHaloPlan``). ``overlap="overlap"`` issues
every bucket's gather of a layer on a side CUDA stream before any bucket's
step, so the gathers run under the steps; ``"serial"`` interleaves them on
the current stream. Both give the same values.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from .. import telemetry as tel
from .._device import resolve_device
from ..core.gnn import layer_step as _layer_step
from ..core.partition import (BucketedPartition, HierPartition, Partition,
                              halo_exchange_tables)

EXCHANGE_MODES = ("allgather", "alltoall")
OVERLAP_MODES = ("overlap", "serial")


@dataclasses.dataclass
class HaloPlan:
    """Static exchange plan derived from a Partition (numpy, host-side)."""
    src_cluster: np.ndarray    # [K, h_max] owner cluster of each halo row
    src_slot: np.ndarray       # [K, h_max] owner-local slot
    halo_mask: np.ndarray      # [K, h_max] bool
    send_slot: np.ndarray      # [K, K, s_max] rows device k sends to peer j
    send_mask: np.ndarray      # [K, K, s_max] bool
    recv_to_halo: np.ndarray   # [K, K, s_max] halo row filled by recv (or 0)
    recv_mask: np.ndarray      # [K, K, s_max] bool

    @property
    def s_max(self) -> int:
        return self.send_slot.shape[2]


def build_halo_plan(part: Partition) -> HaloPlan:
    src_c, src_s, mask = halo_exchange_tables(part)
    k, h_max = src_c.shape
    # send lists: sends[c][j] = local slots of c needed by j
    sends = [[[] for _ in range(k)] for _ in range(k)]
    recv_halo = [[[] for _ in range(k)] for _ in range(k)]
    for c in range(k):
        for h in range(h_max):
            if mask[c, h]:
                owner = int(src_c[c, h])
                sends[owner][c].append(int(src_s[c, h]))
                recv_halo[c][owner].append(h)
    s_max = max(max((len(s) for row in sends for s in row), default=0), 1)
    send_slot = np.zeros((k, k, s_max), np.int32)
    send_mask = np.zeros((k, k, s_max), bool)
    recv_to_halo = np.zeros((k, k, s_max), np.int32)
    recv_mask = np.zeros((k, k, s_max), bool)
    for c in range(k):
        for j in range(k):
            s = sends[c][j]
            send_slot[c, j, :len(s)] = s
            send_mask[c, j, :len(s)] = True
            r = recv_halo[c][j]
            recv_to_halo[c, j, :len(r)] = r
            recv_mask[c, j, :len(r)] = True
    return HaloPlan(src_c, src_s, mask, send_slot, send_mask,
                    recv_to_halo, recv_mask)


def _plan_consts(plan: HaloPlan, device, rank: int | None = None) -> dict:
    """The plan's tables on ``device``: indices as int64, masks as
    float32 multipliers. With ``rank``, only that cluster's rows
    (shard_map's local block with its leading axis stripped)."""
    def pick(a, dtype):
        a = a if rank is None else np.ascontiguousarray(a[rank])
        return torch.as_tensor(a, dtype=dtype, device=device)
    idx, msk = torch.int64, torch.float32
    return dict(src_c=pick(plan.src_cluster, idx),
                src_s=pick(plan.src_slot, idx),
                hmask=pick(plan.halo_mask, msk),
                send_slot=pick(plan.send_slot, idx),
                send_mask=pick(plan.send_mask, msk),
                recv_to_halo=pick(plan.recv_to_halo, idx),
                recv_mask=pick(plan.recv_mask, msk))


def _all_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """``[K, *x.shape]``: every rank's ``x`` in rank order (the list form
    of ``all_gather``, which gloo takes for CPU and CUDA tensors)."""
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    return torch.stack(parts)


def _exchange_allgather(x_own, src_c, src_s, mask, mesh) -> torch.Tensor:
    full = _all_gather(x_own, mesh)                   # [K, n_max, F]
    return full[src_c, src_s] * mask[:, None]


def _exchange_alltoall(x_own, send_slot, send_mask, recv_to_halo, recv_mask,
                       h_max: int, mesh) -> torch.Tensor:
    """``all_to_all_single`` on the contiguous ``[K, s_max, F]`` send
    block gives ``recv[j] = peer j's send[me]``, JAX's ``all_to_all``
    with ``split_axis=concat_axis=0``. The received rows are added into
    the halo as ``_emulated_exchange`` adds them: padding slots add exact
    zeros to row 0, so the result does not depend on the order."""
    send = (x_own[send_slot] * send_mask[..., None]).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.group)
    f = x_own.shape[-1]
    halo = torch.zeros((h_max, f), dtype=x_own.dtype, device=x_own.device)
    halo.index_put_((recv_to_halo.reshape(-1),),
                    (recv * recv_mask[..., None]).reshape(-1, f),
                    accumulate=True)
    return halo


def _spmd_layers(params, x, nbr, wts, cfg, t, mode, h_max, mesh,
                 levels: list | None = None) -> torch.Tensor:
    """Per-rank layer loop shared by the decentralized and semi SPMD
    forwards (and the streaming engine's full refresh). ``t``: this rank's
    exchange tables. With ``levels``, each layer's output is also
    all-gathered into it as ``[K, n_max, F_l]``.

    With telemetry on, each layer's exchange is a ``halo.collective`` span
    (closed by a device sync) carrying the bytes this rank sent to its
    peers, and its layer step a ``halo.mvm`` span."""
    tracer = tel.get_tracer()
    n_layers = len(params)
    for i, layer in enumerate(params):
        with tracer.span("halo.collective", layer=i, mode=mode) as sp:
            if mode == "allgather":
                halo = _exchange_allgather(x, t["src_c"], t["src_s"],
                                           t["hmask"], mesh)
                rows = x.shape[0]
            else:
                halo = _exchange_alltoall(x, t["send_slot"], t["send_mask"],
                                          t["recv_to_halo"], t["recv_mask"],
                                          h_max, mesh)
                rows = t["send_slot"].shape[-1]
            sp.add_bytes((mesh.size - 1) * rows * x.shape[-1]
                         * x.element_size())
            tracer.device_sync(halo, name="halo.collective.sync")
        table = torch.cat([x, halo], dim=0)              # [n_max+h_max, F]
        act = i < n_layers - 1 or cfg.final_activation
        with tracer.span("halo.mvm", layer=i):
            x = _layer_step(table, nbr, wts, layer, cfg, act)
            tracer.device_sync(x, name="halo.mvm.sync")
        if levels is not None:
            levels.append(_all_gather(x, mesh))
    return x


def _gather_output(x: torch.Tensor, mesh) -> torch.Tensor:
    """The full ``[K, n_max, out]`` on every rank from each rank's
    ``[n_max, out]``."""
    tracer = tel.get_tracer()
    with tracer.span("halo.output_gather") as sp:
        out = _all_gather(x, mesh)
        sp.add_bytes((mesh.size - 1) * x.numel() * x.element_size())
        tracer.device_sync(out, name="halo.output_gather.sync")
    return out


def _check_mesh(mesh, axis: str, k: int) -> None:
    if axis != mesh.axis:
        raise ValueError(f"axis {axis!r} is not the mesh's {mesh.axis!r}")
    if mesh.size != k:
        raise ValueError(f"{k} clusters on a mesh of {mesh.size} ranks: the "
                         f"SPMD runtime runs one cluster a rank")


def make_decentralized_forward(mesh, cfg, plan: HaloPlan, n_max: int,
                               mode: str = "alltoall", axis: str = "data"):
    """The SPMD decentralized GNN forward on ``mesh`` (one cluster a
    rank, this process's cluster being ``mesh.rank``).

    Inputs, this rank's shard on ``mesh.device``:
      feats   [n_max, F_in]   owned node features
      nbr/wts [n_max, S]      the cluster's padded subgraph
    Returns the full [K, n_max, out_dim] on every rank."""
    if mode not in EXCHANGE_MODES:
        raise ValueError(f"unknown exchange mode {mode!r}")
    _check_mesh(mesh, axis, plan.src_cluster.shape[0])
    h_max = plan.src_cluster.shape[1]
    t = _plan_consts(plan, mesh.device, mesh.rank)

    @torch.no_grad()
    def forward(params, feats, nbr, wts):
        if feats.shape[0] != n_max:
            raise ValueError(f"feats hold {feats.shape[0]} rows, the plan "
                             f"{n_max}")
        x = _spmd_layers(params, feats, nbr, wts, cfg, t, mode, h_max, mesh)
        return _gather_output(x, mesh)

    return forward


def _emulated_exchange(x: torch.Tensor, t: dict, mode: str,
                       h_max: int) -> torch.Tensor:
    """Halo exchange across the leading cluster axis of x [K, n_max, F].
    Returns the halos [K, h_max, F]; both modes give the same values.

    The alltoall scatter adds into the halo table with
    ``index_put_(..., accumulate=True)``: each real halo row receives one
    row, and every padding slot adds an exact zero (to row 0), so the
    result does not depend on the order of the adds."""
    if mode == "allgather":
        return x[t["src_c"], t["src_s"]] * t["hmask"][..., None]
    k = x.shape[0]
    dev = torch.arange(k, device=x.device)[:, None, None]
    send = x[dev, t["send_slot"]] * t["send_mask"][..., None]  # [K,K,s,F]
    recv = send.transpose(0, 1)               # recv[c, j] = send[j, c]
    halo = torch.zeros((k, h_max, x.shape[-1]), dtype=x.dtype,
                       device=x.device)
    rows = t["recv_to_halo"]
    halo.index_put_((dev.expand_as(rows), rows),
                    recv * t["recv_mask"][..., None], accumulate=True)
    return halo


def _emulated_layers(params, x, nbr, wts, cfg, t, mode, h_max):
    k = x.shape[0]
    n_layers = len(params)
    for i, layer in enumerate(params):
        halo = _emulated_exchange(x, t, mode, h_max)     # [K, h_max, F]
        table = torch.cat([x, halo], dim=1)              # [K, n+h, F]
        act = i < n_layers - 1 or cfg.final_activation
        x = torch.stack([
            _layer_step(table[c], nbr[c], wts[c], layer, cfg, act)
            for c in range(k)])
    return x


def make_emulated_forward(cfg, plan: HaloPlan, mode: str = "allgather",
                          device="cuda"):
    """Decentralized forward with the exchange emulated over the leading
    cluster axis on one device.

    feats/nbr/wts: [K, n_max, {F,S}] tensors on ``device``.
    Returns ``fn(params, feats, nbr, wts) -> [K, n_max, out_dim]``."""
    if mode not in EXCHANGE_MODES:
        raise ValueError(f"unknown exchange mode {mode!r}")
    h_max = plan.src_cluster.shape[1]
    consts = _plan_consts(plan, device)

    @torch.no_grad()
    def forward(params, feats, nbr, wts):
        return _emulated_layers(params, feats, nbr, wts, cfg, consts, mode,
                                h_max)

    return forward


@dataclasses.dataclass
class TwoTierPlan:
    """Static two-tier semi-decentralized exchange plan.

    ``region`` drives the tier-1 head<->head halo; the gather tables drive
    the tier-0 spoke->head assembly of each region's feature table.
    """
    region: HaloPlan
    gather_spoke: np.ndarray   # [R, n_max] spoke owning each region row
    gather_slot: np.ndarray    # [R, n_max] slot in that spoke's table
    gather_mask: np.ndarray    # [R, n_max] bool (valid region rows)
    n_max: int

    @property
    def h_max(self) -> int:
        return self.region.src_cluster.shape[1]


def build_two_tier_plan(hier: HierPartition) -> TwoTierPlan:
    return TwoTierPlan(build_halo_plan(hier.region), hier.gather_spoke,
                       hier.gather_slot, hier.region.local_mask,
                       hier.region.n_max)


def _tier0_consts(plan: TwoTierPlan, device,
                  rank: int | None = None) -> dict:
    """The tier-0 spoke->head gather tables on ``device`` (with ``rank``,
    only that region's row)."""
    def pick(a, dtype):
        a = a if rank is None else np.ascontiguousarray(a[rank])
        return torch.as_tensor(a, dtype=dtype, device=device)
    return dict(gspoke=pick(plan.gather_spoke, torch.int64),
                gslot=pick(plan.gather_slot, torch.int64),
                gmask=pick(plan.gather_mask, torch.float32))


def make_emulated_semi_forward(cfg, plan: TwoTierPlan,
                               mode: str = "allgather", device="cuda"):
    """Two-tier semi forward on one device: the tier-0 gather, then the
    tier-1 exchange of ``make_emulated_forward`` over the regions.

    spoke_feats: [R, P, m_max, F]; nbr/wts: [R, n_max, S] region-local.
    Returns ``fn(params, spoke_feats, nbr, wts) -> [R, n_max, out_dim]``."""
    if mode not in EXCHANGE_MODES:
        raise ValueError(f"unknown exchange mode {mode!r}")
    h_max = plan.h_max
    t0 = _tier0_consts(plan, device)
    consts = _plan_consts(plan.region, device)

    @torch.no_grad()
    def forward(params, spoke_feats, nbr, wts):
        r = spoke_feats.shape[0]
        heads = torch.arange(r, device=spoke_feats.device)[:, None]
        x = (spoke_feats[heads, t0["gspoke"], t0["gslot"]]
             * t0["gmask"][..., None])                 # tier 0: [R, n_max, F]
        return _emulated_layers(params, x, nbr, wts, cfg, consts, mode,
                                h_max)

    return forward


def make_semi_forward(mesh, cfg, plan: TwoTierPlan,
                      mode: str = "alltoall", axis: str = "data"):
    """The SPMD two-tier semi-decentralized forward on ``mesh`` (one
    region head a rank).

    Inputs, this rank's shard on ``mesh.device``:
      spoke_feats [P, m_max, F_in]  the region's spoke tables
      nbr/wts     [n_max, S]        the region's padded subgraph
    Tier 0 assembles the head's region table from its spokes in the
    head's own process (the access-link upload is billed by the traffic
    accountant, not moved over the mesh); tier 1 runs the per-layer
    head<->head exchange. Returns the full [R, n_max, out_dim] on every
    rank."""
    if mode not in EXCHANGE_MODES:
        raise ValueError(f"unknown exchange mode {mode!r}")
    _check_mesh(mesh, axis, plan.region.src_cluster.shape[0])
    h_max = plan.h_max
    t0 = _tier0_consts(plan, mesh.device, mesh.rank)
    t = _plan_consts(plan.region, mesh.device, mesh.rank)

    @torch.no_grad()
    def forward(params, spoke_feats, nbr, wts):
        x = (spoke_feats[t0["gspoke"], t0["gslot"]]
             * t0["gmask"][:, None])                    # tier 0: [n_max, F]
        x = _spmd_layers(params, x, nbr, wts, cfg, t, mode, h_max, mesh)
        return _gather_output(x, mesh)

    return forward


@dataclasses.dataclass
class BucketedHaloPlan:
    """Static exchange plan for the capacity-bucketed layout.

    The exchange is ONE gather per destination bucket out of a *flat*
    table concatenating every bucket's owned rows (``cluster_offset[c] =
    bucket base + index_in[c] * n_cap``): ragged per-bucket shapes stay out
    of the gather indices, and each bucket's fetch is an independent
    launch that can run under another bucket's layer step. Wire-level
    billing stays on the dense partition's send/recv tables; this plan
    only moves values.
    """
    flat_src: tuple       # per bucket [K_b, h_cap] int32 into the flat table
    halo_mask: tuple      # per bucket [K_b, h_cap] float32
    n_caps: tuple
    h_caps: tuple
    flat_rows: int        # total rows of the concatenated owned table

    @property
    def n_buckets(self) -> int:
        return len(self.flat_src)


def build_bucketed_halo_plan(bpart: BucketedPartition) -> BucketedHaloPlan:
    part = bpart.part
    src_c, src_s, mask = halo_exchange_tables(part)
    offset = np.zeros(part.n_clusters, np.int64)
    base = 0
    for b, cl in enumerate(bpart.clusters):
        for j, c in enumerate(cl):
            offset[c] = base + j * bpart.n_caps[b]
        base += len(cl) * bpart.n_caps[b]
    hcount = mask.sum(axis=1)
    fsrc, fmask = [], []
    for b, cl in enumerate(bpart.clusters):
        hc = bpart.h_caps[b]
        fs = np.zeros((len(cl), hc), np.int32)
        fm = np.zeros((len(cl), hc), np.float32)
        for j, c in enumerate(cl):
            h = int(hcount[c])
            fs[j, :h] = offset[src_c[c, :h]] + src_s[c, :h]
            fm[j, :h] = 1.0
        fsrc.append(fs)
        fmask.append(fm)
    return BucketedHaloPlan(tuple(fsrc), tuple(fmask), bpart.n_caps,
                            bpart.h_caps, base)


def _flat_rows(xs) -> torch.Tensor:
    """Concatenate per-bucket owned tables [K_b, n_cap, F] into the flat
    [sum(K_b * n_cap), F] table the bucketed halo gathers index."""
    return torch.cat([x.reshape(-1, x.shape[-1]) for x in xs], dim=0)


def _gather_halo(flat, idx, mask) -> torch.Tensor:
    """One bucket's halo fetch: [.., h_cap, F] rows out of the flat table,
    padding rows masked to zero."""
    return flat[idx] * mask[..., None]


def _bucket_layer(x, halo, nbr, wts, layer, cfg, act) -> torch.Tensor:
    """One GNN layer over one bucket [K_b, n_cap(+h_cap), ...]: the layer
    step once for each cluster of the bucket, so that every DAC scale of
    the bit-accurate numerics stays per cluster, as on the dense path."""
    table = torch.cat([x, halo], dim=1)
    return torch.stack([
        _layer_step(table[c], nbr[c], wts[c], layer, cfg, act)
        for c in range(x.shape[0])])


def make_emulated_bucketed_forward(cfg, bplan: BucketedHaloPlan,
                                   mode: str = "alltoall",
                                   overlap: str = "overlap", device="cuda"):
    """Decentralized forward over the bucketed ragged layout, on one
    device.

    feats/nbr/wts: tuples of per-bucket [K_b, n_cap, {F, s_cap}] tensors.
    Returns a tuple of per-bucket [K_b, n_cap, out_dim] tensors.

    ``mode`` is accepted for symmetry with the dense runtimes: both
    exchange strategies give identical halo *values*, and the bucketed
    plan realizes them with the same flat gather — the allgather/alltoall
    distinction lives in the billing of the dense send/recv tables.
    ``overlap="overlap"`` issues every bucket's halo gather of a layer on a
    side CUDA stream, once the flat table is made, before any bucket's
    layer step; each step waits only on its own bucket's gather (an
    event). ``"serial"`` interleaves gather -> step per bucket on the
    current stream. On the CPU both run in order. Same values either way.
    """
    if mode not in EXCHANGE_MODES:
        raise ValueError(f"unknown exchange mode {mode!r}")
    if overlap not in OVERLAP_MODES:
        raise ValueError(f"unknown overlap mode {overlap!r}; choose from "
                         f"{OVERLAP_MODES}")
    dev = resolve_device(device)
    fidx = tuple(torch.as_tensor(i, dtype=torch.int64, device=dev)
                 for i in bplan.flat_src)
    fmask = tuple(torch.as_tensor(m, device=dev) for m in bplan.halo_mask)
    nb = bplan.n_buckets
    side = (torch.cuda.Stream(device=dev)
            if overlap == "overlap" and dev.type == "cuda" else None)

    def gathers_on_side(flat, tracer, layer):
        """Every bucket's halo on the side stream, after ``flat`` is made;
        returns (halos, events recorded after each gather)."""
        main = torch.cuda.current_stream(dev)
        side.wait_stream(main)
        halos, done = [], []
        with torch.cuda.stream(side):
            for b in range(nb):
                with tracer.span("halo.gather", layer=layer, bucket=b):
                    halos.append(_gather_halo(flat, fidx[b], fmask[b]))
                done.append(torch.cuda.Event())
                done[-1].record(side)
        flat.record_stream(side)      # read on the side stream
        for h in halos:
            h.record_stream(main)     # made on the side, read on main
        return halos, done

    @torch.no_grad()
    def forward(params, feats, nbrs, wtss):
        # Spans here time the launches (the loop runs ahead of the device);
        # telemetry's device_sync closes each layer only when tracing is
        # enabled, so the overlap schedule is untouched when it is off.
        # Disabled spans are shared no-op singletons.
        tracer = tel.get_tracer()
        xs = list(feats)
        n_layers = len(params)
        for i, layer in enumerate(params):
            act = i < n_layers - 1 or cfg.final_activation
            flat = _flat_rows(xs)
            if overlap == "overlap":
                if side is not None:
                    halos, done = gathers_on_side(flat, tracer, i)
                else:
                    halos = []
                    for b in range(nb):
                        with tracer.span("halo.gather", layer=i, bucket=b):
                            halos.append(_gather_halo(flat, fidx[b],
                                                      fmask[b]))
                xs_next = []
                for b in range(nb):
                    if side is not None:
                        torch.cuda.current_stream(dev).wait_event(done[b])
                    with tracer.span("halo.mvm", layer=i, bucket=b):
                        xs_next.append(_bucket_layer(
                            xs[b], halos[b], nbrs[b], wtss[b], layer, cfg,
                            act))
                xs = xs_next
            else:
                for b in range(nb):
                    with tracer.span("halo.gather", layer=i, bucket=b):
                        halo = _gather_halo(flat, fidx[b], fmask[b])
                    with tracer.span("halo.mvm", layer=i, bucket=b):
                        xs[b] = _bucket_layer(xs[b], halo, nbrs[b], wtss[b],
                                              layer, cfg, act)
            tracer.device_sync(xs, name="halo.layer_sync")
        return tuple(xs)

    return forward


def make_emulated_bucketed_semi_forward(cfg, bplan: BucketedHaloPlan,
                                        hier: HierPartition,
                                        bpart: BucketedPartition,
                                        mode: str = "alltoall",
                                        overlap: str = "overlap",
                                        device="cuda"):
    """Two-tier semi forward over the bucketed layout: the tier-0
    spoke->head gather assembles each bucket's region tables straight from
    the (dense) spoke tables, then the bucketed tier-1 runtime takes over.

    spoke_feats: [R, P, m_max, F]; nbr/wts: per-bucket tuples.
    Returns a tuple of per-bucket [K_b, n_cap, out_dim] tensors.
    """
    dev = resolve_device(device)
    t0 = []
    n_max = hier.region.n_max
    for b, cl in enumerate(bpart.clusters):
        ncap = bplan.n_caps[b]
        w = min(ncap, n_max)
        gs = np.zeros((len(cl), ncap), np.int64)
        sl = np.zeros((len(cl), ncap), np.int64)
        gm = np.zeros((len(cl), ncap), np.float32)
        gs[:, :w] = hier.gather_spoke[cl, :w]
        sl[:, :w] = hier.gather_slot[cl, :w]
        gm[:, :w] = hier.region.local_mask[cl, :w]
        t0.append(tuple(torch.as_tensor(a, device=dev) for a in
                        (np.asarray(cl, np.int64), gs, sl, gm)))
    inner = make_emulated_bucketed_forward(cfg, bplan, mode=mode,
                                           overlap=overlap, device=dev)

    @torch.no_grad()
    def forward(params, spoke_feats, nbrs, wtss):
        with tel.get_tracer().span("halo.tier0_gather", buckets=len(t0)):
            feats = tuple(spoke_feats[cids[:, None], gs, sl] * gm[..., None]
                          for cids, gs, sl, gm in t0)
        return inner(params, feats, nbrs, wtss)

    return forward

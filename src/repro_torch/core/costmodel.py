"""IMA-GNN network model (paper §3, Eqs. 1-7) — latency & power of centralized,

A copy of ``repro.core.costmodel`` (plain Python), so that the port
needs nothing of the JAX package. It prices the paper's modeled
in-memory edge devices, not the card the port runs on.
decentralized, and (beyond-paper) semi-decentralized GNN execution.

The paper composes its numbers bottom-up: HSPICE/NVSIM-CAM/MNSIM extract
per-core latency/power primitives, and a MATLAB network model applies
Eqs. 1-7. This module replaces that MATLAB layer 1:1. The per-core
primitives are *calibrated to the paper's own Table 1* (the circuit-level
stack has no counterpart on a GPU either — see DESIGN.md §2), and the link constants are
calibrated so that both Table 1's taxi numbers and the two headline averages
(~790x communication, ~1400x computation) are reproduced from first
principles rather than hard-coded.

Calibration (derivations in EXPERIMENTS.md §Paper-validation):
  * Core multiplicities  M = (2000, 1000, 256)  — the centralized setting has
    2Kx(512x32) CAM, 1Kx(512x512) MVM, 256x(128x128) MVM crossbars vs one of
    each per decentralized node (paper §4.1), i.e. M_i = #crossbars.
  * Per-node core latencies t = Table-1 centralized values inverted through
    Eq. 3 with N = 10 000: t_i = T_cent_i / (N-1) * M_i.
  * Link model: t(L_n) = 3.3 ms (V2X, 864-byte packet — paper §4.2);
    t(L_c), t_e solved from {Table-1 decentralized comm = 406 ms with c_s=10}
    and {4-dataset mean centralized comm speed-up = 790x}:
    t(L_c) = 18.496 ms, t_e = 18.04 ms.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal

from .graph import GraphStats, TAXI_STATS, TABLE2_DATASETS

Setting = Literal["centralized", "decentralized", "semi"]


@dataclasses.dataclass(frozen=True)
class HardwareParams:
    """Calibrated IMA-GNN hardware model parameters."""
    # centralized-core crossbar multiplicities (M1, M2, M3), paper §3
    m1: float = 2000.0
    m2: float = 1000.0
    m3: float = 256.0
    # per-node, per-inference core latencies [s] for the calibration workload
    # (taxi: S<=512 sampled neighbors, 216-dim features)
    t1: float = 38.43e-9 / 9999 * 2000    # traversal   = 7.687 ns
    t2: float = 142.77e-6 / 9999 * 1000   # aggregation = 14.278 us
    t3: float = 14.53e-6 / 9999 * 256     # feat. extr. = 0.372 us
    # core power draws [W] (Table 1)
    p_cores_cent: tuple = (10.8e-3, 780.1e-3, 32.21e-3)
    p_cores_dec: tuple = (0.21e-3, 41.6e-3, 3.68e-3)
    # link model [s] / [W] / [J/bit]
    t_ln: float = 3.3e-3       # inter-network (V2X) one concurrent transfer
    t_lc: float = 18.496e-3    # inter-cluster ad-hoc hop latency
    t_e: float = 18.04e-3      # peer connection establishment
    p_ln: float = 100e-3       # inter-network link power
    e_per_bit: float = 50e-9   # ad-hoc radio energy per bit (Eq. 7)
    # crossbar geometry (paper §4.1), used by the workload-scaled mode
    cam_rows: int = 512
    cam_cols: int = 32
    agg_rows: int = 512
    agg_cols: int = 512
    fx_rows: int = 128
    fx_cols: int = 128
    # decentralized per-node crossbar counts (1 each in the paper's baseline;
    # §4.3 notes linear scaling until the feature data fits)
    n_xbar_dec: tuple = (1, 1, 1)


DEFAULT_HW = HardwareParams()


@dataclasses.dataclass(frozen=True)
class CoreLatency:
    traversal: float
    aggregation: float
    feature_extraction: float

    @property
    def total(self) -> float:
        return self.traversal + self.aggregation + self.feature_extraction


@dataclasses.dataclass(frozen=True)
class NetMetrics:
    """Eq. 1 / Eq. 6 outputs plus the per-core breakdown."""
    setting: str
    compute: CoreLatency
    t_compute: float
    t_communicate: float
    p_compute: float
    p_communicate: float

    @property
    def t_net(self) -> float:
        return self.t_compute + self.t_communicate

    @property
    def p_net(self) -> float:
        return self.p_compute + self.p_communicate


def _workload_passes(stats: GraphStats, hw: HardwareParams,
                     sample: int | None = None):
    """Crossbar passes per node for (traversal, aggregation, fx), relative to
    the taxi calibration workload (1 pass per core).

    Traversal: one CAM search per ceil(neighbors / cam_rows) block.
    Aggregation: neighbor rows x feature columns tiling of the MVM crossbar.
    Feature extraction: F x F_hidden matmul tiled on the fx crossbar; the
    taxi calibration point is a 216->128 layer (one 2-tile pass, normalized).
    """
    s = sample if sample is not None else min(stats.avg_cs, hw.agg_rows)
    f = max(stats.feature_len, 1)
    trav = math.ceil(max(stats.avg_cs, 1) / hw.cam_rows)
    agg = math.ceil(s / hw.agg_rows) * math.ceil(f / hw.agg_cols)
    # calibration workload: ceil(216/128)*ceil(128/128) = 2 fx passes
    fx = (math.ceil(f / hw.fx_rows) * math.ceil(128 / hw.fx_cols)) / 2.0
    return trav, agg, fx


def per_node_latency(stats: GraphStats, hw: HardwareParams = DEFAULT_HW,
                     workload_scaled: bool = False,
                     sample: int | None = None) -> CoreLatency:
    """(t1, t2, t3) for one decentralized node on this workload.

    ``workload_scaled=False`` is the paper-faithful mode: the per-node core
    latencies are workload-independent constants (this is what reproduces the
    published ~1400x average exactly). ``True`` scales each core by the
    crossbar-pass count implied by Table-2 statistics (beyond-paper mode).
    """
    if not workload_scaled:
        return CoreLatency(hw.t1, hw.t2, hw.t3)
    k1, k2, k3 = _workload_passes(stats, hw, sample)
    x1, x2, x3 = hw.n_xbar_dec
    # §4.3: more crossbars per node -> linear speed-up until saturation
    return CoreLatency(hw.t1 * k1 / min(x1, k1),
                       hw.t2 * k2 / min(x2, k2),
                       hw.t3 * k3 / min(x3, max(k3, 1e-9)))


def compute_latency(setting: Setting, stats: GraphStats,
                    hw: HardwareParams = DEFAULT_HW,
                    workload_scaled: bool = False,
                    n_clusters: int = 1,
                    sample: int | None = None,
                    mode: str = "calibrated",
                    inventory=None,
                    layer_dims: tuple | None = None,
                    technology=None, calibration=None) -> CoreLatency:
    """Eq. 2 (decentralized) / Eq. 3 (centralized) / semi (beyond-paper).

    ``sample`` is the runtime's configured neighbor-sample size; the
    workload-scaled mode uses it for the aggregation-core pass count
    (``None`` falls back to the Table-2 ``avg_cs`` heuristic).

    ``mode="derived"`` routes the compute latency through the crossbar
    mapper (``repro_torch.mapper``, DESIGN.md §8): tile counts, array allocation
    and pass rounds are derived from first principles for the given
    ``inventory`` (default: the setting's paper inventory) and
    ``layer_dims`` (default: the calibration workload, one
    ``feature_len -> 128`` layer). At the paper's geometry the two modes
    agree to ceil-rounding (< 10%, cross-validated in tests); away from it
    the derived mode is the only one that can answer.

    ``technology`` (device-technology name / ``TechnologyParams``) and
    ``calibration`` (measured ``HostCalibration``) are derived-mode knobs
    forwarded to ``compile_mapping`` (DESIGN.md §13): the calibrated mode
    *is* the SOT-MRAM Table-1 fixed point and cannot price any other
    device, so passing either with ``mode="calibrated"`` raises."""
    if mode not in ("calibrated", "derived"):
        raise ValueError(f"unknown mode {mode!r}; "
                         f"one of ('calibrated', 'derived')")
    if mode == "derived":
        from ..mapper.compile import compile_mapping
        dims = layer_dims or (max(stats.feature_len, 1), 128)
        return compile_mapping(dims, stats, hw, inventory, setting,
                               n_clusters, sample, technology=technology,
                               calibration=calibration).core_latency()
    if technology is not None or calibration is not None:
        raise ValueError(
            "technology/calibration require mode='derived': the calibrated "
            "mode is the paper's SOT-MRAM Table-1 fixed point")
    t = per_node_latency(stats, hw, workload_scaled, sample)
    if setting == "decentralized":
        return t
    if setting == "centralized":
        k = stats.n_nodes - 1
        return CoreLatency(t.traversal / hw.m1 * k,
                           t.aggregation / hw.m2 * k,
                           t.feature_extraction / hw.m3 * k)
    assert setting == "semi", setting
    # semi: n_clusters cluster-heads, each a centralized accelerator over its
    # own n/k-node cluster, all heads operating in parallel (paper §5).
    k = max(math.ceil(stats.n_nodes / max(n_clusters, 1)) - 1, 1)
    return CoreLatency(t.traversal / hw.m1 * k,
                       t.aggregation / hw.m2 * k,
                       t.feature_extraction / hw.m3 * k)


def communicate_latency(setting: Setting, stats: GraphStats,
                        hw: HardwareParams = DEFAULT_HW,
                        n_clusters: int = 1) -> float:
    """Eq. 4 (decentralized, sequential intra-cluster peer hops) /
    Eq. 5 (centralized, one concurrent inter-network transfer)."""
    if setting == "centralized":
        return hw.t_ln
    if setting == "decentralized":
        return (hw.t_e + stats.avg_cs * hw.t_lc) * 2.0
    assert setting == "semi", setting
    # semi ([26], paper §5): nodes reach their cluster head over one
    # concurrent inter-network hop; heads are infrastructure edge servers
    # exchanging boundary data with a bounded set of *adjacent* heads over
    # inter-network-class links (pre-established, no t_e).
    adj_heads = min(max(n_clusters - 1, 0), 6)   # spatial adjacency bound
    return hw.t_ln + 2.0 * adj_heads * hw.t_ln


def refresh_communicate_latency(setting: Setting, stats: GraphStats,
                                hw: HardwareParams = DEFAULT_HW,
                                n_clusters: int = 1,
                                dirty_frac: float = 1.0) -> float:
    """Communication latency of one *incremental* refresh commit whose
    dirty frontier covers ``dirty_frac`` of the rows (Eqs. 4/5 scaled to
    the streaming runtime's dirty-rows-only exchange — DESIGN.md §9/§10).

    The fixed per-commit parts survive any frontier: the centralized
    inter-network transfer is one concurrent upload regardless of how many
    rows move (Eq. 5), decentralized peers still pay connection
    establishment ``t_e``, and a semi spoke→head upload is one concurrent
    intra-region hop. Only the per-row parts — sequential ad-hoc peer hops
    (Eq. 4) and head↔head boundary rows — scale with the dirty share.
    ``dirty_frac=1`` recovers ``communicate_latency`` exactly.
    """
    frac = min(max(dirty_frac, 0.0), 1.0)
    if setting == "centralized":
        return hw.t_ln
    if setting == "decentralized":
        return (hw.t_e + frac * stats.avg_cs * hw.t_lc) * 2.0
    assert setting == "semi", setting
    adj_heads = min(max(n_clusters - 1, 0), 6)
    return hw.t_ln + frac * 2.0 * adj_heads * hw.t_ln


def power(setting: Setting, stats: GraphStats,
          hw: HardwareParams = DEFAULT_HW, gnn_layers: int = 2,
          alpha: tuple | None = None) -> tuple:
    """Eq. 6/7 — (P_compute, P_communicate) per accelerator device."""
    if setting == "centralized":
        p_comp = sum(hw.p_cores_cent)
        p_comm = hw.p_ln * 2.0
        return p_comp, p_comm
    # decentralized / semi edge node
    p_comp = sum(hw.p_cores_dec)
    # Eq. 7: activations crossing layers, radiated at e_per_bit over t(L_c)
    if alpha is None:
        alpha = tuple([stats.feature_len * 32] * (gnn_layers + 1))  # bits
    bits = sum(alpha[1:gnn_layers])
    p_comm = bits * hw.e_per_bit / hw.t_lc if gnn_layers > 1 else 0.0
    return p_comp, p_comm


def predict(setting: Setting, stats: GraphStats,
            hw: HardwareParams = DEFAULT_HW, workload_scaled: bool = False,
            n_clusters: int = 1, gnn_layers: int = 2,
            sample: int | None = None,
            mode: str = "calibrated",
            inventory=None,
            layer_dims: tuple | None = None,
            technology=None, calibration=None) -> NetMetrics:
    """Full Eq. 1 + Eq. 6 evaluation for one setting on one workload.

    ``mode="calibrated"`` (default) prices compute from the Table-1
    constants; ``mode="derived"`` compiles the workload onto the crossbar
    ``inventory`` via ``repro_torch.mapper`` and rolls up pass rounds (see
    ``compute_latency``), optionally re-anchored by a device
    ``technology`` and/or a measured host ``calibration`` (DESIGN.md
    §13). The link model (Eqs. 4/5/7) is shared — crossbar geometry does
    not move the radio."""
    comp = compute_latency(setting, stats, hw, workload_scaled, n_clusters,
                           sample, mode=mode, inventory=inventory,
                           layer_dims=layer_dims, technology=technology,
                           calibration=calibration)
    comm = communicate_latency(setting, stats, hw, n_clusters)
    p_comp, p_comm = power(setting, stats, hw, gnn_layers)
    return NetMetrics(setting, comp, comp.total, comm, p_comp, p_comm)


def headline_averages(hw: HardwareParams = DEFAULT_HW):
    """The paper's two headline claims, recomputed over Table 2.

    Returns (compute_speedup_dec_over_cent, comm_speedup_cent_over_dec),
    expected ~1400x and ~790x.
    """
    comp, comm = [], []
    for stats in TABLE2_DATASETS.values():
        c = predict("centralized", stats, hw)
        d = predict("decentralized", stats, hw)
        comp.append(c.t_compute / d.t_compute)
        comm.append(d.t_communicate / c.t_communicate)
    return sum(comp) / len(comp), sum(comm) / len(comm)


def table1(hw: HardwareParams = DEFAULT_HW):
    """Reproduce Table 1 (taxi case study) from the model."""
    out = {}
    for setting in ("centralized", "decentralized"):
        m = predict(setting, TAXI_STATS, hw)
        out[setting] = {
            "traversal_s": m.compute.traversal,
            "aggregation_s": m.compute.aggregation,
            "feature_extraction_s": m.compute.feature_extraction,
            "computation_s": m.t_compute,
            "communication_s": m.t_communicate,
            "p_compute_w": m.p_compute,
        }
    return out


def pick_setting(stats: GraphStats, hw: HardwareParams = DEFAULT_HW,
                 candidates: tuple = ("centralized", "decentralized", "semi"),
                 n_clusters: int = 16) -> tuple:
    """The executable 'design guideline': choose the setting minimizing T_net.

    Returns (best_setting, {setting: NetMetrics}).
    """
    metrics = {s: predict(s, stats, hw, n_clusters=n_clusters)
               for s in candidates}
    best = min(metrics, key=lambda s: metrics[s].t_net)
    return best, metrics

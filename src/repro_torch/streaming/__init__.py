"""Streaming inference runtime: dynamic graphs, incremental k-hop refresh,
and batched serving (DESIGN.md §9).

The counterpart of ``repro.streaming``, on the port's kernels.

The §4.2 taxi workload streams — positions and demand maps move every tick
— and only a delta of the graph changes per step. This package makes that
delta first-class:

  * ``delta``       — ``GraphDelta`` mutation buffer + ``apply_deltas``
    amortized CSR rebuild (gcn_normalize contract preserved).
  * ``frontier``    — k-hop dirty-frontier masks: which rows each of the L
    layers must recompute.
  * ``incremental`` — ``IncrementalEngine``: cached per-layer activations,
    dirty-rows-only recompute through the same layer step every
    backend × setting uses, incremental traffic billing.
  * ``server``      — ``StreamingGNNServer``: ``ingest()`` tick streams,
    eager / interval / bounded-staleness refresh policies, batched
    ``query()``.

``python -m repro_torch.launch.gnn --stream TICKS`` drives the server over
a synthetic tick stream and reports the recomputed-node fraction and the
measured incremental traffic.
"""
from .delta import DeltaResult, GraphDelta, apply_deltas
from .frontier import FRONTIER_MODES, FrontierMasks, expand_frontier
from .incremental import IncrementalEngine, StreamingUpdate
from .server import POLICIES, StreamingGNNServer

__all__ = [
    "DeltaResult", "GraphDelta", "apply_deltas",
    "FRONTIER_MODES", "FrontierMasks", "expand_frontier",
    "IncrementalEngine", "StreamingUpdate",
    "POLICIES", "StreamingGNNServer",
]

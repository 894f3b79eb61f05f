"""Neighbor selection on the traversal CAM.

CAM-backed k-nearest-neighbor graph construction over LSH band signatures,
and the synthetic feature-similarity scenarios it opens. The counterpart
of ``repro.neighbors``.
"""
from .knn import (NEIGHBOR_MODES, band_match_counts, knn_graph,  # noqa: F401
                  select_topk)
from .scenarios import (SCENARIOS, scenario_features,  # noqa: F401
                        scenario_graph)
from .signature import lsh_signatures, tag_bands  # noqa: F401

__all__ = ["NEIGHBOR_MODES", "band_match_counts", "knn_graph",
           "select_topk", "SCENARIOS", "scenario_features",
           "scenario_graph", "lsh_signatures", "tag_bands"]

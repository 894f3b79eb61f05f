"""IMA-GNN core in PyTorch: graphs, partitions, execution plans, the GNN."""
from .graph import (Graph, GraphStats, TABLE2_DATASETS, TAXI_STATS,
                    dataset_like, random_graph)
from .partition import (ExecutionPlan, HierPartition, hier_partition,
                        plan_execution)
from . import gnn, partition

__all__ = [
    "ExecutionPlan", "HierPartition", "hier_partition", "plan_execution",
    "Graph", "GraphStats", "TABLE2_DATASETS", "TAXI_STATS", "random_graph",
    "dataset_like", "gnn", "partition",
]

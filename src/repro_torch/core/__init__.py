"""IMA-GNN core in PyTorch: graphs, partitions, execution plans, the GNN,
the taxi case study."""
from .graph import (Graph, GraphStats, TABLE2_DATASETS, TAXI_STATS,
                    dataset_like, random_graph)
from .costmodel import (HardwareParams, DEFAULT_HW, NetMetrics, CoreLatency,
                        predict, compute_latency, communicate_latency, power,
                        headline_averages, table1, pick_setting)
from .partition import (ExecutionPlan, HierPartition, hier_partition,
                        plan_execution)
from . import costmodel, gnn, partition, taxi

__all__ = [
    "ExecutionPlan", "HierPartition", "hier_partition", "plan_execution",
    "Graph", "GraphStats", "TABLE2_DATASETS", "TAXI_STATS", "random_graph",
    "dataset_like", "HardwareParams", "DEFAULT_HW", "NetMetrics",
    "CoreLatency", "predict", "compute_latency", "communicate_latency",
    "power", "headline_averages", "table1", "pick_setting",
    "costmodel", "gnn", "partition", "taxi",
]

from .ref import csr_aggregate_ref, pad_neighbors
from .ops import aggregate, csr_aggregate

__all__ = ["csr_aggregate_ref", "pad_neighbors", "aggregate",
           "csr_aggregate"]

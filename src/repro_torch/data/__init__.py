"""Data pipelines, the counterpart of ``repro.data``: the LM token stream
(``TokenStream``, ``synthetic_batch``) and graph batches."""
from .tokens import TokenStream, synthetic_batch
from .graphs import graph_batches

__all__ = ["TokenStream", "synthetic_batch", "graph_batches"]

"""Data pipelines, the counterpart of ``repro.data``.

The reference's token streams (``TokenStream``, ``synthetic_batch``) draw
from ``jax.random`` and feed its language models; they come with the port
of that stack.
"""
from .graphs import graph_batches

__all__ = ["graph_batches"]

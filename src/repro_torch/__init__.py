"""IMA-GNN in PyTorch and CUDA: the port of the JAX package ``repro``.

GNN embedding serving over an ``ExecutionPlan`` (centralized, decentralized
and semi-decentralized) on hand-written Hopper kernels. It imports nothing
of ``repro`` or JAX; the JAX package stays the reference its tests compare
against.
"""

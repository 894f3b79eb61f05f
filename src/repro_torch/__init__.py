"""IMA-GNN in PyTorch and CUDA: the port of the JAX package ``repro``.

GNN embedding serving over an ``ExecutionPlan`` (centralized, decentralized
and semi-decentralized) on hand-written Hopper kernels, and training: the
GNN's loss and gradients and the paper's §4.2 taxi forecaster
(``core.taxi``), with AdamW (``optim``), graph batches (``data``) and
checkpoints (``checkpoint``) on the plain PyTorch ops, whose trained
weights the kernels serve; and the LM stack's ten architectures
(``models``, ``configs``) with one-card training and serving
(``launch.train``, ``launch.serve``). It imports nothing of ``repro`` or
JAX; the JAX package stays the reference its tests compare against.
"""

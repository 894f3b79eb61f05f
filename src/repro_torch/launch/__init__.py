"""Entry points of the port: GNN serving (``gnn``), the SPMD mesh
(``mesh``), and the LM stack's trainer (``train``), server (``serve``)
and their step builders (``steps``)."""

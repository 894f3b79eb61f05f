"""Entry points of the port: GNN serving (``gnn``), the SPMD mesh
(``mesh``), and the LM stack's trainer (``train``), server (``serve``)
and their step builders (``steps``).

The reference's eight names are exported, each loaded on first use: the
submodules import the models and the distributed rules, which import
``launch.mesh`` in turn, and ``python -m repro_torch.launch.gnn`` should
not find its own module imported before it runs."""
import importlib

_HOME = {"GNNServer": "gnn", "make_mesh": "mesh",
         "make_production_mesh": "mesh", "set_mesh": "mesh",
         "batch_struct": "steps", "make_prefill_step": "steps",
         "make_serve_step": "steps", "make_train_step": "steps"}

__all__ = list(_HOME)


def __getattr__(name: str):
    if name not in _HOME:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_HOME[name]}", __name__),
                   name)

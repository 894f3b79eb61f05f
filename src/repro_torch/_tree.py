"""Nested containers of tensors ("trees"), flattened as JAX flattens them.

The optimizer and the checkpoints walk parameter trees leaf by leaf, and a
checkpoint stores its leaves by position, so the order is part of the
on-disk format. It is JAX's (``jax.tree.flatten``): dict values by
**sorted** key, lists and tuples in order, ``None`` an empty subtree, any
other object a leaf. A checkpoint written by the reference therefore
restores here leaf for leaf. (``torch.utils._pytree`` is private and walks
dicts in insertion order, which would swap leaves.)

``value_and_grad`` is the counterpart of ``jax.value_and_grad`` over such a
tree of parameters (``has_aux`` as there).
"""
from __future__ import annotations

import contextlib

import torch


class TreeDef:
    """The structure of a flattened tree: ``node`` is ``"*"`` for a leaf,
    ``None``, or ``(type, keys, children)`` for a dict / list / tuple."""

    __slots__ = ("node", "num_leaves")

    def __init__(self, node, num_leaves: int):
        self.node = node
        self.num_leaves = num_leaves

    def unflatten(self, leaves):
        """A tree of this structure holding ``leaves`` in order."""
        leaves = list(leaves)
        if len(leaves) != self.num_leaves:
            raise ValueError(f"want {self.num_leaves} leaves, got "
                             f"{len(leaves)}")
        it = iter(leaves)
        return _build(self.node, it)

    def flatten_up_to(self, tree) -> list:
        """The leaves of ``tree``, which must have this structure."""
        leaves, tdef = flatten(tree)
        if tdef != self:
            raise ValueError(f"tree structure {tdef} differs from {self}")
        return leaves

    def __eq__(self, other) -> bool:
        return isinstance(other, TreeDef) and self.node == other.node

    def __str__(self) -> str:
        return f"PyTreeDef({_show(self.node)})"


def _walk(tree, leaves: list):
    if tree is None:
        return None
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        return (dict, keys, tuple(_walk(tree[k], leaves) for k in keys))
    if type(tree) in (list, tuple):
        return (type(tree), None, tuple(_walk(t, leaves) for t in tree))
    leaves.append(tree)
    return "*"


def _build(node, it):
    if node == "*":
        return next(it)
    if node is None:
        return None
    kind, keys, children = node
    built = [_build(c, it) for c in children]
    if kind is dict:
        return dict(zip(keys, built))
    return kind(built)


def _show(node) -> str:
    if node == "*":
        return "*"
    if node is None:
        return "None"
    kind, keys, children = node
    parts = [_show(c) for c in children]
    if kind is dict:
        return "{" + ", ".join(f"{k!r}: {p}" for k, p in
                               zip(keys, parts)) + "}"
    if kind is tuple:
        return "(" + ", ".join(parts) + (",)" if len(parts) == 1 else ")")
    return "[" + ", ".join(parts) + "]"


def flatten(tree) -> tuple[list, TreeDef]:
    """(leaves in JAX's order, structure)."""
    leaves: list = []
    node = _walk(tree, leaves)
    return leaves, TreeDef(node, len(leaves))


def leaves(tree) -> list:
    return flatten(tree)[0]


def tree_map(fn, tree):
    """``tree`` with ``fn`` applied to every leaf."""
    flat, tdef = flatten(tree)
    return tdef.unflatten(fn(x) for x in flat)


def value_and_grad(fn, params, *args, has_aux: bool = False,
                   phases=(contextlib.nullcontext(), contextlib.nullcontext())):
    """(``fn(params, *args)``, its gradient with respect to every leaf of
    ``params`` in the structure of ``params``), both detached. With
    ``has_aux``, ``fn`` returns (loss, aux) and the value is (loss, aux).
    ``phases``: two context managers, entered around ``fn`` and around
    the backward (the training step's spans)."""
    flat, tdef = flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in flat]
    forward, backward = phases
    with torch.enable_grad():
        with forward:
            out = fn(tdef.unflatten(leaves), *args)
        loss = out[0] if has_aux else out
        with backward:
            grads = torch.autograd.grad(loss, leaves)
    if has_aux:
        aux = tree_map(lambda t: t.detach() if isinstance(
            t, torch.Tensor) else t, out[1])
        return (loss.detach(), aux), tdef.unflatten(grads)
    return loss.detach(), tdef.unflatten(grads)

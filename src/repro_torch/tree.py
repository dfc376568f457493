"""Nested-dict trees, the port's counterpart of ``jax.tree`` for parameter
and optimizer-state dictionaries.  Keys are visited in sorted order, as
``jax.tree`` orders dict keys, so leaf order and leaf paths
(``"params/layers/attn/wq"``) are the JAX package's.

An object with ``tree_flatten()`` -> (children, aux) and a
``tree_unflatten(aux, children)`` classmethod is a node, as a registered
pytree node is to ``jax.tree``: its children are walked in order (their
paths end in the child's position) and ``tree_map`` rebuilds it
(``models.lm.QuantizedLeaf``: q and scale)."""

from __future__ import annotations


def _is_node(tree) -> bool:
    return hasattr(tree, "tree_flatten")


def leaves_with_paths(tree, path=()):
    """(path tuple, leaf) pairs in sorted-key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], path + (k,))
    elif _is_node(tree):
        for i, child in enumerate(tree.tree_flatten()[0]):
            yield from leaves_with_paths(child, path + (i,))
    else:
        yield path, tree


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), in a tree of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _is_node(tree):
        children, aux = tree.tree_flatten()
        others = [r.tree_flatten()[0] for r in rest]
        return type(tree).tree_unflatten(aux, [
            tree_map(fn, c, *(o[i] for o in others))
            for i, c in enumerate(children)])
    return fn(tree, *rest)

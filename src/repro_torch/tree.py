"""Nested-dict trees, the port's counterpart of ``jax.tree`` for parameter
and optimizer-state dictionaries.  Keys are visited in sorted order, as
``jax.tree`` orders dict keys, so leaf order and leaf paths
(``"params/layers/attn/wq"``) are the JAX package's."""

from __future__ import annotations


def leaves_with_paths(tree, path=()):
    """(path tuple, leaf) pairs in sorted-key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], path + (k,))
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
    return fn(tree, *rest)

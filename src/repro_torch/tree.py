"""Trees of the port's training state: nested dicts, lists and tuples of
tensors (the parameters, an optimizer state, a (params, opt_state) pair),
the shapes JAX's pytrees take.  Dict keys are visited in sorted order, as
`jax.tree` flattens a dict, so sums over leaves run in JAX's order."""
from __future__ import annotations


def _children(tree):
    """(keys, children) of a dict, list or tuple node, else None (a leaf)."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        return keys, [tree[k] for k in keys]
    if isinstance(tree, (list, tuple)):
        return list(range(len(tree))), list(tree)
    return None


def _rebuild(tree, keys, values):
    if isinstance(tree, dict):
        return dict(zip(keys, values))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*values)            # a NamedTuple
    return type(tree)(values)


def tree_leaves(tree) -> list:
    """The leaves, depth first, dict keys sorted."""
    node = _children(tree)
    if node is None:
        return [tree]
    return [leaf for child in node[1] for leaf in tree_leaves(child)]


def tree_map(fn, tree, *rest):
    """`fn` applied to each leaf of `tree` and the matching leaves of
    `rest` (trees of the same structure), in a tree of that structure."""
    node = _children(tree)
    if node is None:
        return fn(tree, *rest)
    keys, children = node
    others = [[r[k] for k in keys] for r in rest]
    return _rebuild(tree, keys, [
        tree_map(fn, child, *(o[i] for o in others))
        for i, child in enumerate(children)])


def tree_map_with_names(fn, tree, prefix: str = ""):
    """`fn(name, leaf)` for each leaf, in a tree of the same structure; a
    leaf's name joins its keys and indices with "/" (JAX's checkpoint
    names: "0/layers/1/wq" for (params, opt_state)[0]["layers"][1]["wq"])."""
    node = _children(tree)
    if node is None:
        return fn(prefix, tree)
    keys, children = node
    return _rebuild(tree, keys, [
        tree_map_with_names(fn, child, f"{prefix}/{k}" if prefix else str(k))
        for k, child in zip(keys, children)])

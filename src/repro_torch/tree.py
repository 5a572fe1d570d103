"""Trees of tensors: nested dicts, lists and tuples, with None as an empty
subtree, flattened in `jax.tree_util`'s order (dict keys sorted, sequences
in order). The train state, the optimizer and the checkpoints walk their
trees through these, so a flattened index names the same leaf as in the
reference's checkpoints."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

__all__ = ["tree_flatten", "tree_unflatten", "tree_leaves", "tree_map",
           "tree_str", "flatten_like"]


class _Leaf:
    def __repr__(self):
        return "*"


LEAF = _Leaf()


# The walks below are module functions that take their accumulator as an
# argument. A nested function that calls itself is a reference cycle (the
# function and the closure cell that names it) that holds whatever the
# closure holds, here every leaf, until the cyclic collector runs, which
# device memory does not prompt.

def _flatten(node, leaves: List[Any]):
    if isinstance(node, dict):
        return {k: _flatten(node[k], leaves) for k in sorted(node)}
    if isinstance(node, (list, tuple)):
        return type(node)(_flatten(v, leaves) for v in node)
    if node is None:
        return None
    leaves.append(node)
    return LEAF


def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """(leaves in order, the structure with each leaf replaced by LEAF)."""
    leaves: List[Any] = []
    return leaves, _flatten(tree, leaves)


def _build(node, it):
    if isinstance(node, dict):
        return {k: _build(v, it) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_build(v, it) for v in node)
    return None if node is None else next(it)


def tree_unflatten(treedef, leaves) -> Any:
    it = iter(leaves)
    out = _build(treedef, it)
    if next(it, LEAF) is not LEAF:
        raise ValueError("more leaves than the structure holds")
    return out


def flatten_like(tree, treedef) -> List[Any]:
    """The leaves of `tree`, which must have the structure `treedef`."""
    leaves, td = tree_flatten(tree)
    if td != treedef:
        raise ValueError(f"tree structures differ: {tree_str(tree)} and "
                         f"PyTreeDef({treedef!r})")
    return leaves


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest) -> Any:
    """fn over the leaves of `tree` and, leaf for leaf, of `rest`, which
    must have the same structure."""
    leaves, td = tree_flatten(tree)
    others = [flatten_like(other, td) for other in rest]
    return tree_unflatten(td, [fn(*xs) for xs in zip(leaves, *others)])


def tree_str(tree) -> str:
    """The structure as `jax.tree_util`'s treedef prints it, e.g.
    PyTreeDef({'a': *, 'b': [*, None]})."""
    return f"PyTreeDef({tree_flatten(tree)[1]!r})"

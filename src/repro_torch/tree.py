"""The ``jax.tree`` functions the training modules use, over nested dicts,
tuples and lists of tensors.

Leaves come in ``jax.tree.flatten``'s order: a dict's values by sorted
key, a tuple's or list's in order; None is an empty subtree. So a train
state flattens here into the same leaves, in the same order, as the JAX
package's state of the same names, which is what lets a checkpoint of
either package restore in the other.
"""

from __future__ import annotations


class _Leaf:
    __slots__ = ()

    def __repr__(self) -> str:
        return "*"


LEAF = _Leaf()


def tree_flatten(tree) -> tuple[list, object]:
    """(leaves, treedef): ``treedef`` is ``tree`` with every leaf replaced
    by `LEAF`."""
    leaves = []

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, (tuple, list)):
            return type(node)(walk(v) for v in node)
        if node is None:
            return None
        leaves.append(node)
        return LEAF

    return leaves, walk(tree)


def tree_unflatten(treedef, leaves):
    """``treedef`` with its `LEAF` s replaced by ``leaves``, in order."""
    it = iter(leaves)

    def walk(node):
        if node is LEAF:
            return next(it)
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, (tuple, list)):
            return type(node)(walk(v) for v in node)
        return None

    return walk(treedef)


def flatten_up_to(treedef, tree) -> list:
    """``tree``'s subtrees at ``treedef``'s leaves (``tdef.flatten_up_to``);
    a structure that differs raises."""
    out = []

    def walk(node, sub):
        if node is LEAF:
            out.append(sub)
        elif isinstance(node, dict):
            if not isinstance(sub, dict) or set(sub) != set(node):
                raise ValueError(f"tree structures differ: {node} and {sub}")
            for k in sorted(node):
                walk(node[k], sub[k])
        elif isinstance(node, (tuple, list)):
            if not isinstance(sub, (tuple, list)) or len(sub) != len(node):
                raise ValueError(f"tree structures differ: {node} and {sub}")
            for n, s in zip(node, sub):
                walk(n, s)
        elif sub is not None:
            raise ValueError(f"tree structures differ: None and {sub}")

    walk(treedef, tree)
    return out


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching subtrees of
    ``rest``."""
    leaves, tdef = tree_flatten(tree)
    others = [flatten_up_to(tdef, r) for r in rest]
    return tree_unflatten(tdef, [fn(*xs) for xs in zip(leaves, *others)])

"""`maybe_scan`: the JAX package's ``lax.scan`` over a stacked leading
axis, as a Python loop.

The reference routes every scan through ``maybe_scan`` so that one flag
(``set_unroll``) can unroll them for XLA's cost analysis; that switch and
its modes exist only for the XLA dry-run tooling (ROADMAP.md Queue 1 item
13) and are left out here. The loop runs ``f`` once per index of the
leading axis of ``xs`` and stacks what it returns.
"""

from __future__ import annotations

import torch


def tree_stack(trees: list):
    """Stack a list of same-structured trees along a new leading axis."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: tree_stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(tree_stack([t[j] for t in trees])
                           for j in range(len(first)))
    return torch.stack(trees)


def _leading(tree) -> int | None:
    if tree is None:
        return None
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        for v in tree:
            n = _leading(v)
            if n is not None:
                return n
        return None
    return tree.shape[0]


def tree_unbind(tree, n: int) -> list:
    """``tree`` (nested dicts, tuples, lists and None over tensors) split
    along its leaves' leading axis of ``n``: a list of ``n`` trees of
    views (``torch.unbind``, whose backward stacks the slices' gradients
    in one tensor, where indexing each step would cost a full-size
    gradient a step)."""
    if tree is None:
        return [None] * n
    if isinstance(tree, dict):
        parts = {k: tree_unbind(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    if isinstance(tree, (tuple, list)):
        parts = [tree_unbind(v, n) for v in tree]
        return [type(tree)(p[i] for p in parts) for i in range(n)]
    return list(torch.unbind(tree, 0))


def maybe_scan(f, init, xs, length=None, kind="inner"):
    """``carry, ys = f(carry, x)`` for each ``x`` along ``xs``'s leading
    axis; returns ``(carry, stacked ys)`` (None when ``f`` returns None).
    ``kind`` is accepted for the reference's signature and unused."""
    del kind
    n = _leading(xs) if length is None else length
    carry, ys = init, []
    for x in tree_unbind(xs, n):
        carry, y = f(carry, x)
        ys.append(y)
    return carry, (tree_stack(ys) if ys else None)


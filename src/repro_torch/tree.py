"""Nested dicts of tensors (parameter, gradient and optimizer-state
trees), walked in the JAX package's order.

`jax.tree_util` visits a dict's keys in sorted order; `leaves` and
`named_leaves` do the same, so a sum over leaves adds in the reference's
order and a checkpoint names its leaves as the reference's does.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """`fn` over the leaves of `tree` and the matching leaves of `rest`
    (trees of the same structure); dict structure kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def named_leaves(tree: Any, prefix: Tuple[str, ...] = ()
                 ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(key path, leaf) pairs, dict keys in sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from named_leaves(tree[k], prefix + (str(k),))
    else:
        yield prefix, tree


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in named_leaves(tree)]

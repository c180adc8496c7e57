"""Parameter trees: nested dicts (and lists) of tensors.

The port keeps the JAX package's parameter layout — plain dicts with the
same keys — so the two map 1:1.  Dict leaves are visited in sorted-key
order, the order JAX flattens dict pytrees in, so flattened buffers and
leaf lists line up between the two packages.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over one or more trees of the same shape."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves_with_path(tree: Any, prefix: str = ""
                          ) -> Iterator[Tuple[str, Any]]:
    """(path, leaf) pairs; paths use JAX's ``keystr`` spelling
    (``['attn']['wq']``, ``[0]``)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves_with_path(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from tree_leaves_with_path(t, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def tree_leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_unflatten_like(tree: Any, leaves: List[Any]) -> Any:
    """Rebuild ``tree``'s structure with ``leaves`` (in tree_leaves order)."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has slots")
    return out

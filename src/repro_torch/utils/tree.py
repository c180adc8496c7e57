"""Parameter trees: nested dicts, lists, tuples and NamedTuples of tensors.

The port keeps the JAX package's parameter layout — plain dicts with the
same keys — so the two map 1:1.  Dict leaves are visited in sorted-key
order, the order JAX flattens dict pytrees in, so flattened buffers and
leaf lists line up between the two packages.  A leaf's path prints as
``jax.tree_util.keystr`` prints it (``['attn']['wq']``, ``[0]``,
``.step``): checkpoint keys and their content hashes
(``ckpt/checkpoint.py``) depend on that spelling.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, List, Sequence, Tuple


def _is_namedtuple(tree: Any) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over one or more trees of the same shape."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, t, *(r[i] for r in rest))
                            for i, t in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


# Path entries, printed as JAX prints its key types.
@dataclasses.dataclass(frozen=True)
class DictKey:
    key: Any

    def __str__(self) -> str:
        return f"[{self.key!r}]"


@dataclasses.dataclass(frozen=True)
class SequenceKey:
    idx: int

    def __str__(self) -> str:
        return f"[{self.idx}]"


@dataclasses.dataclass(frozen=True)
class GetAttrKey:
    name: str

    def __str__(self) -> str:
        return f".{self.name}"


def flatten_with_path(tree: Any, path: Tuple = ()
                      ) -> Iterator[Tuple[Tuple, Any]]:
    """(key path, leaf) pairs in ``jax.tree_util.tree_flatten_with_path``
    order: dict keys sorted, sequences in index order, NamedTuple fields
    in declaration order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flatten_with_path(tree[k], path + (DictKey(k),))
    elif _is_namedtuple(tree):
        for name, t in zip(tree._fields, tree):
            yield from flatten_with_path(t, path + (GetAttrKey(name),))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from flatten_with_path(t, path + (SequenceKey(i),))
    else:
        yield path, tree


def keystr(path: Sequence) -> str:
    """A key path as ``jax.tree_util.keystr`` prints it; the empty string
    for a leaf at the root."""
    return "".join(str(k) for k in path)


def tree_leaves_with_path(tree: Any, prefix: str = ""
                          ) -> Iterator[Tuple[str, Any]]:
    """(path string, leaf) pairs; paths in ``keystr`` spelling."""
    for path, leaf in flatten_with_path(tree):
        yield prefix + keystr(path), leaf


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves in ``flatten_with_path`` order, without building paths
    (the step's hot path calls this)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_unflatten_like(tree: Any, leaves: List[Any]) -> Any:
    """Rebuild ``tree``'s structure with ``leaves`` (in tree_leaves order)."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has slots")
    return out

"""Parameter and state trees as the reference keeps them: nested dicts,
tuples and lists whose leaves are tensors (or arrays, or numbers).

The leaves are visited in ``jax.tree_util``'s order (dict keys sorted,
sequences in order; ``None`` holds no leaf), and a leaf's path is its
keys and indices joined by ``/``, as ``repro/runtime/checkpoint.py``
writes them, so a tree flattens to the same leaves in the same order in
both packages.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def flatten(tree: Any) -> Tuple[List[Any], List[str]]:
    """The leaves of ``tree`` and their paths, in JAX's order."""
    leaves: List[Any] = []
    paths: List[str] = []

    def walk(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], prefix + (str(k),))
        elif isinstance(node, (tuple, list)):
            for i, v in enumerate(node):
                walk(v, prefix + (str(i),))
        elif node is not None:
            leaves.append(node)
            paths.append("/".join(prefix))

    walk(tree, ())
    return leaves, paths


def unflatten(like: Any, leaves: List[Any]) -> Any:
    """A tree of ``like``'s structure holding ``leaves`` (in ``flatten``'s
    order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}           # keep the caller's key order
        if isinstance(node, (tuple, list)):
            return type(node)(build(v) for v in node)
        return None if node is None else next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the tree holds")
    return out


def flatten_up_to(like: Any, tree: Any) -> List[Any]:
    """The subtrees of ``tree`` at the leaf positions of ``like`` (a prefix
    of its structure), in ``flatten``'s order: ``treedef.flatten_up_to``."""
    out: List[Any] = []

    def walk(node, sub):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], sub[k])
        elif isinstance(node, (tuple, list)):
            for a, b in zip(node, sub):
                walk(a, b)
        elif node is not None:
            out.append(sub)

    walk(like, tree)
    return out


def map_tree(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf to ``tree`` and trees of its structure."""
    flats = [flatten(t)[0] for t in (tree, *rest)]
    return unflatten(tree, [fn(*xs) for xs in zip(*flats)])

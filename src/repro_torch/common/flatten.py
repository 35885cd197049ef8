"""Path-keyed flattening of nested param/state dicts."""
from __future__ import annotations

from typing import Any, Dict


def flatten_dict(tree: Any, sep: str = "/", prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(flatten_dict(tree[k], sep, f"{prefix}{k}{sep}"))
    else:
        out[prefix[: -len(sep)] if prefix else ""] = tree
    return out


def unflatten_dict(flat: Dict[str, Any], sep: str = "/") -> Any:
    tree: Dict[str, Any] = {}
    for path, leaf in flat.items():
        parts = path.split(sep)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return tree


def tree_map(fn, tree: Any) -> Any:
    """``fn`` over every leaf of a nested dict, keeping its structure (empty
    subtrees included)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def replace_leaves(tree: Any, flat: Dict[str, Any], sep: str = "/",
                   prefix: str = "") -> Any:
    """``tree``'s structure (empty subtrees included) with each leaf whose
    path is in ``flat`` replaced by ``flat[path]``."""
    if isinstance(tree, dict):
        return {k: replace_leaves(v, flat, sep, f"{prefix}{k}{sep}")
                for k, v in tree.items()}
    return flat.get(prefix[: -len(sep)] if prefix else "", tree)

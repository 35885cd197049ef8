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

"""Parameter-tree utilities on dict trees of tensors: counting, casting the
floating leaves, and maps and labels by path ('a/b/0/c').

Counterpart of mla_tpu/utils/tree.py; a path joins dict keys and list or
tuple indices with '/', as JAX's path_str renders its key paths.
"""

from __future__ import annotations

from typing import Any, Callable

import torch


def _map(fn: Callable[[str, Any], Any], tree: Any, prefix: str) -> Any:
    if isinstance(tree, dict):
        return {k: _map(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, f"{prefix}{i}/") for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)


def map_with_path(fn: Callable[[str, Any], Any], tree: Any) -> Any:
    """The same tree with fn('a/b/c', leaf) at every leaf."""
    return _map(fn, tree, "")


def label_with_path(pred: Callable[[str], Any], tree: Any) -> Any:
    """A tree of labels, pred(path) at every leaf (for masks)."""
    return _map(lambda path, _: pred(path), tree, "")


def param_count(tree: Any) -> int:
    """The elements of every tensor leaf."""
    count = 0

    def add(_, leaf):
        nonlocal count
        count += leaf.numel() if isinstance(leaf, torch.Tensor) else 0

    _map(add, tree, "")
    return count


def cast_floats(tree: Any, dtype: torch.dtype) -> Any:
    """Floating-point leaves cast to dtype; integer and boolean leaves kept."""
    return _map(lambda _, x: x.to(dtype) if isinstance(x, torch.Tensor) and x.is_floating_point() else x, tree, "")

"""Sizes of the port's state: nested dicts (and lists or tuples) of
tensors, as the train state holds them."""

from __future__ import annotations

from typing import Any, Iterator

import torch


def tree_leaves(tree: Any) -> Iterator[Any]:
    """Every leaf of a nested dict / list / tuple, in insertion order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    elif tree is not None:
        yield tree


def tree_size_bytes(tree: Any) -> int:
    """Total bytes of the tensor (or array) leaves."""
    return sum(int(x.nbytes) for x in tree_leaves(tree)
               if hasattr(x, "nbytes"))


def tree_param_count(tree: Any) -> int:
    """Total element count of the tensor leaves."""
    return sum(x.numel() for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor))

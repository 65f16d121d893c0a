"""Helpers over parameter trees: nested dicts/lists of tensors, ``Linear``,
``Conv`` and ``QuantizedTensor`` leaves."""

from __future__ import annotations

import dataclasses

import torch

from ..ops.conv import Conv
from ..ops.linear import Linear
from ..quant.qtensor import QuantizedTensor


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor in the tree; structure is kept."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, QuantizedTensor):
        return tree.map(fn)
    if isinstance(tree, (Linear, Conv)):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)
        })
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    raise TypeError(f"unexpected leaf {type(tree)}")


def take_layer(tree, i: int):
    """Layer ``i`` of stacked ``[L, ...]`` block params, as views (the loop
    form of the JAX package's ``lax.scan`` over stacked blocks)."""
    return tree_map(lambda t: t[i], tree)

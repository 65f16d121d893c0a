"""Helpers over parameter trees: nested dicts/lists of tensors, ``Linear``,
``Conv`` and ``QuantizedTensor`` leaves."""

from __future__ import annotations

import dataclasses

import torch

from ..ops.conv import Conv
from ..ops.linear import Linear, TensorParallel
from ..quant.qtensor import QuantizedTensor


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor in the tree; structure is kept (a
    ``Linear``'s tensor-parallel cut is carried as it is)."""
    if tree is None or isinstance(tree, TensorParallel):
        return tree
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


def stack_trees(trees: list):
    """Stack a list of identically shaped trees along a new leading
    ``[L, ...]`` axis (the first tree's structure and non-tensor fields)."""
    it = zip(*(tree_leaves(t) for t in trees))
    return tree_map(lambda _: torch.stack(next(it)), trees[0])


def tree_leaves(tree) -> list:
    """The tensors of a tree in a fixed order (``None`` leaves skipped)."""
    out = []
    tree_map(lambda t: out.append(t) or t, tree)
    return out


def stack_layers(build, n: int, device):
    """Stack ``n`` per-layer trees along a new leading ``[L, ...]`` axis
    without holding them all at once: ``build(i)`` makes layer ``i``, whose
    tensors are copied into buffers allocated from layer 0's shapes on
    ``device`` and then dropped. Every layer must share layer 0's structure,
    shapes and dtypes (uniformly quantized checkpoints do)."""
    first = build(0)
    out = tree_map(lambda t: torch.empty((n,) + tuple(t.shape), dtype=t.dtype,
                                         device=device), first)
    dst = tree_leaves(out)
    for i in range(n):
        src = tree_leaves(first if i == 0 else build(i))
        if len(src) != len(dst):
            raise ValueError(f"layer {i} has {len(src)} tensors, layer 0 {len(dst)}")
        for d, s in zip(dst, src):
            if tuple(s.shape) != tuple(d.shape[1:]) or s.dtype != d.dtype:
                raise ValueError(f"layer {i}: {s.dtype} {tuple(s.shape)} does not "
                                 f"stack onto {d.dtype} {tuple(d.shape[1:])}")
            d[i].copy_(s)
        first = None
    return out

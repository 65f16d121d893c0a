"""Parameter trees packed into one host buffer, pinned for a CUDA device.

:func:`pack_tree` writes a tree's tensors (the fields of ``QuantizedTensor``,
``Linear`` and ``Conv`` leaves included) into one u8 buffer, each leaf at an
``ALIGN``-byte offset, straight from wherever they are (host or card);
:func:`unpack_tree` rebuilds the tree as views of that buffer or of its copy
on the device, with no copy. A tree so packed moves to the device in one
copy. The 128-byte offsets keep every view's base and row stride 16-byte
aligned, as the TMA kernels need (ops/qmatmul.check_tma_operand).

A pinned buffer is an anonymous mapping of the size asked for, page-locked
with ``cudaHostRegister``: PyTorch's pinned allocator rounds each request up
to a power of two, which would take up to twice the weights' bytes of host
memory. A buffer that cannot be pinned raises.
"""

from __future__ import annotations

import dataclasses
import math
import mmap
from typing import Tuple

import numpy as np
import torch

from ..ops.conv import Conv
from ..ops.linear import Linear, TensorParallel
from ..quant.qtensor import QuantizedTensor
from .tree import tree_leaves, tree_map

ALIGN = 128
_HOST_REGISTER_PORTABLE = 1  # cudaHostRegisterPortable: pinned for every context


class _PinnedPages(mmap.mmap):
    """Anonymous, page-aligned host memory, page-locked by
    ``cudaHostRegister`` once ``_addr`` is set. The arrays over it hold it,
    so the pages are unregistered when the last tensor over them is freed,
    before they are unmapped."""

    _addr = None

    def __del__(self):
        if self._addr is not None:
            torch.cuda.synchronize()  # no copy still reads the pages
            torch.cuda.cudart().cudaHostUnregister(self._addr)


def host_buffer(nbytes: int, pin: bool) -> torch.Tensor:
    """A u8 host tensor of exactly ``nbytes``, page-locked with ``pin``
    (raises when it cannot be)."""
    if not pin or nbytes == 0:
        return torch.empty(nbytes, dtype=torch.uint8)
    pages = _PinnedPages(-1, nbytes)
    arr = np.frombuffer(pages, dtype=np.uint8)  # holds ``pages``
    rt = torch.cuda.cudart()
    err = rt.cudaHostRegister(arr.ctypes.data, nbytes, _HOST_REGISTER_PORTABLE)
    if err != rt.cudaError.success:
        raise RuntimeError(f"cannot pin {nbytes} bytes of host memory: "
                           f"{rt.cudaGetErrorString(err)}")
    pages._addr = arr.ctypes.data
    return torch.from_numpy(arr)


def _paths(tree, path: str = "") -> list:
    """The dotted field path of every tensor of ``tree``, in tree_leaves'
    order."""
    if tree is None or isinstance(tree, TensorParallel):
        return []
    if isinstance(tree, torch.Tensor):
        return [path]
    if isinstance(tree, QuantizedTensor):
        items = [(f, getattr(tree, f)) for f in ("packed", "scale", "bias", "codebook")]
    elif isinstance(tree, (Linear, Conv)):
        items = [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        items = list(tree.items())
    else:
        items = list(enumerate(tree))
    return [p for k, v in items for p in _paths(v, f"{path}.{k}" if path else str(k))]


def tree_layout(tree) -> Tuple[tuple, int]:
    """Per leaf ``(offset, shape, dtype, field path)``, every offset a
    multiple of ``ALIGN``, and the packed size in bytes (rounded up to
    ``ALIGN``)."""
    specs, off = [], 0
    for path, t in zip(_paths(tree), tree_leaves(tree)):
        off += -off % ALIGN
        specs.append((off, tuple(t.shape), t.dtype, path))
        off += t.numel() * t.element_size()
    return tuple(specs), off + -off % ALIGN


def _view(buf: torch.Tensor, off: int, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    nb = math.prod(shape) * dtype.itemsize
    return buf[off:off + nb].view(dtype).view(shape)


def pack_into(buf: torch.Tensor, tree, specs) -> None:
    """Write ``tree``'s leaves into ``buf`` at :func:`tree_layout`'s
    ``specs``."""
    for (off, shape, dtype, _), t in zip(specs, tree_leaves(tree)):
        _view(buf, off, shape, dtype).copy_(t)


def pack_tree(tree, pin: bool):
    """``tree`` packed into one host buffer of its own (pinned with ``pin``).
    Returns (buffer, template, specs); the template is the tree on the meta
    device, the structure :func:`unpack_tree` fills."""
    specs, nbytes = tree_layout(tree)
    buf = host_buffer(nbytes, pin)
    pack_into(buf, tree, specs)
    return buf, meta_template(tree), specs


def meta_template(tree):
    """The tree's structure and non-tensor fields, its tensors on the meta
    device."""
    return tree_map(lambda t: t.to("meta"), tree)


def unpack_tree(buf: torch.Tensor, template, specs):
    """The tree as views of ``buf`` (host or device), with no copy;
    QuantizedTensors keep the template's non-tensor fields."""
    it = iter(specs)
    return tree_map(lambda _: _view(buf, *next(it)[:3]), template)

"""Carry JAX-package parameters into the port.

The caller flattens a JAX param pytree to plain Python and numpy first (this
module imports neither jax nor the JAX package). The flattened form:

* ``numpy.ndarray`` (bfloat16 arrays from ``ml_dtypes`` included) -> tensor;
* ``{"__type__": "Linear", "w": ..., "b": ..., "lora": ...}`` -> ``Linear``;
* ``{"__type__": "Conv", "w": ..., "b": ...}`` -> ``Conv``;
* ``{"__type__": "QuantizedTensor", "packed", "scale", "bias", "codebook",
  "kind", "bits", "group", "split", "shape", "out_dtype"}`` ->
  ``QuantizedTensor``;
* dicts, lists and ``None`` keep their structure.

Stacked leading ``[L, ...]`` dims pass through unchanged; the models take
per-layer views.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.conv import Conv
from .ops.linear import Linear
from .quant.qtensor import QuantizedTensor
from .util.device import resolve_device


def _to_tensor(arr, device: torch.device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(arr).copy()).to(device)


def from_numpy_tree(tree, device="cuda"):
    """Flattened JAX params (see module doc) -> the port's params on
    ``device`` (CUDA by default; raises without it)."""
    return _convert(tree, resolve_device(device))


def _convert(tree, device: torch.device):
    if tree is None:
        return None
    if isinstance(tree, np.ndarray) or np.isscalar(tree):
        return _to_tensor(tree, device)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_convert(v, device) for v in tree)
    if not isinstance(tree, dict):
        raise TypeError(f"unexpected leaf {type(tree)}")
    kind = tree.get("__type__")
    if kind == "Linear":
        lora = tree.get("lora")
        return Linear(
            w=_convert(tree["w"], device),
            b=_convert(tree.get("b"), device),
            lora=None if lora is None else tuple(_convert(v, device) for v in lora),
        )
    if kind == "Conv":
        return Conv(w=_convert(tree["w"], device),
                    b=_convert(tree.get("b"), device))
    if kind == "QuantizedTensor":
        return QuantizedTensor(
            packed=_to_tensor(tree["packed"], device),
            scale=_to_tensor(tree["scale"], device),
            bias=_convert(tree.get("bias"), device),
            codebook=_convert(tree.get("codebook"), device),
            kind=str(tree["kind"]),
            bits=int(tree["bits"]),
            group=int(tree["group"]),
            split=int(tree["split"]),
            shape=tuple(int(s) for s in tree["shape"]),
            out_dtype=str(tree["out_dtype"]),
        )
    if kind is not None:
        raise TypeError(f"unknown __type__ {kind!r}")
    return {k: _convert(v, device) for k, v in tree.items()}

"""VarStore: the loader-side weight registry (port of
``diffusion_rs_tpu/io/varstore.py``).

Hierarchical prefix paths over a flat name -> tensor map, a dtype cast at
``get``, and the linear factory that sniffs checkpoint markers (bnb 4-bit,
bnb int8, GGUF, dense). Entries stay lazy host views (torch views over the
files' mmaps, or raw GGUF block bytes) until ``get`` / ``linear`` /
``conv2d`` materializes them: that is the single host -> device copy, to the
store's explicit ``device``.
"""

from __future__ import annotations

import json
from typing import Callable, Dict, Union

import numpy as np
import torch

from ..ops.conv import Conv
from ..ops.linear import Linear
from ..quant.bnb import bnb4bit_to_canonical, bnb_int8_to_canonical, resolve_absmax
from ..quant.gguf_quants import gguf_to_canonical
from ..quant.qtensor import QuantizedTensor, dequantize
from ..util.device import resolve_device
from .gguf import DENSE, GgufFile
from .safetensors import SafeTensors


class GgufEntry:
    """A GGUF-quantized tensor: its format, logical [out, in] shape and raw
    block bytes."""

    __slots__ = ("fmt", "shape", "raw")

    def __init__(self, fmt, shape, raw):
        self.fmt, self.shape, self.raw = fmt, shape, raw


Entry = Union[torch.Tensor, GgufEntry]


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"`` (QuantizedTensor.out_dtype)."""
    return str(dtype).removeprefix("torch.")


class VarStore:
    def __init__(self, default_dtype=torch.bfloat16, device="cuda"):
        self._entries: Dict[str, Callable[[], Entry]] = {}
        self.default_dtype = default_dtype
        self.device = resolve_device(device)

    # -- population ---------------------------------------------------------

    def add_safetensors(self, st: SafeTensors, prefix: str = ""):
        for name in st.keys():
            self._entries[prefix + name] = (lambda s, n: lambda: s.tensor(n))(st, name)

    def add_gguf(self, gf: GgufFile, prefix: str = ""):
        for name, ti in gf.tensors.items():
            if ti.fmt in DENSE:
                self._entries[prefix + name] = (lambda g, n: lambda: g.tensor(n))(gf, name)
            else:
                self._entries[prefix + name] = (
                    lambda g, t: lambda: GgufEntry(t.fmt, t.shape, g.raw(t.name))
                )(gf, ti)

    def add_tensor(self, name: str, t: torch.Tensor):
        self._entries[name] = lambda: t

    # -- access -------------------------------------------------------------

    def keys(self):
        return self._entries.keys()

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def pp(self, prefix: str) -> "VarStoreView":
        return VarStoreView(self, prefix)

    def raw_entry(self, name: str) -> Entry:
        return self._entries[name]()

    def _dense(self, name: str) -> torch.Tensor:
        e = self.raw_entry(name)
        if isinstance(e, GgufEntry):
            raise ValueError(f"{name} is GGUF-quantized ({e.fmt}); use linear()")
        return e

    def get(self, name: str, dtype=None) -> torch.Tensor:
        """The tensor on the store's device, cast to ``dtype`` (default: the
        store's)."""
        return self._dense(name).to(self.device).to(dtype or self.default_dtype)

    def get_np(self, name: str) -> np.ndarray:
        """Host numpy copy of a dense tensor (bf16 widened to f32)."""
        t = self._dense(name)
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class VarStoreView:
    """Prefix view of a store."""

    def __init__(self, store: VarStore, prefix: str):
        self._store = store
        self._prefix = prefix.rstrip(".")

    def _abs(self, name: str) -> str:
        if not self._prefix:
            return name
        return f"{self._prefix}.{name}" if name else self._prefix

    def pp(self, prefix: str) -> "VarStoreView":
        return VarStoreView(self._store, self._abs(prefix))

    def __contains__(self, name: str) -> bool:
        return self._abs(name) in self._store

    def get(self, name: str, dtype=None) -> torch.Tensor:
        return self._store.get(self._abs(name), dtype)

    def get_np(self, name: str) -> np.ndarray:
        return self._store.get_np(self._abs(name))

    # -- assembled modules ---------------------------------------------------

    def linear(self, bias: bool = True, dtype=None,
               dequantize_to_dense: bool = False) -> Linear:
        """A Linear at this prefix, by checkpoint markers:

        * ``weight.absmax``         -> bnb 4-bit (nf4/fp4, maybe nested absmax)
        * ``SCB``                   -> bnb int8 (per-row scales)
        * GGUF-quantized ``weight`` -> canonical affine tensor
        * otherwise                 -> dense (torch [out, in] -> K-major)
        """
        store = self._store
        dt = dtype or store.default_dtype
        out_dtype = dtype_name(dt)
        w: Union[torch.Tensor, QuantizedTensor]
        if "weight.absmax" in self:
            w = self._bnb_4bit(out_dtype)
        elif "SCB" in self:
            w = bnb_int8_to_canonical(self.get_np("weight"), self.get_np("SCB"), out_dtype)
        else:
            e = store.raw_entry(self._abs("weight"))
            if isinstance(e, GgufEntry):
                w = gguf_to_canonical(e.fmt, e.raw, e.shape, out_dtype)
            else:
                if e.ndim != 2:
                    raise ValueError(f"linear weight {self._prefix} has shape "
                                     f"{tuple(e.shape)}")
                w = e.to(store.device).to(dt).t().contiguous()
        if isinstance(w, QuantizedTensor):
            w = w.map(lambda t: t.to(store.device))
            if dequantize_to_dense:
                w = dequantize(w, dt)
        b = self.get("bias", dt) if bias and "bias" in self else None
        return Linear(w=w, b=b)

    def _bnb_4bit(self, out_dtype: str) -> QuantizedTensor:
        """Parse the bnb 4-bit companions of ``weight``."""
        w = self.pp("weight")
        kind = next((k for k in ("nf4", "fp4")
                     if f"quant_state.bitsandbytes__{k}" in w), None)
        if kind is None:
            raise ValueError(f"{self._prefix}: weight.absmax present but no quant_state")
        state = json.loads(bytes(w.get_np(f"quant_state.bitsandbytes__{kind}")))
        absmax = w.get_np("absmax")
        if "nested_absmax" in w:
            absmax = resolve_absmax(absmax, w.get_np("nested_absmax"),
                                    w.get_np("nested_quant_map"),
                                    int(state["nested_blocksize"]),
                                    float(state["nested_offset"]))
        else:
            absmax = absmax.astype(np.float32)
        return bnb4bit_to_canonical(self.get_np("weight"), absmax, tuple(state["shape"]),
                                    int(state["blocksize"]), kind, out_dtype)

    def conv2d(self, dtype=None) -> Conv:
        """torch OIHW filter -> HWIO Conv."""
        dt = dtype or self._store.default_dtype
        w = self.get("weight", dt)
        if w.ndim != 4:
            raise ValueError(f"expected 4-D conv filter at {self._prefix}, got "
                             f"{tuple(w.shape)}")
        b = self.get("bias", dt) if "bias" in self else None
        return Conv(w=w.permute(2, 3, 1, 0).contiguous(), b=b)

    def conv2d_as_linear(self, dtype=None) -> Linear:
        """A 1x1 conv stored as [out, in, 1, 1] (or [out, in]) -> Linear."""
        dt = dtype or self._store.default_dtype
        w = self.get("weight", dt)
        if w.ndim == 4:
            w = w[:, :, 0, 0]
        b = self.get("bias", dt) if "bias" in self else None
        return Linear(w=w.t().contiguous(), b=b)

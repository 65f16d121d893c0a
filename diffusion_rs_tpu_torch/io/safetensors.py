"""Zero-copy safetensors reader and a minimal writer (the port's own copy of
``diffusion_rs_tpu/io/safetensors.py``).

One copy-on-write mmap per file; tensors come out as views into it (no copy
until a tensor is moved to its device), including views at an offset inside
a DDUF archive member. bf16 needs no ``ml_dtypes``: :meth:`SafeTensors.tensor`
views its bits as ``torch.bfloat16``, and :meth:`SafeTensors.numpy` hands
them out as uint16.
"""

from __future__ import annotations

import json
import mmap
import struct
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

# safetensors dtype -> (numpy dtype of the stored bits, torch dtype)
_DTYPES = {
    "F64": (np.float64, torch.float64),
    "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16),
    "BF16": (np.uint16, torch.bfloat16),
    "F8_E4M3": (np.uint8, torch.float8_e4m3fn),
    "I64": (np.int64, torch.int64),
    "I32": (np.int32, torch.int32),
    "I16": (np.int16, torch.int16),
    "I8": (np.int8, torch.int8),
    "U8": (np.uint8, torch.uint8),
    "U16": (np.uint16, torch.uint16),
    "U32": (np.uint32, torch.uint32),
    "U64": (np.uint64, torch.uint64),
    "BOOL": (np.bool_, torch.bool),
}
# dtypes whose numpy view holds raw bits rather than the values
_BITS_ONLY = {"BF16", "F8_E4M3"}


@dataclass(frozen=True)
class TensorInfo:
    name: str
    dtype: str
    shape: tuple
    start: int  # absolute offset into the buffer
    end: int

    @property
    def nbytes(self) -> int:
        return self.end - self.start


class SafeTensors:
    """Parsed view over one safetensors blob (file or in-archive slice)."""

    def __init__(self, buf, base_offset: int = 0, length: Optional[int] = None):
        self._buf = buf
        self._owned: Dict[str, np.ndarray] = {}
        header_len = struct.unpack_from("<Q", buf, base_offset)[0]
        header = bytes(memoryview(buf)[base_offset + 8: base_offset + 8 + header_len])
        meta = json.loads(header)
        meta.pop("__metadata__", None)
        data_start = base_offset + 8 + header_len
        self.tensors: Dict[str, TensorInfo] = {}
        for name, info in meta.items():
            s, e = info["data_offsets"]
            self.tensors[name] = TensorInfo(name=name, dtype=info["dtype"],
                                            shape=tuple(info["shape"]),
                                            start=data_start + s, end=data_start + e)

    @classmethod
    def from_file(cls, path: str, parallel_read: bool = False) -> "SafeTensors":
        """``parallel_read``: read every tensor's bytes into owned buffers
        with the native threaded span reader (io/native.py) instead of
        faulting the mmap's pages in on first touch; the mmap views stay
        when the native library is unavailable, as in JAX."""
        with open(path, "rb") as f:
            buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        st = cls(buf)
        if parallel_read and st.tensors:
            from .native import read_spans

            infos = sorted(st.tensors.values(), key=lambda t: t.start)
            bufs = read_spans(path, [t.start for t in infos], [t.nbytes for t in infos])
            if bufs is not None:
                st._owned = {t.name: b for t, b in zip(infos, bufs)}
        return st

    def keys(self):
        return self.tensors.keys()

    def __contains__(self, name: str) -> bool:
        return name in self.tensors

    def info(self, name: str) -> TensorInfo:
        return self.tensors[name]

    def numpy(self, name: str) -> np.ndarray:
        """A zero-copy numpy view of the stored bytes (bf16 and fp8 as their
        unsigned-integer bits), or of the owned buffer of a parallel read."""
        ti = self.tensors[name]
        dt = np.dtype(_DTYPES[ti.dtype][0])
        owned = self._owned.get(name)
        if owned is not None:
            return owned.view(dt).reshape(ti.shape)
        arr = np.frombuffer(self._buf, dtype=dt, count=ti.nbytes // dt.itemsize,
                            offset=ti.start)
        return arr.reshape(ti.shape)

    def tensor(self, name: str) -> torch.Tensor:
        """A zero-copy host torch view with the stored dtype."""
        ti = self.tensors[name]
        t = torch.from_numpy(self.numpy(name))
        return t.view(_DTYPES[ti.dtype][1]) if ti.dtype in _BITS_ONLY else t


_NP_NAMES = {np.dtype(v[0]): k for k, v in _DTYPES.items() if k not in _BITS_ONLY}
_TORCH_NAMES = {v[1]: k for k, v in _DTYPES.items()}


def save_safetensors(path: str, tensors: Dict[str, object]):
    """Minimal safetensors writer; values are numpy arrays or torch tensors
    (bf16 included)."""
    header = {}
    offset = 0
    blobs = []
    for name, arr in tensors.items():
        if isinstance(arr, torch.Tensor):
            t = arr.detach().cpu().contiguous()
            dtype = _TORCH_NAMES[t.dtype]
            raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
            shape = list(t.shape)
        else:
            a = np.ascontiguousarray(arr)
            dtype = _NP_NAMES[a.dtype]
            raw = a.tobytes()
            shape = list(a.shape)
        header[name] = {"dtype": dtype, "shape": shape,
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    hdr = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hdr)))
        f.write(hdr)
        for raw in blobs:
            f.write(raw)

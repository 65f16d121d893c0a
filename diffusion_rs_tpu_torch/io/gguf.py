"""GGUF file reader (v1-v3) and a minimal v3 writer (the port's own copy of
``diffusion_rs_tpu/io/gguf.py``).

Magic/version header, typed key-value metadata, tensor infos (name, dims,
ggml type, offset), and a data section aligned to ``general.alignment``
(default 32). Tensors come out as views into one read-only-to-disk mmap:
raw bytes plus (format, shape) for the quantized formats, which
quant/gguf_quants.py canonicalizes, and dense numpy/torch views for the
rest. bf16 needs no ``ml_dtypes``: :meth:`GgufFile.tensor` views its bits as
``torch.bfloat16``.
"""

from __future__ import annotations

import mmap
import struct
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np
import torch

GGUF_MAGIC = 0x46554747  # "GGUF" little-endian

# ggml_type id -> (name, block_elems, block_bytes); dense types map directly.
GGML_TYPES: Dict[int, Tuple[str, int, int]] = {
    0: ("f32", 1, 4),
    1: ("f16", 1, 2),
    2: ("q4_0", 32, 18),
    3: ("q4_1", 32, 20),
    6: ("q5_0", 32, 22),
    7: ("q5_1", 32, 24),
    8: ("q8_0", 32, 34),
    9: ("q8_1", 32, 36),
    10: ("q2_k", 256, 84),
    11: ("q3_k", 256, 110),
    12: ("q4_k", 256, 144),
    13: ("q5_k", 256, 176),
    14: ("q6_k", 256, 210),
    15: ("q8_k", 256, 292),
    24: ("i8", 1, 1),
    25: ("i16", 1, 2),
    26: ("i32", 1, 4),
    27: ("i64", 1, 8),
    28: ("f64", 1, 8),
    30: ("bf16", 1, 2),
}

# Dense formats: numpy dtype of the stored bits (bf16 as its uint16 bits)
# and the torch dtype a tensor view takes.
DENSE = {
    "f32": (np.float32, torch.float32), "f16": (np.float16, torch.float16),
    "f64": (np.float64, torch.float64), "i8": (np.int8, torch.int8),
    "i16": (np.int16, torch.int16), "i32": (np.int32, torch.int32),
    "i64": (np.int64, torch.int64), "bf16": (np.uint16, torch.bfloat16),
}


@dataclass(frozen=True)
class GgufTensorInfo:
    name: str
    shape: tuple  # logical row-major (torch order: [out, in] for matrices)
    fmt: str
    start: int
    nbytes: int


class _Reader:
    def __init__(self, buf):
        self.buf = buf
        self.pos = 0

    def read(self, fmt: str):
        vals = struct.unpack_from("<" + fmt, self.buf, self.pos)
        self.pos += struct.calcsize("<" + fmt)
        return vals if len(vals) > 1 else vals[0]

    def read_string(self, version: int) -> str:
        n = self.read("Q" if version >= 2 else "I")
        s = bytes(memoryview(self.buf)[self.pos: self.pos + n])
        self.pos += n
        return s.decode("utf-8", errors="replace")

    def read_value(self, ty: int, version: int) -> Any:
        simple = {
            0: "B", 1: "b", 2: "H", 3: "h", 4: "I", 5: "i", 6: "f",
            7: "?", 10: "Q", 11: "q", 12: "d",
        }
        if ty in simple:
            return self.read(simple[ty])
        if ty == 8:  # string
            return self.read_string(version)
        if ty == 9:  # array
            elem_ty = self.read("I")
            n = self.read("Q" if version >= 2 else "I")
            return [self.read_value(elem_ty, version) for _ in range(n)]
        raise ValueError(f"unknown gguf kv type {ty}")


class GgufFile:
    def __init__(self, path: str):
        # Copy-on-write mapping: views are writable for torch.from_numpy
        # (no copy, no warning) and nothing ever reaches the file.
        with open(path, "rb") as f:
            self._mmap = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        r = _Reader(self._mmap)
        magic = r.read("I")
        if magic != GGUF_MAGIC:
            raise ValueError(f"not a GGUF file: magic {magic:#x}")
        self.version = r.read("I")
        if self.version not in (1, 2, 3):
            raise ValueError(f"unsupported GGUF version {self.version}")
        cnt_fmt = "Q" if self.version >= 2 else "I"
        n_tensors = r.read(cnt_fmt)
        n_kv = r.read(cnt_fmt)
        self.metadata: Dict[str, Any] = {}
        for _ in range(n_kv):
            key = r.read_string(self.version)
            ty = r.read("I")
            self.metadata[key] = r.read_value(ty, self.version)
        infos = []
        for _ in range(n_tensors):
            name = r.read_string(self.version)
            n_dims = r.read("I")
            dims = [r.read(cnt_fmt) for _ in range(n_dims)]
            ggml_ty = r.read("I")
            offset = r.read("Q" if self.version >= 2 else "I")
            if ggml_ty not in GGML_TYPES:
                raise ValueError(f"unsupported ggml dtype {ggml_ty} for {name}")
            fmt, be, bb = GGML_TYPES[ggml_ty]
            # GGUF dims are innermost-first; logical torch order reverses.
            shape = tuple(reversed(dims))
            n_elems = int(np.prod(shape)) if shape else 1
            infos.append((name, shape, fmt, offset, n_elems // be * bb))
        align = int(self.metadata.get("general.alignment", 32))
        data_start = (r.pos + align - 1) // align * align
        self.tensors: Dict[str, GgufTensorInfo] = {
            name: GgufTensorInfo(name, shape, fmt, data_start + off, nbytes)
            for (name, shape, fmt, off, nbytes) in infos
        }

    def __contains__(self, name):
        return name in self.tensors

    def keys(self):
        return self.tensors.keys()

    def raw(self, name: str) -> np.ndarray:
        ti = self.tensors[name]
        return np.frombuffer(self._mmap, np.uint8, count=ti.nbytes, offset=ti.start)

    def numpy(self, name: str) -> np.ndarray:
        """A dense tensor as a numpy view (bf16 as its uint16 bits); quantized
        tensors go through ``raw`` and quant/gguf_quants.py."""
        ti = self.tensors[name]
        if ti.fmt not in DENSE:
            raise ValueError(f"{name} is quantized ({ti.fmt}); use raw()")
        return self.raw(name).view(DENSE[ti.fmt][0]).reshape(ti.shape)

    def tensor(self, name: str) -> torch.Tensor:
        """A dense tensor as a host torch view with its own dtype."""
        ti = self.tensors[name]
        arr = self.numpy(name)
        t = torch.from_numpy(arr)
        return t.view(torch.bfloat16) if ti.fmt == "bf16" else t


def write_gguf(path: str, tensors: Dict[str, tuple], metadata: Dict[str, Any] = None):
    """Minimal GGUF v3 writer. ``tensors`` maps name -> (fmt, shape,
    raw_bytes); ``metadata`` values are bool, int, float or str."""
    name_to_tid = {v[0]: k for k, v in GGML_TYPES.items()}
    metadata = metadata or {}
    align = 32
    blobs = [_byte_view(raw) for _, _, raw in tensors.values()]
    with open(path, "wb") as f:
        out = bytearray()
        out += struct.pack("<IIQQ", GGUF_MAGIC, 3, len(tensors), len(metadata))
        for k, v in metadata.items():
            kb = k.encode()
            out += struct.pack("<Q", len(kb)) + kb
            if isinstance(v, bool):
                out += struct.pack("<I?", 7, v)
            elif isinstance(v, int):
                out += struct.pack("<Iq", 11, v)
            elif isinstance(v, float):
                out += struct.pack("<Id", 12, v)
            elif isinstance(v, str):
                vb = v.encode()
                out += struct.pack("<IQ", 8, len(vb)) + vb
            else:
                raise ValueError(f"unsupported metadata type {type(v)}")
        offset = 0
        for (name, (fmt, shape, _)), blob in zip(tensors.items(), blobs):
            nb = name.encode()
            out += struct.pack("<Q", len(nb)) + nb
            dims = list(reversed(shape))
            out += struct.pack("<I", len(dims))
            for d in dims:
                out += struct.pack("<Q", d)
            out += struct.pack("<IQ", name_to_tid[fmt], offset)
            offset += (len(blob) + align - 1) // align * align
        out += b"\x00" * ((-len(out)) % align)
        f.write(out)
        # tensor data streams straight from the callers' buffers
        for blob in blobs:
            f.write(blob)
            f.write(b"\x00" * ((-len(blob)) % align))


def _byte_view(raw) -> memoryview:
    """bytes, bytearray or a numpy array as a flat byte view."""
    if isinstance(raw, np.ndarray):
        raw = np.ascontiguousarray(raw).reshape(-1).view(np.uint8)
    return memoryview(raw).cast("B")

"""Legacy (pre-GGUF) GGML container reader and a minimal writer (the port's
own copy of ``diffusion_rs_tpu/io/ggml.py``).

The old llama.cpp single-file format (reference
diffusion_rs_common/src/core/quantized/ggml_file.rs): a magic ("ggml"
unversioned, "ggmf" or "ggjt" + u32 version), llama hyperparameters, an
inline vocab, then raw tensor records (n_dims, name_len, dtype, dims
innermost-first, name bytes, data; 32-byte aligned for ggjt) until the end
of the file. Tensors come out with the GGUF reader's ``GgufTensorInfo`` and
views (``raw``, ``numpy``, ``tensor``), so quant/gguf_quants.py
canonicalizes both containers alike.
"""

from __future__ import annotations

import math
import mmap
import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .gguf import DENSE, GGML_TYPES, GgufTensorInfo

MAGIC_GGML = 0x67676D6C  # unversioned
MAGIC_GGMF = 0x67676D66  # versioned (v1)
MAGIC_GGJT = 0x67676A74  # versioned (v1-3), 32-byte aligned tensor data


@dataclass(frozen=True)
class GgmlHParams:
    """Llama hyperparameters baked into the container (ggml_file.rs)."""

    n_vocab: int
    n_embd: int
    n_mult: int
    n_head: int
    n_layer: int
    n_rot: int
    ftype: int


class GgmlFile:
    """A view over a legacy .ggml / .ggmf / .ggjt file (one mmap)."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            self._mmap = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        buf = self._mmap
        pos = 0

        def read(fmt: str):
            nonlocal pos
            vals = struct.unpack_from("<" + fmt, buf, pos)
            pos += struct.calcsize("<" + fmt)
            return vals if len(vals) > 1 else vals[0]

        magic = read("I")
        if magic not in (MAGIC_GGML, MAGIC_GGMF, MAGIC_GGJT):
            raise ValueError(f"not a legacy GGML file: magic {magic:#x}")
        self.magic = magic
        self.version = 0 if magic == MAGIC_GGML else read("I")
        if magic == MAGIC_GGMF and self.version != 1:
            raise ValueError(f"unsupported ggmf version {self.version}")
        if magic == MAGIC_GGJT and self.version not in (1, 2, 3):
            raise ValueError(f"unsupported ggjt version {self.version}")

        self.hparams = GgmlHParams(*read("7I"))
        # vocab: (len, bytes[, score]) x n_vocab; unversioned files have no scores
        scored = magic != MAGIC_GGML
        self.vocab: List[Tuple[bytes, float]] = []
        for _ in range(self.hparams.n_vocab):
            n = read("I")
            tok = bytes(buf[pos:pos + n])
            pos += n
            self.vocab.append((tok, read("f") if scored else 0.0))

        self.tensors: Dict[str, GgufTensorInfo] = {}
        while pos < len(buf):
            n_dims, name_len, ggml_ty = read("III")
            dims = [read("I") for _ in range(n_dims)]
            name = bytes(buf[pos:pos + name_len]).decode("utf-8", errors="replace")
            pos += name_len
            if magic == MAGIC_GGJT:
                pos = (pos + 31) // 32 * 32
            if ggml_ty not in GGML_TYPES:
                raise ValueError(f"unsupported ggml dtype {ggml_ty} for {name}")
            fmt, be, bb = GGML_TYPES[ggml_ty]
            shape = tuple(reversed(dims))  # innermost-first -> torch order
            n_elems = math.prod(shape)
            if n_elems % be != 0:
                raise ValueError(f"{name}: {n_elems} elems not /{be} blocks")
            nbytes = n_elems // be * bb
            self.tensors[name] = GgufTensorInfo(name, shape, fmt, pos, nbytes)
            pos += nbytes

    def __contains__(self, name):
        return name in self.tensors

    def keys(self):
        return self.tensors.keys()

    def raw(self, name: str) -> np.ndarray:
        ti = self.tensors[name]
        return np.frombuffer(self._mmap, np.uint8, count=ti.nbytes, offset=ti.start)

    def numpy(self, name: str) -> np.ndarray:
        """A dense tensor as a numpy view (bf16 as its uint16 bits);
        quantized tensors go through ``raw`` and quant/gguf_quants.py."""
        ti = self.tensors[name]
        if ti.fmt not in DENSE:
            raise ValueError(f"{name} is quantized ({ti.fmt}); use raw()")
        return self.raw(name).view(DENSE[ti.fmt][0]).reshape(ti.shape)

    def tensor(self, name: str) -> torch.Tensor:
        """A dense tensor as a host torch view with its own dtype."""
        t = torch.from_numpy(self.numpy(name))
        return t.view(torch.bfloat16) if self.tensors[name].fmt == "bf16" else t


def write_ggml(path: str, tensors: Dict[str, tuple], hparams: Optional[GgmlHParams] = None,
               vocab: Optional[List[Tuple[bytes, float]]] = None, magic: int = MAGIC_GGJT,
               version: int = 3):
    """Minimal legacy-GGML writer (format round trips). ``tensors`` maps
    name -> (fmt, shape, raw bytes)."""
    name_to_tid = {v[0]: k for k, v in GGML_TYPES.items()}
    vocab = vocab or []
    hparams = hparams or GgmlHParams(len(vocab), 0, 0, 0, 0, 0, 0)
    parts = [struct.pack("<I", magic)]
    if magic != MAGIC_GGML:
        parts.append(struct.pack("<I", version))
    parts.append(struct.pack("<7I", hparams.n_vocab, hparams.n_embd, hparams.n_mult,
                             hparams.n_head, hparams.n_layer, hparams.n_rot, hparams.ftype))
    for tok, score in vocab:
        parts += [struct.pack("<I", len(tok)), tok]
        if magic != MAGIC_GGML:
            parts.append(struct.pack("<f", score))
    pos = sum(len(p) for p in parts)
    for name, (fmt, shape, raw) in tensors.items():
        nb = name.encode("utf-8")
        dims = list(reversed(shape))
        parts += [struct.pack("<III", len(dims), len(nb), name_to_tid[fmt]),
                  struct.pack(f"<{len(dims)}I", *dims), nb]
        pos += 12 + 4 * len(dims) + len(nb)
        if magic == MAGIC_GGJT:
            pad = (pos + 31) // 32 * 32 - pos
            parts.append(b"\0" * pad)
            pos += pad
        raw = bytes(raw)
        parts.append(raw)
        pos += len(raw)
    with open(path, "wb") as f:
        f.write(b"".join(parts))

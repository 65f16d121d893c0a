"""llama.cpp importance-matrix (imatrix) files (the port's own copy of
``diffusion_rs_tpu/io/imatrix.py``, byte-compatible with it).

A little-endian stream: ``n_entries`` i32, then per entry ``name_len`` i32,
the name's UTF-8 bytes, ``ncall`` i32, ``nval`` i32 and ``nval`` f32 values;
values are divided by ``ncall`` when it is positive. The vectors weight the
error that ISQ minimizes (quant/isq.py).
"""

from __future__ import annotations

import struct
from typing import Dict

import numpy as np


def load_imatrix(path: str) -> Dict[str, np.ndarray]:
    """name -> f32 importance vector (per input feature)."""
    with open(path, "rb") as f:
        buf = f.read()
    pos = 0

    def read_i32():
        nonlocal pos
        (v,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        return v

    n_entries = read_i32()
    if n_entries < 1:
        raise ValueError(f"no data in imatrix file {path}")
    out: Dict[str, np.ndarray] = {}
    for i in range(n_entries):
        name_len = read_i32()
        name = buf[pos:pos + name_len].decode("utf-8")
        pos += name_len
        ncall = read_i32()
        nval = read_i32()
        if nval < 1:
            raise ValueError(f"invalid nval for entry {i + 1}: {nval}")
        vals = np.frombuffer(buf, np.float32, count=nval, offset=pos).copy()
        pos += 4 * nval
        if ncall > 0:
            vals /= np.float32(ncall)
        out[name] = vals
    return out


def save_imatrix(path: str, data: Dict[str, np.ndarray], ncall: int = 0) -> None:
    """Write ``data`` so that :func:`load_imatrix` reads it back; with
    ``ncall`` > 0 the stored values are the vectors times ``ncall``."""
    parts = [struct.pack("<i", len(data))]
    for name, vals in data.items():
        nb = name.encode("utf-8")
        vals = np.asarray(vals, np.float32)
        parts.append(struct.pack("<i", len(nb)))
        parts.append(nb)
        parts.append(struct.pack("<ii", ncall, vals.size))
        parts.append((vals * (ncall if ncall > 0 else 1)).astype("<f4").tobytes())
    with open(path, "wb") as f:
        f.write(b"".join(parts))

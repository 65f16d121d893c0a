"""Legacy tensor containers: npy / npz and PyTorch pickles (the port's own
copy of ``diffusion_rs_tpu/io/legacy_formats.py``).

Reference parity: diffusion_rs_common/src/core/npy.rs (npy / npz read and
write) and core/pickle.rs (.pt / .pth reader). numpy owns the npy format
and torch the pickle one, so these are thin adapters: npy / npz as numpy
arrays, pickles as host torch tensors (bf16 stays bf16), which
``VarStore.add_tensor`` takes directly.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def read_npy(path: str) -> np.ndarray:
    return np.load(path, allow_pickle=False)


def read_npz(path: str) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def write_npy(path: str, arr: np.ndarray) -> None:
    np.save(path, arr, allow_pickle=False)


def write_npz(path: str, tensors: Dict[str, np.ndarray]) -> None:
    np.savez(path, **tensors)


def read_pytorch(path: str) -> Dict[str, torch.Tensor]:
    """A .pt / .pth checkpoint (the zip container and the legacy one) as
    name -> host tensor, with tensors only (``weights_only``): other entries
    are skipped, nested state dicts flattened with dot-joined keys."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    out: Dict[str, torch.Tensor] = {}

    def walk(prefix: str, val):
        if isinstance(val, torch.Tensor):
            out[prefix] = val.detach()
        elif isinstance(val, dict):
            for k, v in val.items():
                walk(f"{prefix}.{k}" if prefix else str(k), v)

    walk("", obj)
    return out


def add_pytorch_to_store(store, path: str, prefix: str = ""):
    """Add a .pt / .pth checkpoint's tensors to a VarStore (the reference's
    varbuilder loading for pickle checkpoints)."""
    for name, t in read_pytorch(path).items():
        store.add_tensor(prefix + name, t)

"""Auto-dtype resolution (port of the JAX package's ``util/dtype.py``).

``ModelDType.Auto`` resolves here: on a CUDA device bf16 when the card
supports it; otherwise the first of bf16, f16, f32 whose 2x2 matmul runs
on the device (the reference's probe order, auto_dtype.rs).
"""

from __future__ import annotations

import torch

from .device import resolve_device


def resolve_auto_dtype(device="cuda") -> torch.dtype:
    dev = resolve_device(device)
    candidates = (torch.bfloat16, torch.float16, torch.float32)
    if dev.type == "cuda":
        if torch.cuda.is_bf16_supported():
            return torch.bfloat16
        candidates = candidates[1:]
    for dt in candidates:
        try:
            a = torch.ones((2, 2), dtype=dt, device=dev)
            (a @ a).cpu()
            return dt
        except RuntimeError:
            continue
    return torch.float32

"""Device selection for the port's entry points.

Entry points default to ``device="cuda"``. Without a CUDA device they raise:
the port never moves work to the CPU on its own. Tests pass ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "diffusion_rs_tpu_torch: CUDA device requested but torch.cuda is "
            "not available; pass device='cpu' explicitly to run the plain "
            "PyTorch paths"
        )
    return dev

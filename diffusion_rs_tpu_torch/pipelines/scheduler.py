"""FlowMatchEulerDiscrete scheduler (the port's own copy of
``pipelines/scheduler.py``): the sigma grid is host-side numpy."""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    scheduler_type: str = "FlowMatchEulerDiscreteScheduler"
    base_image_seq_len: int = 256
    base_shift: float = 0.5
    max_image_seq_len: int = 4096
    max_shift: float = 1.15
    shift: float = 1.0
    use_dynamic_shifting: bool = False

    @staticmethod
    def from_json(d: dict) -> "SchedulerConfig":
        """scheduler/scheduler_config.json."""
        return SchedulerConfig(
            scheduler_type=d.get("_class_name", "FlowMatchEulerDiscreteScheduler"),
            base_image_seq_len=d.get("base_image_seq_len", 256),
            base_shift=d.get("base_shift", 0.5),
            max_image_seq_len=d.get("max_image_seq_len", 4096),
            max_shift=d.get("max_shift", 1.15),
            shift=d.get("shift", 1.0),
            use_dynamic_shifting=d.get("use_dynamic_shifting", False),
        )

    def timesteps(self, num_steps: int, mu: Optional[float] = None) -> np.ndarray:
        """Sigma grid 1 -> 0 with time shift; num_steps+1 f32 values.

        Dynamic: sigma' = e^mu / (e^mu + (1/sigma - 1))
        Static:  sigma' = shift*sigma / (1 + (shift-1)*sigma)
        """
        if self.scheduler_type != "FlowMatchEulerDiscreteScheduler":
            raise ValueError(f"unsupported scheduler {self.scheduler_type}")
        sigmas = np.linspace(1.0, 0.0, num_steps + 1)
        if self.use_dynamic_shifting:
            if mu is None:
                raise ValueError("mu is required for dynamic shifting")
            e = math.exp(mu)
            with np.errstate(divide="ignore"):
                shifted = e / (e + (1.0 / sigmas - 1.0))
            shifted[sigmas == 0.0] = 0.0
            sigmas = shifted
        else:
            sigmas = self.shift * sigmas / (1.0 + (self.shift - 1.0) * sigmas)
        return sigmas.astype(np.float32)


def calculate_shift(image_seq_len: int, base_seq_len: int = 256,
                    max_seq_len: int = 4096, base_shift: float = 0.5,
                    max_shift: float = 1.15) -> float:
    """Resolution-dependent mu, from the packed image sequence length."""
    m = (max_shift - base_shift) / (max_seq_len - base_seq_len)
    b = base_shift - m * base_seq_len
    return image_seq_len * m + b

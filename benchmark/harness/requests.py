"""What a traffic generator hands the harness: one request per image."""

from __future__ import annotations

import dataclasses
import string
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Request:
    index: int
    prompt: str
    seed: int            # the request's own image seed
    height: int
    width: int
    due_s: Optional[float] = None  # offset of its arrival from the window's start (open loop)


def prompt(rng: np.random.Generator, lo: int, hi: int, tag: str = "") -> str:
    """``lo`` to ``hi`` words of 2 to 9 lower-case letters (the last one
    ``tag`` when given)."""
    n = int(rng.integers(lo, hi + 1))
    lens = rng.integers(2, 10, size=n)
    codes = rng.integers(0, 26, size=int(lens.sum()))
    text = "".join(string.ascii_lowercase[c] for c in codes)
    ends = np.cumsum(lens)
    words = [text[e - k:e] for e, k in zip(ends, lens)]
    if tag:
        words[-1] = tag
    return " ".join(words)


def image_seed(rng: np.random.Generator) -> int:
    return int(rng.integers(0, 2 ** 31 - 1))

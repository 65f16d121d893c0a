"""Batch tokenization (the port's own copy of ``tokenize_and_pad``)."""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def tokenize_and_pad(prompts: List[str], tokenizer,
                     pad_to: Optional[int] = None) -> np.ndarray:
    """Batch-encode and zero-pad to the batch max, or to ``pad_to`` exactly
    (longer prompts are an error then)."""
    encs = tokenizer.encode_batch(prompts)
    ids = [e.ids for e in encs]
    max_len = max(len(x) for x in ids)
    if pad_to is not None:
        if max_len > pad_to:
            raise ValueError(
                f"T5 embedding length {max_len} greater than {pad_to}; shrink "
                "the prompt or use the -dev (guidance-distilled) model"
            )
        max_len = pad_to
    out = np.zeros((len(ids), max_len), np.int32)
    for i, row in enumerate(ids):
        out[i, : len(row)] = row
    return out

"""Tokenizer loading and batch tokenization (the port's own copy of
``diffusion_rs_tpu/io/tokenizer.py``).

CLIP is a bare BPE built from vocab.json + merges.txt, T5 comes from
tokenizer.json. Both load through the ``tokenizers`` package, imported only
when a tokenizer is loaded: synthetic-weight runs use
``util.synthetic.WordTokenizer`` and need no ``tokenizers``.
"""

from __future__ import annotations

import json
from typing import List, Optional

import numpy as np


def load_t5_tokenizer_from_bytes(data: bytes):
    from tokenizers import Tokenizer

    return Tokenizer.from_str(data.decode("utf-8"))


def load_t5_tokenizer(path: str):
    from tokenizers import Tokenizer

    return Tokenizer.from_file(path)


def load_clip_bpe_tokenizer(vocab_json: bytes, merges_txt: bytes):
    """Bare BPE over vocab + merges; the first merges line (the "#version"
    header) is skipped."""
    from tokenizers import Tokenizer
    from tokenizers.models import BPE

    vocab = json.loads(vocab_json)
    merges = []
    for line in merges_txt.decode("utf-8").split("\n")[1:]:
        parts = line.split(" ")
        if len(parts) == 2:
            merges.append((parts[0], parts[1]))
    return Tokenizer(BPE(vocab, merges))


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

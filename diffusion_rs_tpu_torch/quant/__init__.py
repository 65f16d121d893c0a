from .bnb import NF4_CODEBOOK
from .qtensor import (
    QuantizedTensor,
    choose_split,
    dequantize,
    pack4,
    quantize_q8_tile,
    unpack4,
)

__all__ = [
    "NF4_CODEBOOK",
    "QuantizedTensor",
    "choose_split",
    "dequantize",
    "pack4",
    "quantize_q8_tile",
    "unpack4",
]

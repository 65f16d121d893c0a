"""bitsandbytes 4-bit codebooks (the port's own copy of the NF4 table).

Values are the bitsandbytes NF4 normal-map entries, indexed by the 4-bit
code; the nf4 kernel (ops/qmatmul.py) decodes through this table.
"""

from __future__ import annotations

import numpy as np

NF4_CODEBOOK = np.array(
    [
        -1.0,
        -0.6961928009986877,
        -0.5250730514526367,
        -0.39491748809814453,
        -0.28444138169288635,
        -0.18477343022823334,
        -0.09105003625154495,
        0.0,
        0.07958029955625534,
        0.16093020141124725,
        0.24611230194568634,
        0.33791524171829224,
        0.44070982933044434,
        0.5626170039176941,
        0.7229568362236023,
        1.0,
    ],
    dtype=np.float32,
)

from ._cuda import launch_counts, reset_launch_counts
from .attention import sdpa, sdpa_merged, sdpa_xla
from .conv import Conv, conv2d, upsample_nearest_2x
from .flash import flash_attention, flash_attention_fused, flash_attention_plain
from .linear import Linear, linear, linear_grouped
from .norms import group_norm, layer_norm, rms_norm
from .qmatmul import quantized_matmul, quantized_matmul_grouped, supports
from .rope import (apply_rope, apply_rope_halfsplit, expand_rope_tables, qk_norm_rope,
                   rope_tables)

__all__ = [
    "Conv",
    "Linear",
    "apply_rope",
    "apply_rope_halfsplit",
    "conv2d",
    "expand_rope_tables",
    "flash_attention",
    "flash_attention_fused",
    "flash_attention_plain",
    "group_norm",
    "launch_counts",
    "layer_norm",
    "linear",
    "linear_grouped",
    "qk_norm_rope",
    "quantized_matmul",
    "quantized_matmul_grouped",
    "reset_launch_counts",
    "rms_norm",
    "rope_tables",
    "sdpa",
    "sdpa_merged",
    "sdpa_xla",
    "supports",
    "upsample_nearest_2x",
]

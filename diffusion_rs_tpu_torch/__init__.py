"""PyTorch/CUDA port of ``diffusion_rs_tpu`` for one NVIDIA H100.

The package mirrors the JAX package's layout (``quant/``, ``ops/``,
``models/``, ``pipelines/``, ``util/``) and never imports jax or the JAX
package. Every Pallas kernel on the ported path is a hand-written CUDA kernel
under ``csrc/``, built with nvcc for sm_90a at first launch; each sits beside
a plain PyTorch version that CPU tensors take. Entry points default to
``device="cuda"`` and raise when CUDA is absent.
"""

from .pipelines.api import ModelDType, ModelSource, Offloading, Pipeline
from .pipelines.flux_pipeline import DiffusionGenerationParams, FluxPipeline

__all__ = ["DiffusionGenerationParams", "FluxPipeline", "ModelDType", "ModelSource",
           "Offloading", "Pipeline"]

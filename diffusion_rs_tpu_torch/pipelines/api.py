"""Public API surface (port of ``diffusion_rs_tpu/pipelines/api.py``):
``Pipeline(ModelSource...)`` and ``forward(prompts, params) -> list[bytes]``
of PNG-encoded images, with ``ModelSource`` naming a hub id or local
directory (optionally with a separate transformer: another repo, or a
single-file GGUF), or a DDUF zip.

The port's own differences: ``device`` (CUDA by default; raises without
it), PNG encoding with the standard library (no Pillow), and
``forward_images`` / ``img2img_images`` / ``inpaint_images`` returning u8
``[H, W, 3]`` arrays instead of PIL images. img2img and inpainting import
Pillow only to resize an init image or mask that is not already at size.
"""

from __future__ import annotations

import enum
import io
import struct
import zlib
from dataclasses import dataclass
from typing import List, Optional, Sequence, Union

import numpy as np

from .flux_pipeline import DiffusionGenerationParams


class Offloading(enum.Enum):
    """Memory-capacity modes: ``Full`` keeps every component in pinned host
    memory and copies each to the device around its use
    (parallel.HostOffload); ``Stream`` keeps the transformer's blocks in
    host memory and streams them to the device block by block during the
    denoise (models/flux_streaming.StreamedFlux,
    DIFFUSION_RS_TPU_STREAM_LOOKAHEAD blocks ahead, default 2), the
    encoders and the VAE resident. ``Stream`` refuses a mesh and
    inpainting."""

    Full = "full"
    Stream = "stream"


class ModelDType(enum.Enum):
    """``Auto`` resolves on the target device (util/dtype.resolve_auto_dtype):
    bf16 on a card that supports it, else the first of bf16, f16, f32 that
    the device runs."""

    Auto = "auto"
    BF16 = "bf16"
    F16 = "f16"
    F32 = "f32"


@dataclass(frozen=True)
class ModelSource:
    """Where model files come from."""

    model_id: Optional[str] = None  # hub id or local directory
    transformer_model_id: Optional[str] = None  # transformer override (repo or .gguf)
    dduf_file: Optional[str] = None  # path to a .dduf zip

    @staticmethod
    def from_model_id(model_id: str,
                      transformer_model_id: Optional[str] = None) -> "ModelSource":
        return ModelSource(model_id=model_id, transformer_model_id=transformer_model_id)

    @staticmethod
    def dduf(path: str) -> "ModelSource":
        return ModelSource(dduf_file=path)


def encode_png(img: np.ndarray) -> bytes:
    """u8 RGB ``[H, W, 3]`` -> PNG bytes (8-bit truecolour, no filtering),
    with zlib and struct only."""
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected u8 [H, W, 3], got {img.dtype} {img.shape}")
    h, w, _ = img.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(img).reshape(h, w * 3)], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def decode_image(data: bytes):
    """Encoded image bytes (PNG, JPEG, ...) -> a PIL image, for init images
    and masks read from files or requests; the one place besides resizing
    where the port needs Pillow."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("decoding an image file needs Pillow (pip install Pillow); "
                          "pass u8 arrays to the Python API to skip it") from e
    return Image.open(io.BytesIO(data))


class Pipeline:
    """Load a FLUX pipeline and generate images. ``forward`` returns one PNG
    (``bytes``) per prompt.

    ``fuse`` (None: DIFFUSION_RS_TPU_FUSE, else none; True / "all": img,
    txt, single and t5; or a comma list of those and "grouped") and the
    environment's DIFFUSION_RS_TPU_FUSED_ROPE=1 / DIFFUSION_RS_TPU_ATTN_LAYOUT
    work as in the JAX package (loader.apply_layout_options), and so do
    ``isq`` (in-situ quantization to one of quant/isq.SUPPORTED, on the
    weights' device), ``isq_t5`` (T5's own target; by default T5 follows
    ``isq`` unless the capacity guard keeps it), ``imatrix`` (a llama.cpp
    importance-matrix file weighting ISQ), ``lora`` (one LoRA file or a
    list) and ``lora_scale`` (loader.apply_weight_options). ``mesh`` (a
    parallel.make_mesh built on every rank after parallel.init_multihost)
    runs the pipeline data-, sequence- and tensor-parallel: under tp each
    rank holds its own slices of the FLUX and T5 weights
    (parallel/sharding.py), under dp and sp the whole weights.
    ``t5_mask_pads`` (mask T5's pad keys; None:
    DIFFUSION_RS_TPU_T5_MASK_PADS=1) and ``step_progress`` (a line per
    denoise step; None: DIFFUSION_RS_TPU_PROGRESS) resolve once, at
    construction. ``offloading`` (an :class:`Offloading`) keeps the
    weights in host memory. ``compile_cache`` (or
    DIFFUSION_RS_TPU_COMPILE_CACHE) is the directory the CUDA kernels are
    built into and loaded from, kept across processes
    (util/compile_cache.py)."""

    def __init__(
        self,
        source: ModelSource,
        silent: bool = False,
        token: Optional[str] = None,
        revision: Optional[str] = None,
        offloading: Optional[Offloading] = None,
        dtype: ModelDType = ModelDType.Auto,
        isq: Optional[str] = None,
        isq_t5: Optional[str] = None,
        imatrix: Optional[str] = None,
        lora: Union[str, Sequence[str], None] = None,
        lora_scale: Union[float, Sequence[float]] = 1.0,
        mesh=None,
        t5_mask_pads: Optional[bool] = None,
        step_progress: Optional[bool] = None,
        compile_cache: Optional[str] = None,
        fuse: Union[bool, str, Sequence[str], None] = None,
        device="cuda",
    ):
        from .loader import load_pipeline

        self._inner = load_pipeline(
            source, silent=silent, token=token, revision=revision,
            offloading=offloading, dtype=dtype, isq=isq, isq_t5=isq_t5,
            imatrix=imatrix, lora=lora, lora_scale=lora_scale, mesh=mesh,
            t5_mask_pads=t5_mask_pads, step_progress=step_progress,
            compile_cache=compile_cache, fuse=fuse, device=device,
        )

    def forward(self, prompts: Sequence[str],
                params: DiffusionGenerationParams) -> List[bytes]:
        return [encode_png(img) for img in self.forward_images(prompts, params)]

    def forward_images(self, prompts: Sequence[str],
                       params: DiffusionGenerationParams) -> List[np.ndarray]:
        """One u8 ``[H, W, 3]`` array per prompt."""
        arr = self._inner.forward_arrays(list(prompts), params)
        return [arr[i] for i in range(arr.shape[0])]

    def forward_latents(self, prompts: Sequence[str],
                        params: DiffusionGenerationParams) -> np.ndarray:
        """Post-denoise packed latents ``[B, S, 64]`` as f32 (no VAE decode)."""
        return self._inner.forward_arrays(list(prompts), params, output_type="latent")

    def img2img(self, prompts: Sequence[str], params: DiffusionGenerationParams, image,
                strength: float = 0.6) -> List[bytes]:
        """Image-to-image: start the flow-match schedule from a VAE-encoded
        init image (PIL image or u8 array, or a list of them, one per prompt)
        instead of pure noise; ``strength`` in (0, 1] is the share of the
        schedule run (1.0 degenerates to text-to-image). Returns PNG bytes.
        The reference has no img2img; the semantics are diffusers'
        FluxImg2ImgPipeline's."""
        return [encode_png(img) for img in self.img2img_images(prompts, params, image, strength)]

    def img2img_images(self, prompts: Sequence[str], params: DiffusionGenerationParams,
                       image, strength: float = 0.6) -> List[np.ndarray]:
        """:meth:`img2img` as one u8 ``[H, W, 3]`` array per prompt."""
        return self._inner.img2img(list(prompts), params, image, strength)

    def inpaint(self, prompts: Sequence[str], params: DiffusionGenerationParams, image, mask,
                strength: float = 1.0) -> List[bytes]:
        """Repaint the white region of ``mask`` guided by the prompt; the
        unmasked latent is pinned to the init image's (renoised every step,
        diffusers FluxInpaintPipeline construction). Returns PNG bytes."""
        return [encode_png(img)
                for img in self.inpaint_images(prompts, params, image, mask, strength)]

    def inpaint_images(self, prompts: Sequence[str], params: DiffusionGenerationParams,
                       image, mask, strength: float = 1.0) -> List[np.ndarray]:
        """:meth:`inpaint` as one u8 ``[H, W, 3]`` array per prompt."""
        return self._inner.inpaint(list(prompts), params, image, mask, strength)

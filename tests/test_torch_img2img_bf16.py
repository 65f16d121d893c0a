"""img2img and inpainting in bf16, the working dtype, through the port
against the JAX package: the u8 images, strength 1.0 against txt2img, and
the validation errors.

The pipelines are torch_port_util.i2i_build's (the tiny config of
tests/test_torch_pipeline.py with the whole VAE), both fed the JAX
package's denoise noise and encoder sample; the JAX Pallas kernels run in
interpret mode. The f32 slice is in tests/test_torch_img2img.py, the parts
under the pipeline in tests/test_torch_vae_encode.py.
"""

import numpy as np
import pytest
import torch

from diffusion_rs_tpu_torch import DiffusionGenerationParams as TParams
from diffusion_rs_tpu_torch import FluxPipeline as TPipeline
from torch_port_util import (  # noqa: F401
    I2I_GEN, I2I_PROMPTS, i2i_inputs, i2i_run_both, jax_interpreted_module)

PSNR_FLOOR = 42.0  # tests/test_quality_gate.py


@pytest.fixture(scope="module")
def bf16_runs(jax_interpreted_module):
    return i2i_run_both("bfloat16", "np")


# -- bf16 images -----------------------------------------------------------------


def _psnr(a, b) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)


@pytest.mark.parametrize("mode", ["img2img", "inpaint"])
def test_bf16_images_clear_psnr_floor(bf16_runs, mode):
    """bf16: the u8 images clear the 42 dB floor against JAX's (measured
    img2img 44.2 / 45.2 dB, inpaint 45.1 / 45.6 dB). XLA may fuse the
    bf16 ``mean + std * eps`` and ``(lat - shift) * scale`` and round once
    where PyTorch rounds each operation; the floor absorbs it."""
    _, _, _, out = bf16_runs
    img_j, img_t, _ = out[mode]
    assert img_t.shape == img_j.shape == (2, 64, 64, 3) and img_t.dtype == np.uint8
    for i in range(len(I2I_PROMPTS)):
        assert _psnr(img_t[i], img_j[i]) >= PSNR_FLOOR


def test_strength_one_is_txt2img(bf16_runs):
    """img2img at strength 1.0 starts from sig0 = 1: the init latent drops out
    and the image equals the port's own txt2img image for the seed."""
    _, _, kw, _ = bf16_runs
    tpipe = TPipeline(**kw)
    images, _ = i2i_inputs()
    t2i = tpipe.forward_arrays(I2I_PROMPTS, TParams(**I2I_GEN))
    full = np.stack(tpipe.img2img(I2I_PROMPTS, TParams(**I2I_GEN), images, strength=1.0))
    np.testing.assert_array_equal(full, t2i)


def test_validation_errors(bf16_runs):
    """JAX's messages: strength outside (0, 1], a count of init images other
    than the batch's, a mask without an init image."""
    _, _, kw, _ = bf16_runs
    tpipe = TPipeline(**kw)
    images, mask = i2i_inputs()
    p = TParams(**I2I_GEN)
    for s in (0.0, -0.5, 1.5):
        with pytest.raises(ValueError, match="strength must be in"):
            tpipe.img2img(I2I_PROMPTS, p, images, strength=s)
    with pytest.raises(ValueError, match="got 1 init images for 2 prompts"):
        tpipe.img2img(I2I_PROMPTS, p, images[:1], strength=0.5)
    with pytest.raises(ValueError, match="mask_image requires init_image"):
        tpipe.forward_arrays(I2I_PROMPTS, p, mask_image=mask)

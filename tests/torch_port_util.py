"""Helpers for the parity tests between the JAX package and its PyTorch port.

The tests make their inputs with numpy, run them through both packages and
compare. JAX params cross over as plain Python + numpy (``to_numpy_tree``),
which the port's bridge turns into its own params.
"""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_rs_tpu.models import clip as jclip, flux as jflux, t5 as jt5, vae as jvae
from diffusion_rs_tpu.ops.conv import Conv as JConv
from diffusion_rs_tpu.ops.linear import Linear as JLinear
from diffusion_rs_tpu.pipelines.api import DiffusionGenerationParams as JParams
from diffusion_rs_tpu.pipelines.flux_pipeline import FluxPipeline as JPipeline
from diffusion_rs_tpu.pipelines.sampling import get_noise as j_get_noise
from diffusion_rs_tpu.pipelines.scheduler import SchedulerConfig as JSched
from diffusion_rs_tpu.quant import bnb as jbnb
from diffusion_rs_tpu.quant.qtensor import QuantizedTensor as JQT
from diffusion_rs_tpu.quant.qtensor import quantize_q8_tile
from diffusion_rs_tpu_torch import DiffusionGenerationParams as TParams
from diffusion_rs_tpu_torch import FluxPipeline as TPipeline
from diffusion_rs_tpu_torch.bridge import from_numpy_tree
from diffusion_rs_tpu_torch.models import clip as tclip, flux as tflux
from diffusion_rs_tpu_torch.models import t5 as tt5, vae as tvae
from diffusion_rs_tpu_torch.pipelines import flux_pipeline as tfp
from diffusion_rs_tpu_torch.pipelines.scheduler import SchedulerConfig as TSched
from diffusion_rs_tpu_torch.util import synthetic as syn
from diffusion_rs_tpu_torch.util.synthetic import WordTokenizer


def summed_rel(a, b) -> float:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.abs(a - b).sum() / (np.abs(b).sum() + 1e-9))


def to_numpy_tree(tree):
    """JAX param pytree -> the bridge's plain form (module doc of
    diffusion_rs_tpu_torch/bridge.py)."""
    if tree is None:
        return None
    if isinstance(tree, JLinear):
        return {"__type__": "Linear", "w": to_numpy_tree(tree.w),
                "b": to_numpy_tree(tree.b),
                "lora": None if tree.lora is None else [to_numpy_tree(t) for t in tree.lora]}
    if isinstance(tree, JConv):
        return {"__type__": "Conv", "w": to_numpy_tree(tree.w), "b": to_numpy_tree(tree.b)}
    if isinstance(tree, JQT):
        return {"__type__": "QuantizedTensor",
                "packed": np.asarray(tree.packed), "scale": np.asarray(tree.scale),
                "bias": to_numpy_tree(tree.bias), "codebook": to_numpy_tree(tree.codebook),
                "kind": tree.kind, "bits": tree.bits, "group": tree.group,
                "split": tree.split, "shape": tuple(tree.shape),
                "out_dtype": tree.out_dtype}
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy_tree(v) for v in tree]
    return np.asarray(tree)


def to_jax_tree(tree):
    """The port's dense params (f32 tensors, ``Linear``, ``Conv``) -> the JAX
    package's: the reverse of the bridge, for params the port's fast
    synthetic factories made."""
    from diffusion_rs_tpu_torch.ops.conv import Conv as TConv
    from diffusion_rs_tpu_torch.ops.linear import Linear as TLinear

    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return jnp.asarray(tree.detach().cpu().numpy())
    if isinstance(tree, TLinear):
        return JLinear(w=to_jax_tree(tree.w), b=to_jax_tree(tree.b))
    if isinstance(tree, TConv):
        return JConv(w=to_jax_tree(tree.w), b=to_jax_tree(tree.b))
    if isinstance(tree, dict):
        return {k: to_jax_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_jax_tree(v) for v in tree)
    raise TypeError(f"unexpected leaf {type(tree)}")


def quantize_tree(params, quantize, dtype):
    """Quantize every 2-D/stacked-3-D Linear weight; other leaves -> dtype.
    Biases become small random values so the bias add is exercised."""
    rng = np.random.default_rng(1)

    def leaf(x):
        if isinstance(x, JLinear):
            w = np.asarray(x.w, np.float32)
            if w.ndim == 2:
                qw = quantize(w)
            else:
                qws = [quantize(w[i]) for i in range(w.shape[0])]
                qw = jax.tree.map(lambda *xs: jnp.stack(xs), *qws)
            b = None if x.b is None else jnp.asarray(
                rng.standard_normal(x.b.shape) * 0.02, dtype)
            return JLinear(w=qw, b=b)
        return jnp.asarray(x, dtype)

    return jax.tree.map(leaf, params, is_leaf=lambda x: isinstance(x, JLinear))


def port_params(jax_tree, device="cpu"):
    return from_numpy_tree(to_numpy_tree(jax_tree), device)


def to_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


@pytest.fixture
def jax_kernels_interpreted(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode on the CPU (the
    port's CPU path follows the same kernel math)."""
    attention = importlib.import_module("diffusion_rs_tpu.ops.attention")
    linear = importlib.import_module("diffusion_rs_tpu.ops.linear")

    monkeypatch.setenv("DIFFUSION_RS_TPU_QMM", "interpret")
    monkeypatch.setenv("DIFFUSION_RS_TPU_FLASH", "interpret")
    linear._qmm_mode.cache_clear()
    attention._flash_mode.cache_clear()
    yield
    monkeypatch.undo()
    linear._qmm_mode.cache_clear()
    attention._flash_mode.cache_clear()


# -- img2img / inpaint: the tiny pipelines of tests/test_torch_pipeline.py with
# the whole VAE, built once per test module -----------------------------------

I2I_FLUX = dict(in_channels=64, pooled_projection_dim=64, joint_attention_dim=256,
                num_attention_heads=2, num_layers=1, num_single_layers=2,
                guidance_embeds=True, hidden_size=256, axes_dim=(16, 56, 56))
I2I_T5 = dict(vocab_size=300, d_model=256, d_kv=64, d_ff=512, num_layers=2, num_heads=4)
I2I_CLIP = dict(vocab_size=300, projection_dim=64, intermediate_size=128,
                num_hidden_layers=2, num_attention_heads=4)
I2I_VAE = dict(block_out_channels=(32, 32, 32, 32), norm_num_groups=8)
# 4 steps: strength 0.5 runs 2 of them, 0.75 runs 3
I2I_GEN = dict(height=64, width=64, num_steps=4, guidance_scale=3.5, seed=7,
               max_sequence_length=64)
I2I_PROMPTS = ["a photo of a cat", "a red house by the sea"]
IMG2IMG, INPAINT = 0.5, 0.75


def i2i_inputs():
    """Two init images at size and a centre-square mask at the latent size
    (8x8), all u8."""
    rng = np.random.default_rng(4)
    images = [rng.integers(0, 256, (64, 64, 3), dtype=np.uint8) for _ in I2I_PROMPTS]
    mask = np.zeros((8, 8), np.uint8)
    mask[2:6, 3:7] = 255
    return images, mask


def nf4_t(w):
    return jbnb.quantize_nf4(np.ascontiguousarray(w.T), blocksize=64)


def i2i_build(dtype, dense_flux: bool = False, **flags):
    """The JAX pipeline and the port's constructor keywords on the same params
    (the whole VAE): dense f32 weights from the port's seeded factories,
    carried into JAX trees, FLUX quantized q8t (left dense with
    ``dense_flux``) and T5 nf4 there, bridged back."""
    jd = getattr(jnp, dtype)
    tcfg = dict(flux_cfg=tflux.FluxConfig(**I2I_FLUX), t5_cfg=tt5.T5Config(**I2I_T5),
                clip_cfg=tclip.ClipTextConfig(**I2I_CLIP), vae_cfg=tvae.VAEConfig(**I2I_VAE))
    f32 = dict(dtype=torch.float32, device="cpu")
    dense = dict(
        flux_params=syn.init_flux_params(0, tcfg["flux_cfg"], **f32),
        t5_params=syn.init_t5_params(1, tcfg["t5_cfg"], **f32),
        clip_params=syn.init_clip_params(2, tcfg["clip_cfg"], **f32),
        vae_params={**syn.init_vae_decoder_params(3, tcfg["vae_cfg"], **f32),
                    **syn.init_vae_encoder_params(4, tcfg["vae_cfg"], **f32)},
    )
    params = {k: to_jax_tree(v) for k, v in dense.items()}
    if not dense_flux:
        params["flux_params"] = quantize_tree(params["flux_params"], quantize_q8_tile, jd)
    params["t5_params"] = quantize_tree(params["t5_params"], nf4_t, jd)
    for k in ("clip_params", "vae_params") + (("flux_params",) if dense_flux else ()):
        params[k] = jax.tree.map(lambda a: jnp.asarray(a, jd), params[k])
    tok = dict(t5_tokenizer=WordTokenizer(300), clip_tokenizer=WordTokenizer(300))
    jpipe = JPipeline(flux_cfg=jflux.FluxConfig(**I2I_FLUX), t5_cfg=jt5.T5Config(**I2I_T5),
                      clip_cfg=jclip.ClipTextConfig(**I2I_CLIP), vae_cfg=jvae.VAEConfig(**I2I_VAE),
                      scheduler=JSched(use_dynamic_shifting=True), dtype=jd,
                      silent=True, **tok, **params, **flags)
    kw = dict(scheduler=TSched(use_dynamic_shifting=True), dtype=getattr(torch, dtype),
              device="cpu", **tcfg, **tok, **{k: port_params(v) for k, v in params.items()})
    return jpipe, kw


def jax_draws(jdtype):
    """The JAX package's denoise noise and encoder sample for a seed, as the
    port's draw functions."""

    def noise(seed, n, h, w, device):
        return torch.from_numpy(np.array(j_get_noise(jax.random.PRNGKey(seed), n, h, w)))

    def encode_noise(seed, shape, dtype, device):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), 1)
        return port_params(np.asarray(jax.random.normal(key, shape, jdtype)))

    return noise, encode_noise


def spy(obj, name, log):
    """Record the args and result of ``obj.name`` (a jitted stage) in ``log``."""
    real = getattr(obj, name)

    def call(*a, **kw):
        out = real(*a, **kw)
        log.append((a, kw, out))
        return out

    setattr(obj, name, call)


@pytest.fixture(scope="module")
def jax_interpreted_module():
    """The JAX package's Pallas kernels in interpret mode for the module."""
    attention = importlib.import_module("diffusion_rs_tpu.ops.attention")
    linear = importlib.import_module("diffusion_rs_tpu.ops.linear")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DIFFUSION_RS_TPU_QMM", "interpret")
        mp.setenv("DIFFUSION_RS_TPU_FLASH", "interpret")
        linear._qmm_mode.cache_clear()
        attention._flash_mode.cache_clear()
        yield
    linear._qmm_mode.cache_clear()
    attention._flash_mode.cache_clear()


def i2i_run_both(dtype, output_type, dense_flux: bool = False):
    """img2img (strength 0.5) and inpaint (0.75) of both prompts through both
    packages, the stages captured (FLUX q8t, or dense with ``dense_flux``).
    Returns the pipelines, the port's constructor keywords and, per mode,
    the JAX and port outputs with the last call of the JAX image encode and
    denoise and of the port's denoise, each as (args, kwargs, result)."""
    jpipe, kw = i2i_build(dtype, dense_flux=dense_flux)
    tpipe = TPipeline(**kw)
    images, mask = i2i_inputs()
    draws = jax_draws(getattr(jnp, dtype))
    logs = {"image": [], "denoise": [], "port_denoise": []}
    spy(jpipe, "_encode_image_jit", logs["image"])
    spy(jpipe, "_denoise_jit", logs["denoise"])
    spy(tpipe, "_denoise", logs["port_denoise"])
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfp, "get_noise", draws[0])
        mp.setattr(tfp, "get_encode_noise", draws[1])
        for mode, extra in (("img2img", dict(strength=IMG2IMG)),
                            ("inpaint", dict(strength=INPAINT, mask_image=mask))):
            o_j = jpipe.forward_arrays(I2I_PROMPTS, JParams(**I2I_GEN), init_image=images,
                                       output_type=output_type, **extra)
            o_t = tpipe.forward_arrays(I2I_PROMPTS, TParams(**I2I_GEN), init_image=images,
                                       output_type=output_type, **extra)
            out[mode] = (o_j, o_t, {k: v[-1] for k, v in logs.items()})
    return jpipe, tpipe, kw, out



"""The whole ported slice against the JAX package: tokenize, T5 (nf4) +
CLIP encode, q8t FLUX denoise, VAE decode, u8, through both packages'
``FluxPipeline.forward_arrays`` at a tiny config.

Both packages get the same noise: the port's ``get_noise`` is replaced by
the JAX package's draw for the same seed (torch cannot reproduce
``jax.random``). The JAX Pallas kernels run in interpret mode; the port runs
its kernels' plain versions on the CPU. The f32 denoise with the
conditioning held equal also runs through ``Offloading.Stream``'s
StreamedFlux in both packages.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_rs_tpu.models import clip as jclip, flux as jflux, t5 as jt5, vae as jvae
from diffusion_rs_tpu.pipelines.api import DiffusionGenerationParams as JParams
from diffusion_rs_tpu.pipelines.flux_pipeline import FluxPipeline as JPipeline
from diffusion_rs_tpu.models.flux_streaming import StreamedFlux as JStreamed
from diffusion_rs_tpu.pipelines.sampling import get_noise as j_get_noise
from diffusion_rs_tpu.pipelines.sampling import make_img_ids, make_txt_ids, pack_latents
from diffusion_rs_tpu.pipelines.scheduler import SchedulerConfig as JSched
from diffusion_rs_tpu.quant import bnb as jbnb
from diffusion_rs_tpu.quant.qtensor import quantize_q8_tile
from diffusion_rs_tpu_torch import DiffusionGenerationParams as TParams
from diffusion_rs_tpu_torch import FluxPipeline as TPipeline
from diffusion_rs_tpu_torch.io.tokenizer import tokenize_and_pad
from diffusion_rs_tpu_torch.models import clip as tclip, flux as tflux, t5 as tt5, vae as tvae
from diffusion_rs_tpu_torch.models.flux_streaming import StreamedFlux
from diffusion_rs_tpu_torch.pipelines.sampling import pack_latents as pack_latents_t
from diffusion_rs_tpu_torch.pipelines.scheduler import SchedulerConfig as TSched
from diffusion_rs_tpu_torch.util.synthetic import WordTokenizer
from torch_port_util import (  # noqa: F401
    jax_kernels_interpreted, port_params, quantize_tree, summed_rel)

PSNR_FLOOR = 42.0  # tests/test_quality_gate.py

FLUX = dict(in_channels=64, pooled_projection_dim=64, joint_attention_dim=256,
            num_attention_heads=2, num_layers=1, num_single_layers=2,
            guidance_embeds=True, hidden_size=256, axes_dim=(16, 56, 56))
T5 = dict(vocab_size=300, d_model=256, d_kv=64, d_ff=512, num_layers=2, num_heads=4)
CLIP = dict(vocab_size=300, projection_dim=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4)
VAE = dict(block_out_channels=(32, 32, 32, 32), norm_num_groups=8)
GEN = dict(height=64, width=64, num_steps=2, guidance_scale=3.5, seed=7,
           max_sequence_length=64)
PROMPTS = ["a photo of a cat", "a red house by the sea"]


def _nf4(w):
    return jbnb.quantize_nf4(np.ascontiguousarray(w.T), blocksize=64)


def _pipelines(dtype):
    jd = getattr(jnp, dtype)
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    jcfg = (jflux.FluxConfig(**FLUX), jt5.T5Config(**T5), jclip.ClipTextConfig(**CLIP),
            jvae.VAEConfig(**VAE))
    params = dict(
        flux_params=quantize_tree(jflux.init_flux_params(keys[0], jcfg[0]),
                                  quantize_q8_tile, jd),
        t5_params=quantize_tree(jt5.init_t5_params(keys[1], jcfg[1]), _nf4, jd),
        clip_params=jax.tree.map(lambda a: jnp.asarray(a, jd),
                                 jclip.init_clip_params(keys[2], jcfg[2])),
        vae_params=jax.tree.map(lambda a: jnp.asarray(a, jd),
                                jvae.init_vae_params(keys[3], jcfg[3])),
    )
    tok = dict(t5_tokenizer=WordTokenizer(300), clip_tokenizer=WordTokenizer(300))
    jpipe = JPipeline(flux_cfg=jcfg[0], t5_cfg=jcfg[1], clip_cfg=jcfg[2], vae_cfg=jcfg[3],
                      scheduler=JSched(use_dynamic_shifting=True), dtype=jd,
                      silent=True, **tok, **params)
    tparams = {k: port_params(v) for k, v in params.items()}
    tparams["vae_params"] = {"decoder": tparams["vae_params"]["decoder"],
                             "post_quant_conv": None}
    tpipe = TPipeline(flux_cfg=tflux.FluxConfig(**FLUX), t5_cfg=tt5.T5Config(**T5),
                      clip_cfg=tclip.ClipTextConfig(**CLIP), vae_cfg=tvae.VAEConfig(**VAE),
                      scheduler=TSched(use_dynamic_shifting=True),
                      dtype=getattr(torch, dtype), device="cpu", **tok, **tparams)
    return jpipe, tpipe


@pytest.fixture
def same_noise(monkeypatch):
    """The port draws the JAX package's noise for the request's seed."""
    tpl = importlib.import_module("diffusion_rs_tpu_torch.pipelines.flux_pipeline")

    def jax_noise(seed, n, h, w, device):
        return torch.from_numpy(np.asarray(j_get_noise(jax.random.PRNGKey(seed), n, h, w)))

    monkeypatch.setattr(tpl, "get_noise", jax_noise)


def _psnr(a, b) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)


def test_slice_f32_latent_matches_jax(jax_kernels_interpreted, same_noise):
    """f32, whole slice: the packed post-denoise latents agree within 5e-3
    summed-relative (measured 2.1e-3). The q8t activation quantize is a step
    function: T5's f32 summation-order difference (1e-6) flips a few int8
    activation codes in FLUX's linears by one step, each moving its row by
    up to 1/127 of the row's max. With the text conditioning held equal the
    denoise stages agree to 1e-5 (measured 1.6e-7)."""
    jpipe, tpipe = _f32_pipelines()
    lat_j = jpipe.forward_arrays(PROMPTS, JParams(**GEN), output_type="latent")
    lat_t = tpipe.forward_arrays(PROMPTS, TParams(**GEN), output_type="latent")
    assert lat_t.shape == lat_j.shape == (2, 16, 64)
    assert summed_rel(lat_t, lat_j) <= 5e-3

    held = _held_equal()
    txt_t, y_t = tpipe._encode(*map(torch.from_numpy, held["ids"]))
    assert summed_rel(txt_t.numpy(), held["txt"]) <= 1e-5
    assert summed_rel(y_t.numpy(), held["y"]) <= 1e-5
    lat_j = jpipe._denoise(jpipe.flux_params, *(jnp.asarray(held[k]) for k in (
        "txt", "y", "sigmas", "g", "noise")), height=64, width=64)
    lat_t = tpipe._denoise(*_port_denoise_args(held))
    assert summed_rel(lat_t.numpy(), np.asarray(lat_j)) <= 1e-5


@functools.lru_cache(None)
def _f32_pipelines():
    """The f32 pipelines, built once for this module's f32 tests (other
    modules call ``_pipelines`` for fresh ones: a JAX pipeline's jitted
    stages keep the attention knobs they were traced under)."""
    return _pipelines("float32")


@functools.lru_cache(None)
def _held_equal() -> dict:
    """The f32 denoise's inputs with the conditioning held equal: the token
    ids, JAX's T5 / CLIP encodes of them, JAX's noise for the seed, the
    schedule and the guidance."""
    jpipe, tpipe = _f32_pipelines()
    t5_ids = tokenize_and_pad(PROMPTS, tpipe.t5_tokenizer, pad_to=GEN["max_sequence_length"])
    clip_ids = tokenize_and_pad(PROMPTS, tpipe.clip_tokenizer)
    txt, y = jpipe._encode(jpipe.t5_params, jpipe.clip_params, jnp.asarray(t5_ids),
                           jnp.asarray(clip_ids))
    return dict(ids=(t5_ids, clip_ids), txt=np.array(txt), y=np.array(y),
                noise=np.array(j_get_noise(jax.random.PRNGKey(GEN["seed"]), 2, 64, 64)),
                sigmas=tpipe.scheduler.timesteps(GEN["num_steps"], mu=0.6),
                g=np.full((2,), GEN["guidance_scale"], np.float32))


def _port_denoise_args(held: dict) -> tuple:
    """(txt, y, sigmas, guidance, noise) for the port's ``_denoise``."""
    return (torch.from_numpy(held["txt"]), torch.from_numpy(held["y"]), held["sigmas"],
            torch.from_numpy(held["g"]), torch.from_numpy(held["noise"]))


def test_streamed_denoise_matches_jax(jax_kernels_interpreted):
    """Offloading.Stream on the held-equal txt2img case above: the port's
    streamed denoise (models/flux_streaming.StreamedFlux, the blocks packed
    in host buffers) within 1e-5 summed-rel of JAX's StreamedFlux.denoise
    on the same q8t params and inputs (measured 1.6e-7), and equal to the
    port's resident denoise bit for bit."""
    jpipe, tpipe = _f32_pipelines()
    held = _held_equal()
    jpe = jflux.compute_pe(jpipe.flux_cfg, make_txt_ids(2, 64), make_img_ids(2, 4, 4))
    want = JStreamed(jpipe.flux_params, jpipe.flux_cfg).denoise(
        pack_latents(jnp.asarray(held["noise"])), *(jnp.asarray(held[k]) for k in (
            "txt", "y", "g")), jpe, held["sigmas"])
    txt, y, sigmas, g, noise = _port_denoise_args(held)
    sf = StreamedFlux(tpipe.flux_params, tpipe.flux_cfg, device="cpu")
    got = sf.denoise(pack_latents_t(noise), txt, y, g, tpipe._pe(txt, noise), sigmas)
    assert got.shape == (2, 16, 64)
    assert summed_rel(got.numpy(), np.asarray(want)) <= 1e-5
    assert torch.equal(got, tpipe._denoise(txt, y, sigmas, g, noise))


def test_slice_bf16_image_clears_psnr_floor(jax_kernels_interpreted, same_noise):
    """bf16, the working dtype: the u8 images clear the 42 dB floor of
    tests/test_quality_gate.py against the JAX package's images."""
    jpipe, tpipe = _pipelines("bfloat16")
    img_j = jpipe.forward_arrays(PROMPTS, JParams(**GEN))
    img_t = tpipe.forward_arrays(PROMPTS, TParams(**GEN))
    assert img_t.shape == img_j.shape == (2, 64, 64, 3) and img_t.dtype == np.uint8
    for i in range(len(PROMPTS)):
        assert _psnr(img_t[i], img_j[i]) >= PSNR_FLOOR  # measured 46.2 and 44.6 dB
    assert not np.array_equal(img_t[0], img_t[1])  # each prompt conditions its image


def test_port_seed_contract():
    """The port's own noise: one seed gives one latent on one device type,
    and another seed another."""
    from diffusion_rs_tpu_torch.pipelines.sampling import get_noise

    a = get_noise(7, 1, 64, 64, "cpu")
    assert tuple(a.shape) == (1, 16, 8, 8) and a.dtype == torch.float32
    assert torch.equal(a, get_noise(7, 1, 64, 64, "cpu"))
    assert not torch.equal(a, get_noise(8, 1, 64, 64, "cpu"))

"""The tiled VAE decode and the pipeline's decode seam and shift knob against
the JAX package: ``vae_decode_tiled`` on a tiny random VAE, the pipeline with
DIFFUSION_RS_TPU_VAE_TILE set, DIFFUSION_RS_TPU_DECODE_CHUNK, and the sigma
schedule under DIFFUSION_RS_TPU_REFERENCE_MU."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_rs_tpu import DiffusionGenerationParams as JParams
from diffusion_rs_tpu import ModelDType as JDType
from diffusion_rs_tpu import ModelSource as JSource
from diffusion_rs_tpu import Pipeline as JPipeline
from diffusion_rs_tpu.models import vae as jvae
from diffusion_rs_tpu.pipelines.flux_pipeline import FluxPipeline as JFlux
from diffusion_rs_tpu.pipelines.sampling import get_noise as j_get_noise
from diffusion_rs_tpu_torch.models import vae as tvae
from diffusion_rs_tpu_torch.pipelines.api import ModelDType as TDType
from diffusion_rs_tpu_torch.pipelines.api import ModelSource as TSource
from diffusion_rs_tpu_torch.pipelines.api import Pipeline as TPipeline
from diffusion_rs_tpu_torch.pipelines.flux_pipeline import DiffusionGenerationParams as TParams
from diffusion_rs_tpu_torch.pipelines.flux_pipeline import FluxPipeline as TFlux
from diffusion_rs_tpu_torch.util.synthetic import init_vae_decoder_params
from synth import write_checkpoint
from torch_port_util import to_jax_tree

PSNR_FLOOR = 42.0  # tests/test_quality_gate.py
# the tiny checkpoint's VAE upsamples 8x: a 96x64 image is a 12x8 latent
GEN = dict(height=96, width=64, num_steps=2, guidance_scale=3.5, seed=42)
PROMPTS = ["a photo of a cat", "the dog"]

# tests/test_vae.py's tiled-decode VAE: two stages (2x), 8 groups of 32
VAE = dict(block_out_channels=(32, 32), norm_num_groups=8, latent_channels=16)


@pytest.fixture(scope="module")
def tiny_vae():
    """Random f32 decoder weights of that config from the port's seeded
    factory, carried into the JAX package's tree."""
    params = init_vae_decoder_params(3, tvae.VAEConfig(**VAE), torch.float32, device="cpu")
    return to_jax_tree(params), params


@pytest.mark.parametrize("shape,tile,overlap", [((1, 22, 30, 16), 16, 4),
                                                ((2, 24, 24, 16), 32, 4)])
def test_vae_decode_tiled_matches_jax(tiny_vae, shape, tile, overlap):
    """Same latent from a numpy seed through both packages' tiled decode:
    f32 max-abs within 1e-4 (per-tile GroupNorm and feathered seams alike;
    22x30 leaves smaller edge tiles); at tile 32 the latent fits one tile and
    the port returns its one-shot decode bit for bit."""
    jp, tp = tiny_vae
    z = (np.random.default_rng(0).standard_normal(shape) * 0.5).astype(np.float32)
    decode = jax.jit(lambda p, x: jvae.vae_decode_tiled(p, jvae.VAEConfig(**VAE), x,
                                                        tile=tile, overlap=overlap))
    want = np.asarray(decode(jp, jnp.asarray(z)))
    cfg = tvae.VAEConfig(**VAE)
    got = tvae.vae_decode_tiled(tp, cfg, torch.from_numpy(z), tile=tile, overlap=overlap)
    assert tuple(got.shape) == want.shape == (shape[0], 2 * shape[1], 2 * shape[2], 3)
    assert np.abs(got.numpy() - want).max() <= 1e-4
    one_shot = tvae.vae_decode(tp, cfg, torch.from_numpy(z))
    if tile >= max(shape[1:3]):
        assert torch.equal(got, one_shot)
    else:  # the seams and per-tile statistics move the image
        assert (got - one_shot).abs().max() > 1e-2


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """tests/synth.py's tiny dev-style checkpoint (guidance, dynamic shift)."""
    return write_checkpoint(tmp_path_factory.mktemp("ckpt") / "dense", seed=0, guidance=True,
                            dynamic_shifting=True)


@pytest.fixture
def same_noise(monkeypatch):
    """The port draws the JAX package's noise for the request's seed."""
    tpl = importlib.import_module("diffusion_rs_tpu_torch.pipelines.flux_pipeline")

    def jax_noise(seed, n, h, w, device):
        return torch.from_numpy(np.array(j_get_noise(jax.random.PRNGKey(seed), n, h, w)))

    monkeypatch.setattr(tpl, "get_noise", jax_noise)


def _pipelines(ckpt, dtype: str):
    return (JPipeline(JSource.from_model_id(str(ckpt)), silent=True, dtype=getattr(JDType, dtype)),
            TPipeline(TSource.from_model_id(str(ckpt)), silent=True,
                      dtype=getattr(TDType, dtype), device="cpu"))


def _denoise_once(pipe):
    """Run the port pipeline's denoise once and hand later calls its result
    (the same prompts and seed give the same latent): tests of the decode
    seam then re-run only the encoders and the decode."""
    inner = pipe._inner
    denoise, done = inner._denoise, []

    def cached(*args):
        if not done:
            done.append(denoise(*args))
        return done[0]

    inner._denoise = cached


def _psnr(a, b) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)


def test_pipeline_tiled_decode_matches_jax(ckpt, same_noise, monkeypatch):
    """DIFFUSION_RS_TPU_VAE_TILE=8 with the tiling threshold lowered to 8 on
    both packages (as tests/test_pipeline_e2e.py does): a 96x64 image (latent
    12x8) decodes in tiles, and the bf16 images clear the 42 dB floor of
    tests/test_quality_gate.py against the JAX package's (its XLA paths on
    the CPU: the checkpoint is dense, so only attention takes a kernel's
    plain version in the port)."""
    jp, tp = _pipelines(ckpt, "Auto")
    _denoise_once(tp)
    base = np.stack(tp.forward_images(PROMPTS, TParams(**GEN)))
    for cls in (JFlux, TFlux):
        monkeypatch.setattr(cls, "_TILE_DECODE_ABOVE", 8)
    monkeypatch.setenv("DIFFUSION_RS_TPU_VAE_TILE", "8")
    img_j = np.stack([np.asarray(i) for i in jp.forward_images(PROMPTS, JParams(**GEN))])
    img_t = np.stack(tp.forward_images(PROMPTS, TParams(**GEN)))
    assert img_t.shape == img_j.shape == (2, 96, 64, 3)
    for a, b in zip(img_t, img_j):
        assert _psnr(a, b) >= PSNR_FLOOR
    assert not np.array_equal(img_t, base)  # the tiles and seams changed the image


def test_decode_chunk_is_exact(ckpt, monkeypatch):
    """DIFFUSION_RS_TPU_DECODE_CHUNK=1 decodes a batch of 3 one sample at a
    time: the images equal the one-call decode bit for bit (the decode is
    per sample)."""
    tp = TPipeline(TSource.from_model_id(str(ckpt)), silent=True, device="cpu")
    _denoise_once(tp)
    inner = tp._inner
    prompts = ["a photo", "a dog", "a tree"]
    calls = []
    decode = inner._decode_any
    inner._decode_any = lambda lat, h, w: calls.append(lat.shape[0]) or decode(lat, h, w)
    monkeypatch.delenv("DIFFUSION_RS_TPU_DECODE_CHUNK", raising=False)
    full = np.stack(tp.forward_images(prompts, TParams(**GEN)))
    monkeypatch.setenv("DIFFUSION_RS_TPU_DECODE_CHUNK", "1")
    chunked = np.stack(tp.forward_images(prompts, TParams(**GEN)))
    assert calls == [3, 1, 1, 1]
    np.testing.assert_array_equal(full, chunked)
    # without the knob, about 1M decoded pixels per call, as in JAX
    monkeypatch.delenv("DIFFUSION_RS_TPU_DECODE_CHUNK")
    assert inner._decode_chunk(3, TParams(height=1024, width=1024)) == 1
    assert inner._decode_chunk(8, TParams(height=720, width=1280)) == 1
    assert inner._decode_chunk(8, TParams(height=512, width=512)) == 4


class _Stop(Exception):
    pass


@pytest.mark.parametrize("reference_mu", [None, "1"])
def test_sigmas_follow_reference_mu(ckpt, monkeypatch, reference_mu):
    """The schedule the denoise receives equals the JAX pipeline's, with
    DIFFUSION_RS_TPU_REFERENCE_MU=1 (the shift from the latent channel
    count) and without it (from the packed sequence length)."""
    if reference_mu is None:
        monkeypatch.delenv("DIFFUSION_RS_TPU_REFERENCE_MU", raising=False)
    else:
        monkeypatch.setenv("DIFFUSION_RS_TPU_REFERENCE_MU", reference_mu)
    jp, tp = (p._inner for p in _pipelines(ckpt, "F32"))
    got = {}

    def grab(name, sigmas_at):
        def stop(*a, **kw):
            got[name] = np.asarray(a[sigmas_at], np.float32)
            raise _Stop
        return stop

    jp._denoise_jit = grab("jax", 3)
    tp._denoise = grab("port", 2)
    gen = {**GEN, "height": 512, "width": 768, "num_steps": 4}
    with pytest.raises(_Stop):
        jp.forward_arrays(PROMPTS[:1], JParams(**gen))
    with pytest.raises(_Stop):
        tp.forward_arrays(PROMPTS[:1], TParams(**gen))
    np.testing.assert_array_equal(got["port"], got["jax"])
    monkeypatch.setenv("DIFFUSION_RS_TPU_REFERENCE_MU", "0" if reference_mu else "1")
    assert not np.array_equal(tp._sigmas(TParams(**gen)), got["port"])

"""img2img and inpainting through the port against the JAX package in f32:
the whole slice (VAE encode with a seeded sample, the truncated schedule,
the start latent, the inpaint blend), the image and mask preparation (with
and without Pillow), the tiled encode through the pipeline, the T5 pad mask
and the per-step progress, at the tiny config of
tests/test_torch_pipeline.py (FLUX hidden 256, 1 + 2 blocks, q8t; T5 nf4;
the 4-level VAE of 32 channels; 64x64 images; torch_port_util.i2i_build).

Both packages get the same denoise noise and the same encoder sample: the
port's ``get_noise`` and ``get_encode_noise`` are replaced by the JAX
package's draws for the seed (``jax.random.normal`` of the key, and of
``fold_in(key, 1)`` in the latent's dtype). The JAX Pallas kernels run in
interpret mode; the port runs its kernels' plain versions on the CPU. Each
JAX pipeline runs once per module; its stage inputs and outputs are captured
on the way, so the stage comparisons ("the conditioning held equal") reuse
the same compiled graphs. The bf16 images are in
tests/test_torch_img2img_bf16.py, the VAE encoder module and the Euler
blend in tests/test_torch_vae_encode.py.
"""

import importlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_rs_tpu.pipelines.api import DiffusionGenerationParams as JParams
from diffusion_rs_tpu.pipelines.flux_pipeline import FluxPipeline as JPipeline
from diffusion_rs_tpu_torch import DiffusionGenerationParams as TParams
from diffusion_rs_tpu_torch import FluxPipeline as TPipeline
from diffusion_rs_tpu_torch.pipelines import flux_pipeline as tfp
from diffusion_rs_tpu_torch.pipelines.sampling import denoise
from torch_port_util import (  # noqa: F401
    I2I_GEN, I2I_PROMPTS, IMG2IMG, INPAINT, i2i_inputs, i2i_run_both, jax_draws,
    jax_interpreted_module, summed_rel, to_np)


@pytest.fixture(scope="module")
def f32_runs(jax_interpreted_module):
    return i2i_run_both("float32", "latent")


# -- img2img and inpaint, f32 --------------------------------------------------


# The whole slice and the denoise, f32 with q8t FLUX: the q8t activation
# quantize is a step function, so f32 summation-order differences of 1e-7
# (the interpreted Pallas flash against the port's plain flash) flip int8
# codes, each moving its row by up to 1/127 of its max, and the flips cascade
# through the blocks. Traced on the img2img start latent: the double block's
# txt proj takes an input 1.7e-7 apart to 4.1e-5, and the step's prediction
# ends 2.1e-3 apart, where a pure-noise input stays at 2.3e-7. Measured over
# the whole slice 5.2e-3 (img2img) and 2.0e-3 (inpaint), with the conditioning
# held equal 3.8e-3 and 1.9e-3; the band is three times the larger reading.
# The Euler loop and blend alone agree to 1e-6 (tests/test_torch_vae_encode.py).
# The cause is shown by test_f32_dense_flux_matches_jax: the same runs with
# FLUX dense (no activation quantize) agree within 1e-5, measured 5.0e-6
# (img2img) and 2.7e-6 (inpaint) over the whole slice and 5.0e-6 and 2.3e-6
# with the conditioning held equal.
Q8T_BAND = 1.5e-2


def _held_equal_denoise(tpipe, logs):
    """The port's denoise on the JAX denoise's own inputs (captured), and
    the JAX denoise's result."""
    (_, txt, y, sig_j, g, start_j, planes_j), _, den_j = logs["denoise"]
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    den_t = tpipe._denoise(t(txt), t(y), np.asarray(sig_j), t(g), t(start_j),
                           None if planes_j is None else tuple(t(p) for p in planes_j))
    return to_np(den_t), np.asarray(den_j)


@pytest.fixture(scope="module")
def f32_dense_runs(jax_interpreted_module):
    return i2i_run_both("float32", "latent", dense_flux=True)


@pytest.mark.parametrize("mode", ["img2img", "inpaint"])
def test_f32_dense_flux_matches_jax(f32_dense_runs, mode):
    """The runs of test_f32_latent_matches_jax with FLUX left dense, where no
    activation is quantized: the whole slice and the denoise held equal to
    the JAX stages' own inputs both within 1e-5 of JAX (measured 5.0e-6 /
    2.7e-6 whole and 5.0e-6 / 2.3e-6 held equal for img2img / inpaint), so
    the q8t runs' wider Q8T_BAND comes from the int8 activation codes and
    not from the img2img or inpaint stages."""
    _, tpipe, _, out = f32_dense_runs
    lat_j, lat_t, logs = out[mode]
    assert lat_t.shape == lat_j.shape == (2, 16, 64)
    assert summed_rel(lat_t, lat_j) <= 1e-5
    assert summed_rel(*_held_equal_denoise(tpipe, logs)) <= 1e-5


@pytest.mark.parametrize("mode", ["img2img", "inpaint"])
def test_f32_latent_matches_jax(f32_runs, mode):
    """f32, whole slice: the packed latents of img2img (strength 0.5: 2 of 4
    steps) and inpaint (0.75: 3 of 4) within Q8T_BAND of JAX's. Held equal
    to the JAX stages' own inputs: the scaled image latent within 1e-5
    (measured 8.6e-7), hence the start latent (2.2e-7, 7.4e-8) and the
    packed init plane (8.6e-7); the schedule, the mask and noise planes
    equal; the denoise within Q8T_BAND."""
    _, tpipe, _, out = f32_runs
    lat_j, lat_t, logs = out[mode]
    assert lat_t.shape == lat_j.shape == (2, 16, 64)
    assert summed_rel(lat_t, lat_j) <= Q8T_BAND
    (_, x, key), _, img_j = logs["image"]
    eps = np.asarray(jax.random.normal(key, (2, 8, 8, 16), jnp.float32))
    img_t = tpipe._encode_image(torch.from_numpy(np.asarray(x)), torch.from_numpy(eps))
    assert summed_rel(to_np(img_t), np.asarray(img_j)) <= 1e-5

    (_, txt, y, sig_j, g, start_j, planes_j), _, den_j = logs["denoise"]
    (_, _, sig_t, _, start_t, planes_t), _, _ = logs["port_denoise"]
    assert len(sig_t) == {"img2img": 3, "inpaint": 4}[mode]  # steps run + 1
    np.testing.assert_array_equal(sig_t, np.asarray(sig_j))
    assert summed_rel(to_np(start_t), np.asarray(start_j)) <= 1e-5
    if mode == "inpaint":
        np.testing.assert_array_equal(to_np(planes_t[0]), np.asarray(planes_j[0]))
        assert summed_rel(to_np(planes_t[1]), np.asarray(planes_j[1])) <= 1e-5
        np.testing.assert_array_equal(to_np(planes_t[2]), np.asarray(planes_j[2]))
    else:
        assert planes_t is None and planes_j is None
    assert summed_rel(*_held_equal_denoise(tpipe, logs)) <= Q8T_BAND


def test_inpaint_unmasked_latent_is_the_init_latent(f32_runs):
    """Wherever the packed mask is 0, the final latent equals the packed init
    latent bit for bit in both packages (the last blend is at sigma 0), and
    the masked tokens moved away from it."""
    _, tpipe, _, out = f32_runs
    lat_j, lat_t, logs = out["inpaint"]
    (_, _, _, _, _, _, (mask, init, _)), _, _ = logs["denoise"]
    mask, init = np.asarray(mask), np.asarray(init)
    keep = mask == 0
    assert keep.any() and (~keep).any()
    np.testing.assert_array_equal(lat_j[keep], init[keep])
    # the port's own init latent (its encode of the same images and draw)
    images, m8 = i2i_inputs()
    _, enc_fn = jax_draws(jnp.float32)
    x = tpipe._prepare_image_batch(images, 2, TParams(**I2I_GEN))
    eps = enc_fn(I2I_GEN["seed"], (2, 8, 8, 16), torch.float32, "cpu")
    init_t = to_np(tfp.pack_latents(tpipe._encode_image(x, eps)))
    np.testing.assert_array_equal(lat_t[keep], init_t[keep])
    assert not np.allclose(lat_t[~keep], init_t[~keep])
    np.testing.assert_array_equal(to_np(tpipe._prepare_mask(m8, 2, TParams(**I2I_GEN))), mask)


@pytest.mark.parametrize("strength,steps_run", [
    (0.125, 1), (0.375, 2), (0.625, 2), (0.875, 4), (0.01, 1), (1.0, 4)])
def test_truncated_schedule(f32_runs, strength, steps_run):
    """steps_run = max(1, min(round(num_steps * strength), num_steps)) with
    Python's half-to-even round (1.5 -> 2, 2.5 -> 2, 3.5 -> 4), and the
    schedule's last steps_run + 1 sigmas, as JAX takes them."""
    jpipe, _, kw, _ = f32_runs
    tpipe = TPipeline(**kw)
    got = {}

    class Stop(Exception):
        pass

    def grab(name):
        def stop(*a, **k):
            got[name] = np.asarray(a[3] if name == "jax" else a[2])
            raise Stop
        return stop

    images, _ = i2i_inputs()
    tpipe._denoise = grab("port")
    jdenoise = jpipe._denoise_jit
    jpipe._denoise_jit = grab("jax")
    try:
        for pipe, P in ((tpipe, TParams), (jpipe, JParams)):
            with pytest.raises(Stop):
                pipe.forward_arrays(I2I_PROMPTS, P(**I2I_GEN), init_image=images,
                                    strength=strength)
    finally:
        jpipe._denoise_jit = jdenoise
    assert len(got["port"]) == steps_run + 1
    np.testing.assert_array_equal(got["port"], got["jax"])
    np.testing.assert_array_equal(got["port"], tpipe._sigmas(TParams(**I2I_GEN))[4 - steps_run:])


# -- image and mask preparation ----------------------------------------------------


def test_pil_path_matches_jax(f32_runs):
    """A 48x48 init image (LANCZOS up to 64x64) and a full-size 64x64 mask
    (BILINEAR down to the 8x8 latent), as PIL images and as arrays: the
    prepared image and packed mask equal JAX's exactly, and the inpaint
    latent is within Q8T_BAND (measured 2.2e-3)."""
    jpipe, tpipe, _, _ = f32_runs
    from PIL import Image

    rng = np.random.default_rng(8)
    small = rng.integers(0, 256, (48, 48, 3), dtype=np.uint8)
    mask = np.zeros((64, 64), np.uint8)
    mask[10:50, 20:44] = 255
    for im, m in ((small, mask), (Image.fromarray(small), Image.fromarray(mask))):
        np.testing.assert_array_equal(
            to_np(tpipe._prepare_image_batch([im, im], 2, TParams(**I2I_GEN))),
            np.asarray(jpipe._prepare_image_batch([im, im], 2, JParams(**I2I_GEN))))
        np.testing.assert_array_equal(to_np(tpipe._prepare_mask(m, 2, TParams(**I2I_GEN))),
                                      np.asarray(jpipe._prepare_mask(m, 2, JParams(**I2I_GEN))))
    draws = jax_draws(jnp.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfp, "get_noise", draws[0])
        mp.setattr(tfp, "get_encode_noise", draws[1])
        lat_j = jpipe.forward_arrays(I2I_PROMPTS, JParams(**I2I_GEN), init_image=small,
                                     strength=INPAINT, mask_image=mask, output_type="latent")
        lat_t = tpipe.forward_arrays(I2I_PROMPTS, TParams(**I2I_GEN), init_image=small,
                                     strength=INPAINT, mask_image=mask, output_type="latent")
    assert summed_rel(lat_t, lat_j) <= Q8T_BAND


def test_no_pil_path(f32_runs, monkeypatch):
    """Without Pillow: a u8 image at the rounded size and a u8 mask at the
    latent size need no resize and equal JAX's preparation (through PIL)
    exactly; anything else raises an ImportError that names Pillow."""
    jpipe, tpipe, _, _ = f32_runs
    images, mask = i2i_inputs()
    want_x = np.asarray(jpipe._prepare_image_batch(images, 2, JParams(**I2I_GEN)))
    want_m = np.asarray(jpipe._prepare_mask(mask, 2, JParams(**I2I_GEN)))
    monkeypatch.setitem(sys.modules, "PIL", None)
    np.testing.assert_array_equal(
        to_np(tpipe._prepare_image_batch(images, 2, TParams(**I2I_GEN))), want_x)
    np.testing.assert_array_equal(to_np(tpipe._prepare_mask(mask, 2, TParams(**I2I_GEN))), want_m)
    with pytest.raises(ImportError, match="Pillow"):
        tpipe._prepare_image_batch(images[0][:48, :48], 2, TParams(**I2I_GEN))
    with pytest.raises(ImportError, match="Pillow"):
        tpipe._prepare_mask(np.zeros((64, 64), np.uint8), 2, TParams(**I2I_GEN))


# -- the tiled encode through the pipeline ------------------------------------------


def test_pipeline_routes_tiled_encode(f32_runs, monkeypatch):
    """With the threshold lowered (tests/test_pipeline_e2e.py:715) and
    DIFFUSION_RS_TPU_VAE_TILE=4, both pipelines route the init encode to
    vae_encode_tiled with the same image, draw and 32-pixel tiles (4 latent
    pixels times the stride 8), the JAX pipeline's call stopped there; the
    port's latent is the scaled tiled encode exactly, and apart from the
    one-shot encode. tests/test_torch_img2img_bf16.py holds vae_encode_tiled
    itself to JAX's."""
    jpipe, tpipe, _, _ = f32_runs
    jfp = importlib.import_module("diffusion_rs_tpu.pipelines.flux_pipeline")
    images, _ = i2i_inputs()
    x = np.asarray(jpipe._prepare_image_batch(images, 2, JParams(**I2I_GEN)))
    key = jax.random.PRNGKey(3)
    eps = torch.from_numpy(np.asarray(jax.random.normal(key, (2, 8, 8, 16), jnp.float32)))
    one_shot = to_np(tpipe._encode_image_any(torch.from_numpy(x), eps))
    calls = {}

    class Stop(Exception):
        pass

    def jax_tiled(params, cfg, xs, k, tile):
        calls["jax"] = (np.asarray(xs), k, tile)
        raise Stop

    real = tfp.vae_encode_tiled

    def port_tiled(params, cfg, xs, e, tile):
        calls["port"] = (to_np(xs), e, tile)
        return real(params, cfg, xs, e, tile=tile)

    monkeypatch.setattr(jfp, "vae_encode_tiled", jax_tiled)
    monkeypatch.setattr(tfp, "vae_encode_tiled", port_tiled)
    monkeypatch.setattr(JPipeline, "_TILE_DECODE_ABOVE", 2)
    monkeypatch.setattr(TPipeline, "_TILE_DECODE_ABOVE", 2)
    monkeypatch.setenv("DIFFUSION_RS_TPU_VAE_TILE", "4")
    with pytest.raises(Stop):
        jpipe._encode_image_any(jpipe.vae_params, jnp.asarray(x), key)
    lat_t = tpipe._encode_image_any(torch.from_numpy(x), eps)
    assert calls["jax"][2] == calls["port"][2] == 32 and calls["jax"][1] is key
    np.testing.assert_array_equal(calls["port"][0], calls["jax"][0])
    assert calls["port"][1] is eps
    want = tpipe._scale_latent(real(tpipe.vae_params, tpipe.vae_cfg, torch.from_numpy(x), eps,
                                    tile=32))
    assert torch.equal(lat_t, want) and tuple(lat_t.shape) == (2, 16, 8, 8)
    assert not np.allclose(to_np(lat_t), one_shot)


# -- the T5 pad mask and step progress ------------------------------------------------


@pytest.fixture(scope="module")
def masked_txt(f32_runs):
    """Token ids of the prompts and the JAX ``t5_mask_pads=True`` pipeline's
    text conditioning for them."""
    from diffusion_rs_tpu_torch.io.tokenizer import tokenize_and_pad

    jpipe = f32_runs[0]
    jmasked = JPipeline(**{k: getattr(jpipe, k) for k in (
        "flux_params", "flux_cfg", "t5_params", "t5_cfg", "clip_params", "clip_cfg",
        "vae_params", "vae_cfg", "scheduler", "t5_tokenizer", "clip_tokenizer", "dtype")},
        silent=True, t5_mask_pads=True)
    ids = (tokenize_and_pad(I2I_PROMPTS, jpipe.t5_tokenizer, pad_to=I2I_GEN["max_sequence_length"]),
           tokenize_and_pad(I2I_PROMPTS, jpipe.clip_tokenizer))
    txt, _ = jmasked._encode_jit(jmasked.t5_params, jmasked.clip_params, *map(jnp.asarray, ids))
    return [torch.from_numpy(i) for i in ids], np.asarray(txt)


@pytest.mark.parametrize("how", ["argument", "environment"])
def test_t5_mask_pads_matches_jax(f32_runs, masked_txt, monkeypatch, how):
    """t5_mask_pads, by argument or by DIFFUSION_RS_TPU_T5_MASK_PADS=1: the
    port's text conditioning equals JAX's ``t5_mask_pads=True`` pipeline's
    within 1e-5 (measured 7.5e-7) and differs from the unmasked one (0.67); the
    toggle is read-only, as in JAX."""
    kw = f32_runs[2]
    if how == "argument":
        tmasked = TPipeline(**kw, t5_mask_pads=True)
    else:
        monkeypatch.setenv("DIFFUSION_RS_TPU_T5_MASK_PADS", "1")
        tmasked = TPipeline(**kw)
        monkeypatch.delenv("DIFFUSION_RS_TPU_T5_MASK_PADS")
    assert tmasked.t5_mask_pads is True and TPipeline(**kw).t5_mask_pads is False
    with pytest.raises(AttributeError):
        tmasked.t5_mask_pads = False
    ids, txt_j = masked_txt
    assert summed_rel(to_np(tmasked._encode(*ids)[0]), txt_j) <= 1e-5
    assert summed_rel(to_np(TPipeline(**kw)._encode(*ids)[0]), txt_j) > 1e-3


def test_loader_passes_toggles(tmp_path):
    """``Pipeline(t5_mask_pads=, step_progress=)`` reaches the FluxPipeline (the
    loader no longer refuses them), and each falls back to its environment
    variable, as in JAX."""
    from synth import write_checkpoint

    from diffusion_rs_tpu_torch.pipelines.api import ModelSource, Pipeline

    src = ModelSource.from_model_id(str(write_checkpoint(tmp_path / "ck", seed=0)))
    inner = Pipeline(src, silent=True, device="cpu", t5_mask_pads=True, step_progress=True)._inner
    assert inner.t5_mask_pads is True and inner.step_progress is True
    inner = Pipeline(src, silent=True, device="cpu")._inner
    assert inner.t5_mask_pads is False and inner.step_progress is False


def test_step_progress_prints_each_step(f32_runs, capsys, monkeypatch):
    """step_progress (argument, or DIFFUSION_RS_TPU_PROGRESS) prints JAX's
    line ``denoise step i/n (t=...)`` once per step run, and nothing when
    off; read-only."""
    _, _, kw, _ = f32_runs
    monkeypatch.setenv("DIFFUSION_RS_TPU_PROGRESS", "1")
    assert TPipeline(**kw).step_progress is True
    monkeypatch.delenv("DIFFUSION_RS_TPU_PROGRESS")
    loud = TPipeline(**kw, step_progress=True)
    with pytest.raises(AttributeError):
        loud.step_progress = False
    sig = np.array([1.0, 0.75, 0.5, 0.0], np.float32)
    x = torch.zeros((1, 4, 8))
    capsys.readouterr()
    denoise(lambda a, t: torch.ones_like(a), x, sig, progress=True)
    assert capsys.readouterr().out.splitlines() == [
        "denoise step 1/3 (t=1.000)", "denoise step 2/3 (t=0.750)",
        "denoise step 3/3 (t=0.500)"]
    denoise(lambda a, t: torch.ones_like(a), x, sig, progress=False)
    assert capsys.readouterr().out == ""
    images, _ = i2i_inputs()
    loud.forward_arrays(I2I_PROMPTS[:1], TParams(**I2I_GEN), init_image=images[0], strength=IMG2IMG,
                        output_type="latent")
    lines = capsys.readouterr().out.splitlines()
    sigmas = loud._sigmas(TParams(**I2I_GEN))[2:]
    assert lines == [f"denoise step {i + 1}/2 (t={float(t):.3f})"
                     for i, t in enumerate(sigmas[:-1])]

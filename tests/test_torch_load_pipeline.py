"""The whole load path against the JAX package: ``Pipeline(ModelSource...)``
-> ``load_pipeline`` -> ``forward`` in both packages on the same tiny
synthetic checkpoint files (tests/synth.py, dev-style: guidance embedder and
dynamic shift), from five sources: a dense directory, an nf4 directory, a
GGUF q4_0 directory, a DDUF, and a base directory with a BFL-named
single-file q4_0 transformer; and the load-time layout options (``fuse=``
with ``grouped``, DIFFUSION_RS_TPU_FUSED_ROPE=1 under each
DIFFUSION_RS_TPU_ATTN_LAYOUT) through both packages' loaders.

Both packages get the same noise (the port draws the JAX package's noise
for the request's seed); the JAX Pallas kernels run in interpret mode and
the port runs its kernels' plain versions on the CPU.
"""

import importlib
import io
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from diffusion_rs_tpu import DiffusionGenerationParams as JParams
from diffusion_rs_tpu import ModelDType as JDType
from diffusion_rs_tpu import ModelSource as JSource
from diffusion_rs_tpu import Pipeline as JPipeline
from diffusion_rs_tpu.pipelines.sampling import get_noise as j_get_noise
from diffusion_rs_tpu_torch.pipelines.api import ModelDType as TDType
from diffusion_rs_tpu_torch.pipelines.api import ModelSource as TSource
from diffusion_rs_tpu_torch.pipelines.api import Pipeline as TPipeline
from diffusion_rs_tpu_torch.pipelines.flux_pipeline import DiffusionGenerationParams as TParams
from diffusion_rs_tpu_torch.pipelines.loader import load_pipeline
from synth import write_checkpoint, write_dduf
from test_torch_loader import write_bfl_gguf
from torch_port_util import jax_kernels_interpreted, summed_rel  # noqa: F401

PSNR_FLOOR = 42.0  # tests/test_quality_gate.py
# f32 post-denoise latents: the same weights and noise through the same
# algorithm; only f32 summation orders differ (no step function on this
# path: nf4/q4_0 decode the weight, activations stay unquantized). Measured
# 3.8e-6 to 4.2e-6 over the five sources.
LATENT_BAND = 2e-5
GEN = dict(height=64, width=64, num_steps=2, guidance_scale=3.5, seed=42)
PROMPTS = ["a photo of a cat", "the dog"]
SOURCES = ["dense", "nf4", "gguf_q4_0", "dduf", "bfl_gguf"]


@pytest.fixture
def same_noise(monkeypatch):
    tpl = importlib.import_module("diffusion_rs_tpu_torch.pipelines.flux_pipeline")

    def jax_noise(seed, n, h, w, device):
        return torch.from_numpy(np.array(j_get_noise(jax.random.PRNGKey(seed), n, h, w)))

    monkeypatch.setattr(tpl, "get_noise", jax_noise)


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """source name -> (ModelSource kwargs: model_id / transformer / dduf)."""
    root = tmp_path_factory.mktemp("ckpts")
    kw = dict(seed=0, guidance=True, dynamic_shifting=True)
    dense = write_checkpoint(root / "dense", **kw)
    out = {
        "dense": dict(model_id=str(dense)),
        "nf4": dict(model_id=str(write_checkpoint(root / "nf4", quant="nf4", **kw))),
        "gguf_q4_0": dict(model_id=str(write_checkpoint(root / "gguf", quant="gguf_q4_0",
                                                        **kw))),
        "dduf": dict(dduf=str(write_dduf(dense, root / "dense.dduf"))),
        "bfl_gguf": dict(model_id=str(dense), transformer=str(
            write_bfl_gguf(dense, root / "flux1-dev-q4_0.gguf", "q4_0"))),
    }
    return out


def _pipelines(src: dict, dtype: str, **kwargs):
    jd, td = getattr(JDType, dtype), getattr(TDType, dtype)
    if "dduf" in src:
        js, ts = JSource.dduf(src["dduf"]), TSource.dduf(src["dduf"])
    else:
        js = JSource.from_model_id(src["model_id"], src.get("transformer"))
        ts = TSource.from_model_id(src["model_id"], src.get("transformer"))
    return (JPipeline(js, silent=True, dtype=jd, **kwargs),
            TPipeline(ts, silent=True, dtype=td, device="cpu", **kwargs))


def _psnr(a, b) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)


@pytest.mark.parametrize("name", SOURCES)
def test_load_pipeline_matches_jax(name, sources, jax_kernels_interpreted, same_noise):
    """Per source: f32 latents within LATENT_BAND of the JAX package's, and
    the default-dtype (bf16) images above the 42 dB floor."""
    jp, tp = _pipelines(sources[name], "F32")
    lat_j = jp.forward_latents(PROMPTS, JParams(**GEN))
    lat_t = tp.forward_latents(PROMPTS, TParams(**GEN))
    assert lat_t.shape == lat_j.shape == (2, 16, 64) and lat_t.dtype == np.float32
    assert summed_rel(lat_t, lat_j) <= LATENT_BAND

    jp, tp = _pipelines(sources[name], "Auto")
    assert tp._inner.dtype == torch.bfloat16
    img_j = [np.asarray(i) for i in jp.forward_images(PROMPTS, JParams(**GEN))]
    img_t = tp.forward_images(PROMPTS, TParams(**GEN))
    for a, b in zip(img_t, img_j):
        assert a.shape == b.shape == (64, 64, 3) and a.dtype == np.uint8
        assert _psnr(a, b) >= PSNR_FLOOR  # measured 49.2 to 50.7 dB
    assert not np.array_equal(img_t[0], img_t[1])


def test_forward_png_decodes_to_forward_arrays(sources):
    """``Pipeline.forward``'s PNG (written with zlib + struct) decodes to the
    pixels of the ``forward_arrays`` call it made."""
    src = sources["gguf_q4_0"]
    tp = TPipeline(TSource.from_model_id(src["model_id"]), silent=True, device="cpu")
    made = []
    forward_arrays = tp._inner.forward_arrays
    tp._inner.forward_arrays = lambda *a, **kw: made.append(forward_arrays(*a, **kw)) or made[-1]
    pngs = tp.forward(PROMPTS, TParams(**GEN))
    (arr,) = made
    assert len(pngs) == 2
    for png, a in zip(pngs, arr):
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
        img = Image.open(io.BytesIO(png))
        assert img.mode == "RGB" and img.size == (64, 64)
        np.testing.assert_array_equal(np.asarray(img), a)


# name -> (source, Pipeline kwargs, environment): each option through both
# loaders; "a" and "b" are the layouts of chip_smoke.py's configs A and B.
LAYOUTS = {
    "fuse_grouped": ("gguf_q4_0", dict(fuse="grouped"), {}),
    "fuse_all": ("nf4", dict(fuse="all"), {}),
    # nf4 with grouped img/txt pairs: the grouped codebook branch (K11)
    "nf4_grouped": ("nf4", dict(fuse="grouped"), {}),
    "fused_rope": ("dense", {}, {"DIFFUSION_RS_TPU_FUSED_ROPE": "1"}),
    "a_env_streams_grouped_inkernel": ("gguf_q4_0", {}, {
        "DIFFUSION_RS_TPU_FUSE": "img,txt,single,t5,grouped",
        "DIFFUSION_RS_TPU_FUSED_ROPE": "1", "DIFFUSION_RS_TPU_ATTN_LAYOUT": "inkernel"}),
    # "all" means every stream only on its own: this fuses img and txt alone
    "all_comma_grouped": ("gguf_q4_0", dict(fuse="all,grouped"), {}),
    "b_grouped_seqmajor": ("bfl_gguf", dict(fuse="grouped"), {
        "DIFFUSION_RS_TPU_FUSED_ROPE": "1", "DIFFUSION_RS_TPU_ATTN_LAYOUT": "seqmajor"}),
}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_layout_options_match_jax(name, sources, jax_kernels_interpreted, same_noise,
                                  monkeypatch):
    """The port's loader applies the option as the JAX loader does (same
    config flags, fused keys) and the pipelines agree: f32 latents within
    LATENT_BAND, bf16 images above the PSNR floor."""
    src, kwargs, env = LAYOUTS[name]
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    jp, tp = _pipelines(sources[src], "F32", **kwargs)
    inner = tp._inner
    assert inner.flux_cfg.grouped_qmm == jp._inner.flux_cfg.grouped_qmm
    assert inner.flux_cfg.rope_fused == jp._inner.flux_cfg.rope_fused
    assert inner.flux_cfg.grouped_qmm == ("grouped" in kwargs.get(
        "fuse", env.get("DIFFUSION_RS_TPU_FUSE", "")))
    assert inner.flux_cfg.rope_fused == ("DIFFUSION_RS_TPU_FUSED_ROPE" in env)
    assert sorted(inner.flux_params["double"]["img_attn"]) == sorted(
        jp._inner.flux_params["double"]["img_attn"])
    assert sorted(inner.flux_params["single"]) == sorted(jp._inner.flux_params["single"])
    assert sorted(inner.t5_params["blocks"]["attn"]) == sorted(
        jp._inner.t5_params["blocks"]["attn"])
    lat_j = jp.forward_latents(PROMPTS, JParams(**GEN))
    lat_t = tp.forward_latents(PROMPTS, TParams(**GEN))
    assert summed_rel(lat_t, lat_j) <= LATENT_BAND

    jp, tp = _pipelines(sources[src], "Auto", **kwargs)
    img_j = [np.asarray(i) for i in jp.forward_images(PROMPTS, JParams(**GEN))]
    img_t = tp.forward_images(PROMPTS, TParams(**GEN))
    for a, b in zip(img_t, img_j):
        assert _psnr(a, b) >= PSNR_FLOOR


@pytest.mark.parametrize("fuse,env", [
    (None, None), (None, "txt"), (None, "1"), ("all", None), ("all,grouped", None),
    (" img , single ", None), (True, None), (False, "all"), ("0", None), (("txt", "t5"), None),
])
def test_resolve_fuse_matches_jax(monkeypatch, fuse, env):
    """The fuse selection resolves as in the JAX loader: argument, else
    DIFFUSION_RS_TPU_FUSE, else the measured default (none); "all" stands
    for every stream only on its own."""
    from diffusion_rs_tpu.pipelines.loader import _resolve_fuse as j_resolve
    from diffusion_rs_tpu_torch.pipelines.loader import _resolve_fuse as t_resolve

    if env is None:
        monkeypatch.delenv("DIFFUSION_RS_TPU_FUSE", raising=False)
    else:
        monkeypatch.setenv("DIFFUSION_RS_TPU_FUSE", env)
    assert t_resolve(fuse) == j_resolve(fuse)


@pytest.mark.parametrize("option,value", [
    # a mesh runs, tp included (tests/test_torch_mesh.py), unless its tp does
    # not divide the heads (tests/synth.py's FLUX has 2): the port refuses
    # what GSPMD would pad
    ("mesh", SimpleNamespace(shape={"dp": 1, "sp": 1, "tp": 3})),
])
def test_unported_options_raise(sources, option, value):
    src = TSource.from_model_id(sources["dense"]["model_id"])
    with pytest.raises(ValueError, match="FLUX num_attention_heads = 2 is not divisible by tp=3"):
        load_pipeline(src, device="cpu", **{option: value})

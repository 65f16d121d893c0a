"""LoRA files in the port against the JAX package (io/lora.py): the cases of
tests/test_lora.py run through both packages on the same files and trees.

Runtime terms on quantized bases are built from the same numpy factors in
both packages and must be equal. Deltas fused into dense bases are a rank-r
f32 matmul (numpy's against torch's), held within 1e-6 relative.
"""

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
from diffusion_rs_tpu.io import lora as jlora
from diffusion_rs_tpu.models.flux import FluxConfig as JFluxConfig
from diffusion_rs_tpu.models.flux import init_flux_params as j_init_flux
from diffusion_rs_tpu.models.optimize import fuse_flux_qkv as j_fuse
from diffusion_rs_tpu.ops.linear import Linear as JLinear
from diffusion_rs_tpu.ops.linear import linear as j_linear
from diffusion_rs_tpu.pipelines.sampling import get_noise as j_get_noise
from diffusion_rs_tpu.util.synthetic import init_flux_params_quantized as j_init_quantized
from diffusion_rs_tpu.util.synthetic import random_qtensor as j_random_qtensor
from diffusion_rs_tpu_torch.io import lora as tlora
from diffusion_rs_tpu_torch.io.safetensors import save_safetensors
from diffusion_rs_tpu_torch.models.flux import FluxConfig
from diffusion_rs_tpu_torch.ops.linear import linear as t_linear
from diffusion_rs_tpu_torch.pipelines.api import ModelDType as TDType
from diffusion_rs_tpu_torch.pipelines.api import ModelSource as TSource
from diffusion_rs_tpu_torch.pipelines.api import Pipeline as TPipeline
from diffusion_rs_tpu_torch.pipelines.flux_pipeline import DiffusionGenerationParams as TParams
from synth import FLUX_HIDDEN, write_checkpoint
from test_torch_isq import _assert_trees_equal
from torch_port_util import jax_kernels_interpreted, port_params, summed_rel  # noqa: F401

RANK = 4
CFG = dict(in_channels=64, pooled_projection_dim=64, joint_attention_dim=64,
           num_attention_heads=2, num_layers=2, num_single_layers=2, guidance_embeds=False,
           hidden_size=FLUX_HIDDEN, axes_dim=(4, 6, 6))


def _cfgs():
    return JFluxConfig(**CFG), FluxConfig(**CFG)


def _pair(t, rng, base, k_in, n_out, a_suf=".lora_A.weight", b_suf=".lora_B.weight",
          prefix="transformer.", alpha=None, mag=1.0):
    t[f"{prefix}{base}{a_suf}"] = (rng.standard_normal((RANK, k_in)) * mag).astype(np.float32)
    t[f"{prefix}{base}{b_suf}"] = (rng.standard_normal((n_out, RANK)) * mag).astype(np.float32)
    if alpha is not None:
        t[f"{prefix}{base}.alpha"] = np.float32(alpha)


def _write(path, tensors) -> str:
    save_safetensors(str(path), tensors)
    return str(path)


def _peft_or_kohya(tmp_path, kohya: bool) -> str:
    """A double block's q, a single block's linear2 and the x_embedder, with
    alpha, in diffusers-PEFT or kohya suffixes."""
    rng = np.random.default_rng(1)
    h = FLUX_HIDDEN
    sufs = (".lora_down.weight", ".lora_up.weight") if kohya else (
        ".lora_A.weight", ".lora_B.weight")
    t = {}
    for base, k_in, n_out in (("transformer_blocks.1.attn.to_q", h, h),
                              ("single_transformer_blocks.0.proj_out", 5 * h, h),
                              ("x_embedder", 64, h)):
        _pair(t, rng, base, k_in, n_out, *sufs, alpha=2 * RANK)
    return _write(tmp_path / "l.safetensors", t)


def test_read_lora_file_matches_jax(tmp_path):
    path = _peft_or_kohya(tmp_path, kohya=False)
    j, t = jlora.read_lora_file(path), tlora.read_lora_file(path)
    assert sorted(j) == sorted(t)
    for key in j:
        assert sorted(j[key]) == sorted(t[key])
        np.testing.assert_array_equal(np.asarray(j[key]["A"]), t[key]["A"])
        np.testing.assert_array_equal(np.asarray(j[key]["B"]), t[key]["B"])
        assert j[key].get("alpha") == t[key].get("alpha")


def _apply_both(jparams, path, scale=1.0, dtype=jnp.float32):
    jcfg, tcfg = _cfgs()
    tparams = port_params(jparams, "cpu")
    jout = jlora.apply_flux_lora(jparams, jcfg, path, scale=scale, dtype=dtype)
    tout = tlora.apply_flux_lora(tparams, tcfg, path, scale=scale,
                                 dtype=torch.float32 if dtype == jnp.float32 else torch.bfloat16)
    return jout, tout


@pytest.mark.parametrize("kohya", [False, True], ids=["peft", "kohya"])
def test_apply_fuses_dense_like_jax(tmp_path, kohya):
    """Dense bases: the fused weights within 1e-6 of JAX's, untouched layers
    equal, the source tree's tensors not written."""
    path = _peft_or_kohya(tmp_path, kohya)
    jparams = j_init_flux(jax.random.PRNGKey(0), _cfgs()[0], jnp.float32)
    jout, tout = _apply_both(jparams, path, scale=0.5)
    _assert_trees_equal(tout, port_params(jout, "cpu"))
    before = port_params(j_init_flux(jax.random.PRNGKey(0), _cfgs()[0], jnp.float32), "cpu")
    assert torch.equal(tout["double"]["img_attn"]["q"].w[0],
                       before["double"]["img_attn"]["q"].w[0])
    assert not torch.equal(tout["double"]["img_attn"]["q"].w[1],
                           before["double"]["img_attn"]["q"].w[1])


def test_kohya_bfl_naming_like_jax(tmp_path):
    """sd-scripts / kohya ``lora_unet_*`` BFL names: fused qkv and linear1
    factors split by rows of B onto the diffusers-shaped tree; the final
    AdaLN's B halves swapped."""
    rng = np.random.default_rng(7)
    h, mlp = FLUX_HIDDEN, 4 * FLUX_HIDDEN
    t = {}
    _pair(t, rng, "lora_unet_double_blocks_1_img_attn_qkv", h, 3 * h, ".lora_down.weight",
          ".lora_up.weight", prefix="", alpha=RANK)
    _pair(t, rng, "lora_unet_single_blocks_0_linear1", h, 3 * h + mlp, ".lora_down.weight",
          ".lora_up.weight", prefix="")
    _pair(t, rng, "lora_unet_final_layer_adaLN_modulation_1", h, 2 * h, ".lora_down.weight",
          ".lora_up.weight", prefix="")
    _pair(t, rng, "lora_unet_txt_in", 64, h, ".lora_down.weight", ".lora_up.weight", prefix="")
    path = _write(tmp_path / "k.safetensors", t)
    jout, tout = _apply_both(j_init_flux(jax.random.PRNGKey(0), _cfgs()[0], jnp.float32), path)
    _assert_trees_equal(tout, port_params(jout, "cpu"))


def test_lora_on_fused_trees_like_jax(tmp_path):
    """Fused qkv trees: per-part targets land in the fused linear's column
    range, as a dense delta and as a runtime term on quantized bases (equal
    to JAX's, stacked [L, K, r] / [L, r, N])."""
    rng = np.random.default_rng(8)
    h = FLUX_HIDDEN
    t = {}
    _pair(t, rng, "transformer_blocks.0.attn.to_k", h, h)
    _pair(t, rng, "single_transformer_blocks.1.attn.to_v", h, h)
    path = _write(tmp_path / "f.safetensors", t)
    jcfg = _cfgs()[0]
    dense = j_fuse(j_init_flux(jax.random.PRNGKey(0), jcfg, jnp.float32), ("img", "single"))
    jout, tout = _apply_both(dense, path)
    _assert_trees_equal(tout, port_params(jout, "cpu"))
    quant = j_fuse(j_init_quantized(jax.random.PRNGKey(1), jcfg), ("img", "single"))
    jout, tout = _apply_both(quant, path, dtype=jnp.bfloat16)
    _assert_trees_equal(tout, port_params(jout, "cpu"))
    a, bl = tout["double"]["img_attn"]["qkv"].lora
    assert a.shape == (2, h, RANK) and bl.shape == (2, RANK, 3 * h)
    assert bl[0][:, h:2 * h].abs().sum() > 0 and bl[0][:, :h].abs().sum() == 0
    assert bl[1].abs().sum() == 0


def test_multi_lora_stacking_like_jax(tmp_path):
    """Two files on quantized bases: the runtime terms concatenate along the
    rank (x_embedder: rank 2r), equal to JAX's."""
    rng = np.random.default_rng(9)
    h = FLUX_HIDDEN
    paths = []
    for i in range(2):
        t = {}
        _pair(t, rng, "x_embedder", 64, h, mag=0.2)
        _pair(t, rng, "transformer_blocks.0.attn.to_q", h, h, mag=0.2)
        paths.append(_write(tmp_path / f"l{i}.safetensors", t))
    jcfg, tcfg = _cfgs()
    jparams = j_init_quantized(jax.random.PRNGKey(2), jcfg)
    tparams = port_params(jparams, "cpu")
    for path, scale in zip(paths, (1.0, 0.5)):
        jparams = jlora.apply_flux_lora(jparams, jcfg, path, scale=scale)
        tparams = tlora.apply_flux_lora(tparams, tcfg, path, scale=scale)
    _assert_trees_equal(tparams, port_params(jparams, "cpu"))
    assert tparams["img_in"].lora[0].shape[-1] == 2 * RANK


def test_quantized_linear_lora_term_like_jax():
    """A quantized base with a runtime term: ``linear`` equals JAX's."""
    rng = np.random.default_rng(3)
    qt = j_random_qtensor(jax.random.PRNGKey(0), 256, 128)
    A = rng.standard_normal((RANK, 256)).astype(np.float32)
    B = rng.standard_normal((128, RANK)).astype(np.float32)
    jl = JLinear(w=qt, lora=(jnp.asarray(A.T), jnp.asarray(B.T * 0.7)))
    x = rng.standard_normal((8, 256)).astype(np.float32)
    want = np.asarray(j_linear(jnp.asarray(x), jl))
    got = t_linear(torch.from_numpy(x), port_params(jl, "cpu")).numpy()
    assert summed_rel(got, want) <= 1e-6


def test_text_encoder_groups_unmatched_keys_like_jax(tmp_path):
    """Text-encoder groups are skipped (a file of only those raises);
    unmatched keys raise; in both packages alike."""
    rng = np.random.default_rng(2)
    t = {}
    _pair(t, rng, "x_embedder", 64, FLUX_HIDDEN)
    _pair(t, rng, "text_encoder.layers.0.q", 8, 8, prefix="")
    mixed = _write(tmp_path / "mix.safetensors", t)
    te = _write(tmp_path / "te.safetensors", {k: v for k, v in t.items()
                                              if k.startswith("text_encoder.")})
    bad = _write(tmp_path / "bad.safetensors", {
        "lora_unet_mystery_block.lora_A.weight": np.zeros((2, 4), np.float32),
        "lora_unet_mystery_block.lora_B.weight": np.zeros((4, 2), np.float32)})
    jout, tout = _apply_both(j_init_flux(jax.random.PRNGKey(0), _cfgs()[0], jnp.float32), mixed)
    _assert_trees_equal(tout, port_params(jout, "cpu"))
    for path, msg in ((te, "only text-encoder"), (bad, "do not match")):
        for apply, params in (
                (jlora.apply_flux_lora, j_init_flux(jax.random.PRNGKey(0), _cfgs()[0])),
                (tlora.apply_flux_lora, None)):
            if params is None:
                params = port_params(j_init_flux(jax.random.PRNGKey(0), _cfgs()[0]), "cpu")
                cfg = _cfgs()[1]
            else:
                cfg = _cfgs()[0]
            with pytest.raises(ValueError, match=msg):
                apply(params, cfg, path)


@pytest.fixture
def same_noise(monkeypatch):
    tpl = importlib.import_module("diffusion_rs_tpu_torch.pipelines.flux_pipeline")

    def jax_noise(seed, n, h, w, device):
        return torch.from_numpy(np.array(j_get_noise(jax.random.PRNGKey(seed), n, h, w)))

    monkeypatch.setattr(tpl, "get_noise", jax_noise)


def test_lora_pipeline_on_nf4_checkpoint_like_jax(tmp_path, jax_kernels_interpreted,
                                                  same_noise):
    """``Pipeline(lora=)`` on an nf4 checkpoint without ISQ: runtime terms on
    the quantized x_embedder and stacked ff.net.2, a fused delta on the
    dense to_q; the same trees and f32 latents within 2e-5 of JAX's
    (tests/test_torch_load_pipeline.py's band)."""
    root = write_checkpoint(tmp_path / "ck", seed=0, quant="nf4")
    rng = np.random.default_rng(6)
    h = FLUX_HIDDEN
    t = {}
    _pair(t, rng, "x_embedder", 64, h, mag=0.2)
    _pair(t, rng, "transformer_blocks.0.ff.net.2", 4 * h, h, mag=0.2)
    _pair(t, rng, "transformer_blocks.1.attn.to_q", h, h, mag=0.2)
    path = _write(tmp_path / "l.safetensors", t)
    gen = dict(height=64, width=64, num_steps=2, guidance_scale=0.0, seed=42)
    jp = JPipeline(JSource.from_model_id(str(root)), silent=True, dtype=JDType.F32, lora=path)
    tp = TPipeline(TSource.from_model_id(str(root)), silent=True, dtype=TDType.F32,
                   device="cpu", lora=path)
    _assert_trees_equal(tp._inner.flux_params, port_params(jp._inner.flux_params, "cpu"))
    assert tp._inner.flux_params["img_in"].lora is not None
    lat_j = jp.forward_latents(["a cat"], JParams(**gen))
    lat_t = tp.forward_latents(["a cat"], TParams(**gen))
    assert summed_rel(lat_t, lat_j) <= 2e-5

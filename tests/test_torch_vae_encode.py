"""The parts of img2img and inpainting under the pipeline, through the port
against the JAX package: the VAE encoder (moments, mode, the keyed sample,
the tiled encode of tests/test_vae.py's cases), its weights through the
loader's builder, the synthetic encoder factory, and the Euler loop with
the inpaint blend. f32 on the CPU; the pipeline is in
tests/test_torch_img2img.py and tests/test_torch_img2img_bf16.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_rs_tpu.io import builders as jb
from diffusion_rs_tpu.io.varstore import VarStore as JVarStore
from diffusion_rs_tpu.models import vae as jvae
from diffusion_rs_tpu_torch.io import builders as tb
from diffusion_rs_tpu_torch.io.varstore import VarStore as TVarStore
from diffusion_rs_tpu_torch.models import vae as tvae
from diffusion_rs_tpu_torch.pipelines.sampling import denoise
from diffusion_rs_tpu_torch.util import synthetic as syn
from torch_port_util import port_params, summed_rel, to_jax_tree, to_np


# -- the VAE encoder -----------------------------------------------------------

# tests/test_vae.py's tiled-encode VAE: two stages (2x), 8 groups of 32
TINY_VAE = dict(block_out_channels=(32, 32), norm_num_groups=8, latent_channels=16)


@pytest.fixture(scope="module")
def tiny_vae():
    cfg = tvae.VAEConfig(**TINY_VAE)
    tp = syn.init_vae_encoder_params(3, cfg, torch.float32, device="cpu")
    return jvae.VAEConfig(**TINY_VAE), to_jax_tree(tp), tp, cfg


def test_vae_encode_moments_and_mode_match_jax(tiny_vae):
    """The encoder tower's mean|logvar moments and the mode, f32, within 1e-5
    summed-relative of JAX's (measured 1.3e-6 and 1.3e-6)."""
    jcfg, jp, tp, tcfg = tiny_vae
    x = np.random.default_rng(0).standard_normal((1, 48, 48, 3)).astype(np.float32) * 0.5
    mom_j = np.asarray(jax.jit(jvae._encode_moments, static_argnums=1)(jp, jcfg, x))
    mom_t = to_np(tvae._encode_moments(tp, tcfg, torch.from_numpy(x)))
    assert mom_t.shape == mom_j.shape == (1, 24, 24, 32)
    assert summed_rel(mom_t, mom_j) <= 1e-5
    mode_t = to_np(tvae.vae_encode(tp, tcfg, torch.from_numpy(x)))
    assert summed_rel(mode_t, mom_j[..., :16]) <= 1e-5
    np.testing.assert_array_equal(mode_t, mom_t[..., :16])


@pytest.mark.parametrize("shape,tile,overlap", [
    ((1, 48, 48, 3), 64, 8),   # one tile: vae_encode itself
    ((1, 48, 48, 3), 32, 8),   # 2x2 tiles, feathered moments
    ((1, 44, 60, 3), 32, 8),   # uneven edges
])
def test_vae_encode_tiled_matches_jax(tiny_vae, shape, tile, overlap):
    """tests/test_vae.py's tiled-encode cases, each keyed: the same
    standard-normal draw (JAX's for key 9) through both packages' tiled
    encode, f32 within 1e-5 summed-relative (measured <= 6.5e-7); the
    trivial tiling equals the port's one-shot encode exactly, as in JAX, and
    a real tiling moves the moments, never the draw."""
    jcfg, jp, tp, tcfg = tiny_vae
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32) * 0.5
    lat_shape = (shape[0], shape[1] // 2, shape[2] // 2, 16)
    eps = np.asarray(jax.random.normal(jax.random.PRNGKey(9), lat_shape, jnp.float32))
    encode = jax.jit(jvae.vae_encode_tiled, static_argnums=1, static_argnames=("tile", "overlap"))
    out_j = np.asarray(encode(jp, jcfg, x, jax.random.PRNGKey(9), tile=tile, overlap=overlap))
    out_t = to_np(tvae.vae_encode_tiled(tp, tcfg, torch.from_numpy(x), torch.from_numpy(eps),
                                        tile=tile, overlap=overlap))
    assert out_t.shape == out_j.shape == lat_shape
    assert summed_rel(out_t, out_j) <= 1e-5
    one_shot = to_np(tvae.vae_encode(tp, tcfg, torch.from_numpy(x), torch.from_numpy(eps)))
    if tile >= max(shape[1:3]):
        np.testing.assert_array_equal(out_t, one_shot)
    else:
        assert not np.array_equal(out_t, one_shot)


def test_denoise_blend_matches_jax_scan():
    """The Euler loop with the inpaint blend and a truncated schedule against
    JAX's ``denoise_scan`` on the same smooth stand-in model: f32 within
    1e-6 summed-relative (measured 1.0e-8); at the last step (sigma 0) the
    mask-0 entries are the init latent bit for bit in both."""
    from diffusion_rs_tpu.pipelines.sampling import denoise_scan

    rng = np.random.default_rng(5)
    x0, init, noise = (rng.standard_normal((2, 16, 64)).astype(np.float32) for _ in range(3))
    mask = np.repeat((rng.random((2, 16, 4)) > 0.5).astype(np.float32), 16, axis=2)
    sig = np.array([0.8, 0.55, 0.3, 0.0], np.float32)
    w = rng.standard_normal((64, 64)).astype(np.float32) * 0.1

    def jstep(x, t):
        return jnp.tanh(x @ w) * t + 0.5 * x

    def tstep(x, t):
        return torch.tanh(x @ torch.from_numpy(w)) * t + 0.5 * x

    out_j = np.asarray(jax.jit(lambda a: denoise_scan(
        jstep, a, jnp.asarray(sig), inpaint=tuple(map(jnp.asarray, (mask, init, noise)))))(x0))
    out_t = to_np(denoise(tstep, torch.from_numpy(x0), sig,
                          inpaint=tuple(map(torch.from_numpy, (mask, init, noise)))))
    assert summed_rel(out_t, out_j) <= 1e-6
    keep = mask == 0
    np.testing.assert_array_equal(out_t[keep], init[keep])
    np.testing.assert_array_equal(out_j[keep], init[keep])
    assert not np.allclose(out_t[~keep], init[~keep])




def test_build_vae_params_encoder_matches_jax():
    """The loader's VAE builder: the encoder tower and ``quant_conv`` (and the
    decoder) from diffusers AutoencoderKL tensor names equal the JAX
    builder's tree carried over by the bridge, tensor for tensor."""
    from synth import vae_tensors

    from diffusion_rs_tpu.models.vae import VAEConfig as JCfg

    t = vae_tensors(np.random.default_rng(2))
    t["quant_conv.weight"] = np.random.default_rng(3).standard_normal((32, 32, 1, 1)).astype(
        np.float32)
    t["quant_conv.bias"] = np.zeros(32, np.float32)
    d = dict(block_out_channels=(8, 8, 8, 8), layers_per_block=1, norm_num_groups=4)
    js, ts = JVarStore(default_dtype=jnp.bfloat16), TVarStore(torch.bfloat16, device="cpu")
    for name, arr in t.items():
        js.add_array(name, arr)
        ts.add_tensor(name, torch.from_numpy(arr))
    jt = jb.build_vae_params(js, JCfg(**d), jnp.bfloat16)
    tt = tb.build_vae_params(ts, tvae.VAEConfig(**d), torch.bfloat16)
    want = port_params(jt)
    assert sorted(tt) == sorted(want) == ["decoder", "encoder", "post_quant_conv", "quant_conv"]
    assert len(tt["encoder"]["down"]) == 4 and tt["encoder"]["down"][-1]["downsample"] is None
    a, b = syn_leaves(tt), syn_leaves(want)
    assert len(a) == len(b) and all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


def syn_leaves(tree) -> list:
    """Tensors of a port tree in key order (Conv / Linear: w, then b)."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in syn_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in syn_leaves(v)]
    return syn_leaves(tree.w) + syn_leaves(tree.b)


def test_encoder_factory_is_independent_of_the_decoder():
    """The synthetic encoder draws from its own generator: the decoder's
    weights for a seed are the same whether or not an encoder was made, and
    the encoder is that of the JAX package's tree schema (``init_vae_params``:
    down tower, mid, conv_out to 2 x latent channels, quant_conv)."""
    cfg = tvae.VAEConfig(block_out_channels=(32, 32), norm_num_groups=8, use_quant_conv=True)
    dec = syn.init_vae_decoder_params(3, cfg, torch.float32, device="cpu")
    enc = syn.init_vae_encoder_params(3, cfg, torch.float32, device="cpu")
    again = syn.init_vae_decoder_params(3, cfg, torch.float32, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(syn_leaves(dec), syn_leaves(again)))
    jcfg = jvae.VAEConfig(block_out_channels=(32, 32), norm_num_groups=8, use_quant_conv=True)
    jref = jax.eval_shape(lambda k: jvae.init_vae_params(k, jcfg), jax.random.PRNGKey(0))
    for name in ("encoder", "quant_conv"):
        assert ([tuple(x.shape) for x in syn_leaves(enc[name])]
                == [tuple(x.shape) for x in jax.tree.leaves(jref[name])])
    assert tuple(enc["quant_conv"].w.shape) == (1, 1, 32, 32)

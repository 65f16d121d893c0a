"""Parity of the port's text encoders (T5 with nf4 linears, CLIP) and VAE
decoder with the JAX package at tiny configs, inputs and weights from a
numpy/JAX seed. T5's nf4 linears run the JAX Pallas kernel in interpret
mode and the port's nf4 kernel's plain version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_rs_tpu.models import clip as jclip, t5 as jt5, vae as jvae
from diffusion_rs_tpu.quant import bnb as jbnb
from diffusion_rs_tpu_torch.models import clip as tclip, t5 as tt5, vae as tvae
from torch_port_util import (  # noqa: F401
    jax_kernels_interpreted, port_params, quantize_tree, summed_rel, to_np)


JT5_TINY = jt5.T5Config(vocab_size=300, d_model=256, d_kv=64, d_ff=512, num_layers=2,
                        num_heads=4)
TT5_TINY = tt5.T5Config(vocab_size=300, d_model=256, d_kv=64, d_ff=512, num_layers=2,
                        num_heads=4)


def _nf4(w):
    return jbnb.quantize_nf4(np.ascontiguousarray(w.T), blocksize=64)


@pytest.mark.parametrize("mask_pads", [False, True])
def test_t5_encode_nf4_matches_jax(rng, jax_kernels_interpreted, mask_pads):
    jp = quantize_tree(jt5.init_t5_params(jax.random.PRNGKey(1), JT5_TINY), _nf4,
                       jnp.float32)
    ids = rng.integers(1, 300, (2, 24)).astype(np.int32)
    ids[1, 15:] = 0
    out_j = np.asarray(jt5.t5_encode(jp, JT5_TINY, jnp.asarray(ids), mask_pads=mask_pads))
    out_t = to_np(tt5.t5_encode(port_params(jp), TT5_TINY, torch.from_numpy(ids),
                                mask_pads=mask_pads))
    assert summed_rel(out_t, out_j) <= 1e-5  # measured 1.9e-6


def test_relative_position_buckets_exact():
    """Every (query, key) position up to 512, T5-XXL's bucket settings."""
    b_j = np.asarray(jt5.relative_position_buckets(512, 512, 32, 128))
    b_t = tt5.relative_position_buckets(512, 512, 32, 128).numpy()
    np.testing.assert_array_equal(b_t, b_j)


def test_t5_f16_clamp():
    x = torch.tensor([70000.0, -70000.0, 1.0], dtype=torch.float32).half()
    np.testing.assert_array_equal(
        to_np(tt5._clamp_f16(x)),
        np.asarray(jt5._clamp_f16(jnp.asarray([70000.0, -70000.0, 1.0], jnp.float16)),
                   np.float32))
    y = torch.tensor([1e6])
    assert tt5._clamp_f16(y) is y


JCLIP_TINY = jclip.ClipTextConfig(vocab_size=300, projection_dim=64, intermediate_size=128,
                                  num_hidden_layers=2, num_attention_heads=4)
TCLIP_TINY = tclip.ClipTextConfig(vocab_size=300, projection_dim=64, intermediate_size=128,
                                  num_hidden_layers=2, num_attention_heads=4)


def test_clip_encode_matches_jax(rng):
    jp = jclip.init_clip_params(jax.random.PRNGKey(2), JCLIP_TINY)
    ids = rng.integers(1, 290, (2, 11)).astype(np.int32)
    ids[0, 6] = 299  # EOS (largest id) mid-sequence
    ids[1, 10] = 299
    h_j, p_j = jclip.clip_encode(jp, JCLIP_TINY, jnp.asarray(ids))
    h_t, p_t = tclip.clip_encode(port_params(jp), TCLIP_TINY, torch.from_numpy(ids))
    np.testing.assert_allclose(to_np(h_t), np.asarray(h_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(to_np(p_t), np.asarray(p_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(to_np(p_t), to_np(h_t)[[0, 1], [6, 10]])


JVAE_TINY = jvae.VAEConfig(block_out_channels=(32, 64), norm_num_groups=8,
                           use_post_quant_conv=True)
TVAE_TINY = tvae.VAEConfig(block_out_channels=(32, 64), norm_num_groups=8,
                           use_post_quant_conv=True)


def _vae_pair(dtype, z):
    jp = jax.tree.map(lambda a: jnp.asarray(a, getattr(jnp, dtype)),
                      jvae.init_vae_params(jax.random.PRNGKey(3), JVAE_TINY))
    tp = port_params({"decoder": jp["decoder"], "post_quant_conv": jp["post_quant_conv"]})
    out_j = jvae.vae_decode(jp, JVAE_TINY, jnp.asarray(z, getattr(jnp, dtype)))
    out_t = tvae.vae_decode(tp, TVAE_TINY, torch.from_numpy(z).to(getattr(torch, dtype)))
    assert tuple(out_t.shape) == (1, 16, 16, 3)
    return np.asarray(out_j, np.float32), to_np(out_t)


def test_vae_decode_f32_matches_jax(rng):
    out_j, out_t = _vae_pair("float32", rng.standard_normal((1, 8, 8, 16)).astype(np.float32))
    assert summed_rel(out_t, out_j) <= 1e-5  # measured 9.0e-7


def test_vae_decode_bf16_as_close_as_jax(rng):
    """bf16: each package's output sits ~1.1e-2 from the f32 result (XLA and
    PyTorch round the conv outputs and norms at other points); the port must
    be no further from it than JAX's own bf16 run (+25%), and within 2e-2 of
    that run (measured 1.3e-2)."""
    z = rng.standard_normal((1, 8, 8, 16)).astype(np.float32)
    ref, _ = _vae_pair("float32", z)
    out_j, out_t = _vae_pair("bfloat16", z)
    assert summed_rel(out_t, ref) <= 1.25 * summed_rel(out_j, ref)
    assert summed_rel(out_t, out_j) <= 2e-2

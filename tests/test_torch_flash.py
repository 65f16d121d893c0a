"""Parity of the port's attention, RoPE and norms with the JAX package.

The flash kernel's plain version (the port's CPU path) is held against the
JAX Pallas flash kernel in interpret mode (seq-major output, as FLUX uses
it) and against the f32 ``sdpa_xla`` reference, at the 5e-4 summed-relative
band of tests/test_ops.py:130, including a ragged kv length. The CUDA kernel
is held against the plain version on the card by tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_rs_tpu import ops as jops
from diffusion_rs_tpu.ops.flash_pallas import flash_attention as j_flash
from diffusion_rs_tpu_torch import ops as tops
from diffusion_rs_tpu_torch.ops import flash as tflash
from torch_port_util import summed_rel, to_np

FLASH_BAND = 5e-4  # tests/test_ops.py:130


def _qkv(rng, b, h, s, d):
    return [rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("s", [300, 130])
def test_k3_plain_matches_interpreted_pallas_seqmajor(rng, s):
    q, k, v = _qkv(rng, 1, 2, s, 128)
    o_j = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             interpret=True, out_seqmajor=True))
    o_t = to_np(tflash.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                       torch.from_numpy(v), out_seqmajor=True))
    assert o_t.shape == (1, s, 256)
    assert summed_rel(o_t, o_j) <= FLASH_BAND


@pytest.mark.parametrize("block_k", [64, 128, 1536])
def test_k3_plain_matches_sdpa_xla(rng, block_k):
    """The per-block online softmax agrees with the f32 reference at any
    kv block size, ragged tail included (S = 300)."""
    q, k, v = _qkv(rng, 1, 2, 300, 128)
    o_ref = np.asarray(jops.sdpa_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    o_t = to_np(tflash.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        scale=128 ** -0.5, block_k=block_k))
    assert summed_rel(o_t, o_ref) <= FLASH_BAND


def test_k3_bf16_matches_interpreted_pallas(rng):
    """bf16 inputs: P.V takes p rounded to bf16 while l sums the f32 p, in
    both packages."""
    q, k, v = _qkv(rng, 1, 2, 200, 128)
    args_j = [jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)]
    o_j = np.asarray(j_flash(*args_j, interpret=True, out_seqmajor=True), np.float32)
    args_t = [torch.from_numpy(t).bfloat16() for t in (q, k, v)]
    o_t = to_np(tflash.flash_attention(*args_t, out_seqmajor=True))
    # bf16 output rounding plus the kv block size (64 vs 256 here)
    assert summed_rel(o_t, o_j) <= 4e-3


def test_sdpa_merged_and_sdpa_dispatch(rng):
    q, k, v = _qkv(rng, 2, 2, 40, 128)
    qt, kt, vt = (torch.from_numpy(t) for t in (q, k, v))
    ref = np.asarray(jops.sdpa_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    merged = to_np(tops.sdpa_merged(qt, kt, vt))
    assert merged.shape == (2, 40, 256)
    np.testing.assert_allclose(merged, ref.transpose(0, 2, 1, 3).reshape(2, 40, 256),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(to_np(tops.sdpa(qt, kt, vt)), ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(to_np(tops.sdpa_merged(qt, kt, vt, impl="xla")),
                               ref.transpose(0, 2, 1, 3).reshape(2, 40, 256),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("softcap", [None, 30.0])
def test_sdpa_xla_bias_softcap_matches_jax(rng, softcap):
    q, k, v = _qkv(rng, 2, 3, 16, 64)
    bias = rng.standard_normal((1, 3, 16, 16)).astype(np.float32)
    o_j = np.asarray(jops.sdpa_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   scale=0.3, bias=jnp.asarray(bias), softcap=softcap))
    o_t = to_np(tops.sdpa_xla(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), scale=0.3,
                              bias=torch.from_numpy(bias), softcap=softcap))
    np.testing.assert_allclose(o_t, o_j, rtol=1e-5, atol=1e-6)


def test_rope_tables_and_apply_match_jax(rng):
    ids = np.concatenate([np.zeros((1, 7, 3)), rng.integers(0, 64, (1, 20, 3))],
                         axis=1).astype(np.float32)
    cos_j, sin_j = jops.rope_tables(jnp.asarray(ids), (16, 56, 56))
    cos_t, sin_t = tops.rope_tables(torch.from_numpy(ids), (16, 56, 56))
    np.testing.assert_allclose(to_np(cos_t), np.asarray(cos_j), rtol=0, atol=2e-6)
    np.testing.assert_allclose(to_np(sin_t), np.asarray(sin_j), rtol=0, atol=2e-6)
    x = rng.standard_normal((1, 2, 27, 128)).astype(np.float32)
    o_j = np.asarray(jops.apply_rope(jnp.asarray(x), cos_j, sin_j))
    o_t = to_np(tops.apply_rope(torch.from_numpy(x), cos_t, sin_t))
    np.testing.assert_allclose(o_t, o_j, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match_jax(rng, dtype):
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3 + 1
    w = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    xj, wj, bj = (jnp.asarray(a, jd) for a in (x, w, b))
    xt, wt, bt = (torch.from_numpy(a).to(td) for a in (x, w, b))
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=1e-2, atol=2e-2)
    np.testing.assert_allclose(to_np(tops.layer_norm(xt, wt, bt)),
                               np.asarray(jops.layer_norm(xj, wj, bj), np.float32), **tol)
    np.testing.assert_allclose(to_np(tops.layer_norm(xt)),
                               np.asarray(jops.layer_norm(xj), np.float32), **tol)
    np.testing.assert_allclose(to_np(tops.rms_norm(xt, wt)),
                               np.asarray(jops.rms_norm(xj, wj), np.float32), **tol)
    xg = rng.standard_normal((2, 4, 4, 32)).astype(np.float32)
    wg, bg = w[:32], b[:32]
    np.testing.assert_allclose(
        to_np(tops.group_norm(torch.from_numpy(xg).to(td), 8, torch.from_numpy(wg).to(td),
                              torch.from_numpy(bg).to(td))),
        np.asarray(jops.group_norm(jnp.asarray(xg, jd), 8, jnp.asarray(wg, jd),
                                   jnp.asarray(bg, jd)), np.float32), **tol)

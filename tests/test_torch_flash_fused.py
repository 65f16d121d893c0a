"""Parity of the port's seq-major attention (K6, K7) and half-split RoPE with
the JAX package.

K6's plain version is held against ``_flash_sm_call`` and K7's against
``_flash_rope_call`` (Pallas in interpret mode), ragged lengths included, at
the bands of tests/test_torch_flash.py: FLASH_BAND in f32, 4e-3 in bf16
(bf16 output rounding plus the kv block size). ``flash_attention_fused``
takes the same route as the JAX package's under each layout. The CUDA
kernels are held against these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_rs_tpu.ops import rope as jrope
from diffusion_rs_tpu.ops.flash_pallas import _flash_rope_call, _flash_sm_call
from diffusion_rs_tpu.ops.flash_pallas import flash_attention_fused as j_fused
from diffusion_rs_tpu_torch.ops import flash as tflash
from diffusion_rs_tpu_torch.ops import rope as trope
from test_torch_flash import FLASH_BAND
from torch_port_util import summed_rel, to_np

D = 128


def _tables(rng, b, s):
    """FLUX-style ids (text rows at 0, then an image grid) -> cos/sin from
    the JAX package, and their expanded forms."""
    txt = np.zeros((b, s // 4, 3))
    n_img = s - s // 4
    img = np.stack([np.zeros(n_img), np.arange(n_img) // 8, np.arange(n_img) % 8], -1)
    ids = np.concatenate([txt, np.broadcast_to(img, (b, n_img, 3))], axis=1)
    cos, sin = jrope.rope_tables(jnp.asarray(ids, jnp.float32), (16, 56, 56))
    ce, se = jrope.expand_rope_tables(cos, sin)
    return cos, sin, ce, se


def _seqmajor(rng, b, s, h):
    return [rng.standard_normal((b, s, h * D)).astype(np.float32) for _ in range(3)]


def _call_sm(q, k, v, dtype):
    args = [jnp.asarray(t, dtype) for t in (q, k, v)]
    return np.asarray(_flash_sm_call(*args, head_dim=D, scale=D ** -0.5, block_q=128,
                                     block_k=128, interpret=True), np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


@pytest.mark.parametrize("s", [256, 130])
def test_k6_plain_matches_interpreted_pallas(rng, s):
    q, k, v = _seqmajor(rng, 2, s, 2)
    o_j = _call_sm(q, k, v, jnp.float32)
    o_t = to_np(tflash.flash_sm_plain(_t(q), _t(k), _t(v), D, D ** -0.5))
    assert o_t.shape == (2, s, 2 * D)
    assert summed_rel(o_t, o_j) <= FLASH_BAND


def test_k6_plain_bf16_matches_interpreted_pallas(rng):
    q, k, v = _seqmajor(rng, 1, 200, 2)
    o_j = _call_sm(q, k, v, jnp.bfloat16)
    o_t = to_np(tflash.flash_sm_plain(*(_t(a, torch.bfloat16) for a in (q, k, v)), D,
                                      D ** -0.5))
    assert summed_rel(o_t, o_j) <= 4e-3


@pytest.mark.parametrize("s,dtype,band", [(256, "float32", FLASH_BAND),
                                          (130, "float32", FLASH_BAND),
                                          (200, "bfloat16", 4e-3)])
def test_k7_plain_matches_interpreted_pallas(rng, s, dtype, band):
    q, k, v = _seqmajor(rng, 1, s, 3)
    _, _, ce, se = _tables(rng, 1, s)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    o_j = np.asarray(_flash_rope_call(
        *(jnp.asarray(a, jd) for a in (q, k, v)), ce, se, ce, se, head_dim=D,
        scale=D ** -0.5, block_q=128, block_k=128, interpret=True), np.float32)
    ce_t, se_t = _t(ce), _t(se)
    o_t = to_np(tflash.flash_rope_plain(*(_t(a, td) for a in (q, k, v)), ce_t, se_t, ce_t,
                                        se_t, D, D ** -0.5))
    assert summed_rel(o_t, o_j) <= band


def test_k7_plain_is_k6_plain_on_rotated(rng):
    """K7's plain version is the plain half-split rotation followed by K6's
    plain version, bit for bit (what the kernel is held to on the card)."""
    q, k, v = (_t(a, torch.bfloat16) for a in _seqmajor(rng, 1, 150, 2))
    _, _, ce, se = _tables(rng, 1, 150)
    ce, se = _t(ce), _t(se)
    a = tflash.flash_rope_plain(q, k, v, ce, se, ce, se, D, D ** -0.5)
    qr = tflash.rope_halfsplit_seqmajor(q, ce, se, D)
    kr = tflash.rope_halfsplit_seqmajor(k, ce, se, D)
    assert torch.equal(a, tflash.flash_sm_plain(qr, kr, v, D, D ** -0.5))


@pytest.mark.parametrize("seq_axis", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_halfsplit_and_tables_exact(rng, seq_axis, dtype):
    """Same tables in, the same rotated values out, bit for bit; the
    expanded tables are equal too."""
    cos, sin, ce, se = _tables(rng, 2, 40)
    shape = (2, 3, 40, D) if seq_axis == 2 else (2, 40, 3, D)
    x = rng.standard_normal(shape).astype(np.float32)
    o_j = np.asarray(jrope.apply_rope_halfsplit(jnp.asarray(x, dtype), cos, sin,
                                                seq_axis=seq_axis), np.float32)
    o_t = to_np(trope.apply_rope_halfsplit(_t(x, getattr(torch, dtype)), _t(cos), _t(sin),
                                           seq_axis=seq_axis))
    np.testing.assert_array_equal(o_t, o_j)
    ce_t, se_t = trope.expand_rope_tables(_t(cos), _t(sin))
    np.testing.assert_array_equal(to_np(ce_t), np.asarray(ce))
    np.testing.assert_array_equal(to_np(se_t), np.asarray(se))


@pytest.mark.parametrize("rope_in_kernel", [False, True])
def test_flash_attention_fused_matches_jax(rng, rope_in_kernel):
    """The public entry point under both layouts, ragged S, f32."""
    q, k, v = _seqmajor(rng, 1, 130, 2)
    _, _, ce, se = _tables(rng, 1, 130)
    o_j = np.asarray(j_fused(*(jnp.asarray(a) for a in (q, k, v)), ce, se, head_dim=D,
                             interpret=True, rope_in_kernel=rope_in_kernel))
    o_t = to_np(tflash.flash_attention_fused(_t(q), _t(k), _t(v), _t(ce), _t(se), D,
                                             rope_in_kernel=rope_in_kernel))
    assert summed_rel(o_t, o_j) <= FLASH_BAND


def test_flash_attention_fused_layout_env_and_refusals(rng, monkeypatch):
    """DIFFUSION_RS_TPU_ATTN_LAYOUT=inkernel picks K7's route by default;
    head dims that are not multiples of 128 raise NotImplementedError, as
    in JAX (the caller then takes the [B, H, S, D] path)."""
    q, k, v = (_t(a) for a in _seqmajor(rng, 1, 64, 2))
    _, _, ce, se = _tables(rng, 1, 64)
    ce, se = _t(ce), _t(se)
    calls = []
    monkeypatch.setattr(tflash, "flash_rope_plain",
                        lambda *a: calls.append("k7") or torch.zeros_like(a[0]))
    monkeypatch.setattr(tflash, "flash_sm_plain",
                        lambda *a: calls.append("k6") or torch.zeros_like(a[0]))
    tflash.flash_attention_fused(q, k, v, ce, se, D)
    monkeypatch.setenv("DIFFUSION_RS_TPU_ATTN_LAYOUT", "inkernel")
    tflash.flash_attention_fused(q, k, v, ce, se, D)
    assert calls == ["k6", "k7"]
    with pytest.raises(NotImplementedError):
        tflash.flash_attention_fused(q, k, v, ce[..., :64], se[..., :64], 64)

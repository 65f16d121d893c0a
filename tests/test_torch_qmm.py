"""Parity of the port's quantized matmul (ops/qmatmul.py) and quantized
tensor (quant/qtensor.py) with the JAX package.

The JAX Pallas kernel runs in interpret mode; the port's CPU path is the
plain version of each CUDA kernel. Same math and order of K-tiles, so the
band is the near-exact 1e-5 summed-relative error of tests/test_ops.py:176.
The CUDA kernels are held against the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_rs_tpu.ops.linear import Linear as JLinear, linear as j_linear
from diffusion_rs_tpu.ops.qmatmul_pallas import quantized_matmul as j_qmm
from diffusion_rs_tpu.ops.qmatmul_pallas import supports as j_supports
from diffusion_rs_tpu.quant import bnb as jbnb
from diffusion_rs_tpu.quant import qtensor as jq
from diffusion_rs_tpu_torch.ops.linear import linear as t_linear
from diffusion_rs_tpu_torch.ops import qmatmul as tq
from diffusion_rs_tpu_torch.quant import qtensor as tqt
from torch_port_util import port_params, summed_rel, to_np

QMM_BAND = 1e-5  # same math, same K-tile order (tests/test_ops.py:176)


# bf16 outputs: XLA's CPU f32 division differs from the IEEE quotient in
# the last bit for a few elements (~6e-5 of them), so an activation code can
# round one step apart; that moves its row by ~1e-3 relative and the bf16
# output rounding turns it into one-ulp (2^-8) flips. The port's plain
# version and the CUDA kernel both divide exactly and agree bit for bit.
K1_BF16_BAND = 1e-3


@pytest.mark.parametrize("m", [1, 33])
@pytest.mark.parametrize("dtype,band", [("float32", QMM_BAND), ("bfloat16", K1_BF16_BAND)])
def test_k1_plain_matches_interpreted_pallas(rng, m, dtype, band):
    w = (rng.standard_normal((512, 256)) * 0.05).astype(np.float32)
    x = rng.standard_normal((m, 512)).astype(np.float32)
    jqt = jq.quantize_q8_tile(w)
    y_j = np.asarray(j_qmm(jnp.asarray(x, dtype), jqt, interpret=True), np.float32)
    t_qt = tqt.quantize_q8_tile(w)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    assert tq.q8t_ok(t_qt) and tq.supports(t_qt)
    y_t = to_np(tq.quantized_matmul(xt, t_qt))
    assert summed_rel(y_t, y_j) <= band


def test_quantize_q8_tile_planes_match_jax(rng):
    w = (rng.standard_normal((768, 128)) * 0.1).astype(np.float32)
    j, t = jq.quantize_q8_tile(w), tqt.quantize_q8_tile(w)
    np.testing.assert_array_equal(t.packed.numpy(), np.asarray(j.packed))
    np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))
    assert (t.kind, t.bits, t.group, t.split, t.shape) == (
        j.kind, j.bits, j.group, j.split, tuple(j.shape))


@pytest.mark.parametrize("m", [1, 33])
def test_k2_plain_matches_interpreted_pallas(rng, m):
    w = (rng.standard_normal((512, 256)) * 0.05).astype(np.float32)
    jqt = jbnb.quantize_nf4(np.ascontiguousarray(w.T), blocksize=64)
    x = rng.standard_normal((m, 512)).astype(np.float32)
    y_j = np.asarray(j_qmm(jnp.asarray(x), jqt, interpret=True))
    t_qt = port_params(jqt)
    assert t_qt.codebook is not None and tq.supports(t_qt)
    y_t = to_np(tq.quantized_matmul(torch.from_numpy(x), t_qt))
    assert summed_rel(y_t, y_j) <= QMM_BAND


def test_k2_bf16_matches_interpreted_pallas(rng):
    """bf16 activations: the weight is decoded in f32 and rounded to bf16
    before the dot in both packages."""
    w = (rng.standard_normal((512, 256)) * 0.05).astype(np.float32)
    jqt = jbnb.quantize_nf4(np.ascontiguousarray(w.T), blocksize=64)
    x = rng.standard_normal((33, 512)).astype(np.float32)
    y_j = np.asarray(j_qmm(jnp.asarray(x, jnp.bfloat16), jqt, interpret=True), np.float32)
    y_t = to_np(tq.quantized_matmul(torch.from_numpy(x).bfloat16(), port_params(jqt)))
    # one bf16 output rounding apart at most, from f32 accumulation order
    assert summed_rel(y_t, y_j) <= 2e-3


@pytest.mark.parametrize("k", [512, 640, 64])
def test_pack_unpack_and_dequantize_match_jax(rng, k):
    split = tqt.choose_split(k)
    assert split == jq.choose_split(k)
    q = rng.integers(0, 16, size=(k, 128), dtype=np.uint8)
    packed = tqt.pack4(q, split)
    np.testing.assert_array_equal(packed, jq.pack4(q, split))
    np.testing.assert_array_equal(tqt.unpack4(torch.from_numpy(packed), split).numpy(), q)
    jqt = jbnb.quantize_nf4(rng.standard_normal((128, k)).astype(np.float32), blocksize=64)
    np.testing.assert_array_equal(
        tqt.dequantize(port_params(jqt), torch.float32).numpy(),
        np.asarray(jq.dequantize(jqt, jnp.float32)))


def test_dequantize_stacked_codebook(rng):
    """Stacked [L, ...] planes with a stacked [L, 16] codebook dequantize
    layer by layer."""
    qts = [jbnb.quantize_nf4(rng.standard_normal((128, 256)).astype(np.float32))
           for _ in range(2)]
    t_qts = [port_params(q) for q in qts]
    stacked = tqt.QuantizedTensor(
        packed=torch.stack([q.packed for q in t_qts]),
        scale=torch.stack([q.scale for q in t_qts]), bias=None,
        codebook=torch.stack([q.codebook for q in t_qts]), kind="nf4", bits=4,
        group=t_qts[0].group, split=t_qts[0].split, shape=t_qts[0].shape,
        out_dtype="float32")
    full = tqt.dequantize(stacked, torch.float32)
    for i, q in enumerate(qts):
        np.testing.assert_array_equal(full[i].numpy(), np.asarray(jq.dequantize(q, jnp.float32)))


def test_supports_mirrors_jax(rng):
    """Same kernel/fallback decision: FLUX final.proj (N=64) falls back."""
    for k, n in ((3072, 64), (3072, 3072), (64, 3072), (768, 256), (512, 8)):
        w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
        for jqt in (jq.quantize_q8_tile(w), jq.quantize_q4_0(w)):
            t = port_params(jqt)
            assert tq.supports(t) == j_supports(jqt), (k, n, jqt.kind)


def test_linear_fallback_n64_and_bias_matches_jax(rng, monkeypatch):
    """N=64 takes dequantize + matmul in both packages; the bias is added in
    the activation dtype after the product's cast."""
    jlin = importlib.import_module("diffusion_rs_tpu.ops.linear")

    monkeypatch.setenv("DIFFUSION_RS_TPU_QMM", "interpret")
    jlin._qmm_mode.cache_clear()
    try:
        w = (rng.standard_normal((512, 64)) * 0.05).astype(np.float32)
        b = rng.standard_normal(64).astype(np.float32)
        jlin_ = JLinear(w=jq.quantize_q8_tile(w), b=jnp.asarray(b, jnp.bfloat16))
        x = rng.standard_normal((2, 5, 512)).astype(np.float32)
        y_j = np.asarray(j_linear(jnp.asarray(x, jnp.bfloat16), jlin_), np.float32)
    finally:
        jlin._qmm_mode.cache_clear()
    y_t = to_np(t_linear(torch.from_numpy(x).bfloat16(), port_params(jlin_)))
    assert y_t.shape == (2, 5, 64)
    assert summed_rel(y_t, y_j) <= 2e-3


def test_linear_dense_and_lora_match_jax(rng):
    w = rng.standard_normal((48, 32)).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    a = rng.standard_normal((48, 4)).astype(np.float32)
    bl = rng.standard_normal((4, 32)).astype(np.float32)
    jlin_ = JLinear(w=jnp.asarray(w), b=jnp.asarray(b), lora=(jnp.asarray(a), jnp.asarray(bl)))
    x = rng.standard_normal((3, 48)).astype(np.float32)
    y_j = np.asarray(j_linear(jnp.asarray(x), jlin_))
    y_t = to_np(t_linear(torch.from_numpy(x), port_params(jlin_)))
    np.testing.assert_allclose(y_t, y_j, rtol=1e-5, atol=1e-4)


def test_affine_format_plain_version_matches_jax(rng):
    """Affine formats (q4_0) take K4 (csrc/qmm_affine.cu); on the CPU they
    run its plain dequantizing version (tests/test_torch_gguf.py holds every
    format; tests/test_torch_guard.py checks that a non-CPU tensor never
    takes the plain version)."""
    w = (rng.standard_normal((512, 256)) * 0.05).astype(np.float32)
    jqt = jq.quantize_q4_0(w)
    x = rng.standard_normal((4, 512)).astype(np.float32)
    y_t = to_np(tq.quantized_matmul(torch.from_numpy(x), port_params(jqt)))
    y_j = np.asarray(j_qmm(jnp.asarray(x), jqt, interpret=True))
    assert summed_rel(y_t, y_j) <= QMM_BAND

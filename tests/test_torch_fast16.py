"""The fast16 decode (DIFFUSION_RS_TPU_QMM_FAST16) of the port's K12 / K13
plain version against the JAX package's ``quantized_matmul`` in interpret
mode with the knob set.

The plain version rounds to bf16 after every op in ``_dequant_tile``'s
order, so its decoded weight equals the one JAX's kernel multiplies with
(read out through the identity: ``I @ W`` is W exactly): bit for bit. The
products differ only by f32 summation order: summed-rel <= 1e-5. Both sit
above 1e-4 from the f32 decode (measured 2.1e-3 to 4.7e-3), so the band
also shows the mode is on.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_rs_tpu.ops.qmatmul_pallas import quantized_matmul as j_qmm
from diffusion_rs_tpu.ops.qmatmul_pallas import quantized_matmul_grouped as j_grouped
from diffusion_rs_tpu.quant import isq as jisq
from diffusion_rs_tpu.quant.bnb import bnb_int8_to_canonical
from diffusion_rs_tpu_torch.ops import _cuda
from diffusion_rs_tpu_torch.ops import qmatmul as tq
from torch_port_util import port_params, summed_rel

FAST16_BAND = 1e-5     # f32 summation order of the same bf16 products
FAST16_OFF_GAP = 1e-4  # the f32 decode is at least this far
KINDS = ["q4_0", "q8_0", "q4_k_zero_scales", "q6_k", "q2_k", "nf4", "fp4", "int8"]
K, N = 512, 256


def _qtensor(kind: str):
    """A JAX canonical tensor of ``kind`` [K, N]; the Q4_K one holds groups
    whose f16 d underflowed (s == 0) while their bias did not."""
    rng = np.random.default_rng(len(kind))
    if kind == "int8":
        return bnb_int8_to_canonical(rng.integers(-127, 128, (N, K), dtype=np.int8),
                                     rng.uniform(0.5, 2, N).astype(np.float32))
    w = (rng.standard_normal((K, N)) * 0.03).astype(np.float32)
    if kind == "q4_k_zero_scales":
        w[:256, :8] = rng.uniform(-4e-6, -2e-6, size=(256, 8)).astype(np.float32)
        qt = jisq.isq_quantize_weight(w, "q4_k")
        zero = np.asarray(qt.scale) == 0
        assert zero.any() and (np.asarray(qt.bias)[zero] != 0).any()
        return qt
    return jisq.isq_quantize_weight(w, kind)


def _x(m: int, seed: int = 0):
    x = np.random.default_rng(seed).standard_normal((m, K)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    return xj, torch.from_numpy(np.array(xj.astype(jnp.float32))).bfloat16()


def _j(x, qt) -> np.ndarray:
    return np.asarray(j_qmm(x, qt, interpret=True).astype(jnp.float32))


@pytest.mark.parametrize("kind", KINDS)
def test_fast16_decode_equals_jax_kernel_bit_for_bit(kind, monkeypatch):
    """The plain fast16 decode equals the weight JAX's interpreted kernel
    decodes with DIFFUSION_RS_TPU_QMM_FAST16=1, bit for bit."""
    monkeypatch.setenv("DIFFUSION_RS_TPU_QMM_FAST16", "1")
    jqt = _qtensor(kind)
    eye = jnp.eye(K, dtype=jnp.bfloat16)
    w_jax = np.asarray(j_qmm(eye, jqt, interpret=True).astype(jnp.float32))
    w_port = tq.dequantize_fast16(port_params(jqt, "cpu"), torch.bfloat16)
    np.testing.assert_array_equal(w_port.float().numpy(), w_jax)


@pytest.mark.parametrize("kind", KINDS)
def test_fast16_plain_matches_jax(kind, monkeypatch):
    """``quantized_matmul`` with the knob set: within FAST16_BAND of JAX's
    interpreted fast16 product and beyond FAST16_OFF_GAP of the f32 decode,
    in both packages; unset, the two f32 decodes agree as before."""
    jqt = _qtensor(kind)
    tqt = port_params(jqt, "cpu")
    xj, xt = _x(64)
    monkeypatch.setenv("DIFFUSION_RS_TPU_QMM_FAST16", "1")
    y16_j = _j(xj, jqt)
    y16_t = tq.quantized_matmul(xt, tqt).float().numpy()
    monkeypatch.delenv("DIFFUSION_RS_TPU_QMM_FAST16")
    y32_j = _j(xj, jqt)
    y32_t = tq.quantized_matmul(xt, tqt).float().numpy()
    assert summed_rel(y16_t, y16_j) <= FAST16_BAND
    assert summed_rel(y32_t, y32_j) <= FAST16_BAND
    assert summed_rel(y16_j, y32_j) > FAST16_OFF_GAP
    assert summed_rel(y16_t, y32_t) > FAST16_OFF_GAP


@pytest.mark.parametrize("kind", ["q4_0", "nf4"])
def test_grouped_calls_ignore_fast16(kind, monkeypatch):
    """JAX passes fast16=False to every grouped call (K8 / K11 keep the f32
    decode): the grouped products are the same with the knob set or unset,
    in both packages, and agree with each other."""
    w2 = (np.random.default_rng(6).standard_normal((K, N)) * 0.03).astype(np.float32)
    qts = [_qtensor(kind), jisq.isq_quantize_weight(w2, kind)]
    tqts = [port_params(q, "cpu") for q in qts]
    (xa, ta), (xb, tb) = _x(32, 1), _x(5, 2)
    out = {}
    for on in (True, False):
        if on:
            monkeypatch.setenv("DIFFUSION_RS_TPU_QMM_FAST16", "1")
        else:
            monkeypatch.delenv("DIFFUSION_RS_TPU_QMM_FAST16")
        out[on] = ([np.asarray(y.astype(jnp.float32))
                    for y in j_grouped([xa, xb], qts, interpret=True)],
                   [y.float().numpy() for y in tq.quantized_matmul_grouped([ta, tb], tqts)])
    for i in range(2):
        np.testing.assert_array_equal(out[True][0][i], out[False][0][i])
        np.testing.assert_array_equal(out[True][1][i], out[False][1][i])
        assert summed_rel(out[True][1][i], out[True][0][i]) <= FAST16_BAND


@pytest.mark.parametrize("value", ["", "1", "0", "yes"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_fast16_switch_like_jax(value, dtype, monkeypatch):
    """On exactly when the variable is non-empty (even "0", as JAX's
    ``bool(os.environ.get(...))``) and the activations are 2-byte."""
    monkeypatch.setenv("DIFFUSION_RS_TPU_QMM_FAST16", value)
    jax_on = jnp.dtype(dtype).itemsize == 2 and bool(value)
    assert tq.fast16_enabled(torch.zeros(2, dtype=getattr(torch, dtype))) == jax_on


def test_fast16_leaves_q8t_and_fallback_alone(monkeypatch):
    """q8t keeps the s8 path (K1) and shapes the kernels do not tile keep
    dequantize + matmul, with the knob set or not; nothing launches on the
    CPU."""
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((K, N)) * 0.03).astype(np.float32)
    _, xt = _x(8)
    cases = [port_params(jisq.isq_quantize_weight(w, "q8t"), "cpu"),
             port_params(jisq.isq_quantize_weight(w[:, :64], "q4_0"), "cpu")]
    _cuda.reset_launch_counts()
    for qt in cases:
        monkeypatch.setenv("DIFFUSION_RS_TPU_QMM_FAST16", "1")
        on = tq.quantized_matmul(xt, qt)
        monkeypatch.delenv("DIFFUSION_RS_TPU_QMM_FAST16")
        assert torch.equal(on, tq.quantized_matmul(xt, qt))
    assert _cuda.launch_counts() == dict.fromkeys(_cuda.KERNELS, 0)


def test_fast16_wrappers_have_no_fallback():
    """K12 / K13 given tensors off the CPU launch or raise (here: 'meta')."""
    qt = port_params(_qtensor("q4_0"), "cpu").map(lambda t: t.to("meta"))
    x = torch.zeros((4, K), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tq.qmm_affine_fast16(x, qt, torch.bfloat16)
    nf4 = port_params(_qtensor("nf4"), "cpu").map(lambda t: t.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        tq.qmm_nf4_fast16(x, nf4, torch.bfloat16)

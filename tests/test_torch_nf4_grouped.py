"""Parity of the port's grouped 4-bit codebook matmul (K11's dispatch) with
the JAX package.

nf4 groups of one [K, N] format run the codebook branch of
``quantized_matmul_grouped``: in JAX the Pallas ``_qmm_grouped_kernel``
(interpret mode), in the port K11 on the card and its plain version, the
per-group K2 plain version, on the CPU. The grouped call equals the
per-group calls bit for bit in both packages (tests/test_ops.py:274-317),
and the two packages agree at the bands of tests/test_torch_qmm.py. A tiny
nf4 FLUX forward with grouped img/txt projections runs through both. The
card holds K11 against per-group K2 launches in tests/test_torch_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_rs_tpu.models import flux as jflux
from diffusion_rs_tpu.models import optimize as jopt
from diffusion_rs_tpu.ops.qmatmul_pallas import quantized_matmul as j_qmm
from diffusion_rs_tpu.ops.qmatmul_pallas import quantized_matmul_grouped as j_grouped
from diffusion_rs_tpu.quant import bnb as jbnb
from diffusion_rs_tpu_torch.models import optimize as topt
from diffusion_rs_tpu_torch.ops import _cuda
from diffusion_rs_tpu_torch.ops import qmatmul as tq
from test_torch_loader import assert_trees_equal
from test_torch_models import JFLUX_TINY, TFLUX_TINY, _flux_inputs
from test_torch_optimize import _forward
from test_torch_qmm import QMM_BAND
from torch_port_util import (  # noqa: F401
    jax_kernels_interpreted, port_params, quantize_tree, summed_rel, to_np)


def _nf4(w):
    """[K, N] weight -> nf4 QuantizedTensor (bnb takes [out, in])."""
    return jbnb.quantize_nf4(np.ascontiguousarray(w.T), blocksize=64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ms", [(48, 272), (40, 9, 1, 130)])
def test_k11_plain_matches_interpreted_pallas(rng, dtype, ms):
    """The grouped codebook call against JAX's grouped call (QMM_BAND in
    f32, one bf16 output rounding, 2e-3, in bf16), and bit for bit against
    the port's per-group calls, as JAX's own grouped call is against its
    per-group calls (in bf16; JAX's f32 tiles differ between the two);
    ragged row counts against every tile."""
    k, n = 512, 256
    jqts = [_nf4((rng.standard_normal((k, n)) * 0.05).astype(np.float32)) for _ in ms]
    xs = [rng.standard_normal((1, m, k)).astype(np.float32) for m in ms]
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ys_j = j_grouped([jnp.asarray(x, jd) for x in xs], jqts, interpret=True)
    if dtype == "bfloat16":  # JAX's own contract, which it tests in bf16
        for y, x, q in zip(ys_j, xs, jqts):
            np.testing.assert_array_equal(np.asarray(y, np.float32), np.asarray(
                j_qmm(jnp.asarray(x, jd), q, interpret=True), np.float32))
    tqts = [port_params(q) for q in jqts]
    assert tq.grouped_plan(tqts) == "codebook"
    xts = [torch.from_numpy(x).to(td) for x in xs]
    ys_t = tq.quantized_matmul_grouped(xts, tqts)
    band = QMM_BAND if dtype == "float32" else 2e-3
    for y_t, y_j, x, q, m in zip(ys_t, ys_j, xts, tqts, ms):
        assert tuple(y_t.shape) == (1, m, n) and y_t.dtype == td
        assert summed_rel(to_np(y_t), np.asarray(y_j, np.float32)) <= band
        assert torch.equal(y_t, tq.quantized_matmul(x, q))
    x2s = [x.reshape(-1, k) for x in xts]
    for y, y1 in zip(tq.qmm_grouped_nf4(x2s, tqts, td), ys_t):
        assert torch.equal(y, y1.reshape(-1, n))
    assert _cuda.launch_counts() == dict.fromkeys(_cuda.KERNELS, 0)  # plain on the CPU


def test_k11_wrapper_checks():
    """Off the CPU, K11's wrapper takes 1..8 groups of one codebook format
    and checks each group as K2 does; it never runs the plain version."""
    qt = tq.QuantizedTensor(packed=torch.zeros((128, 128), dtype=torch.uint8),
                            scale=torch.ones((4, 128)), bias=None,
                            codebook=torch.zeros(16), kind="nf4", bits=4, group=64,
                            split=256, shape=(256, 128), out_dtype="bfloat16")
    meta = qt.map(lambda t: t.to("meta"))
    x = torch.zeros((4, 256), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="1..8 groups"):
        tq.qmm_grouped_nf4([x] * 9, [meta] * 9, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tq.qmm_grouped_nf4([x, x], [meta, meta], torch.bfloat16)
    with pytest.raises(ValueError, match="bf16"):
        tq.qmm_grouped_nf4([x.float(), x.float()], [meta, meta], torch.float32)


@pytest.fixture(scope="module")
def nf4_flux():
    """The tiny FLUX tree with every linear nf4 (biases small random)."""
    jp = jflux.init_flux_params(jax.random.PRNGKey(0), JFLUX_TINY)
    return quantize_tree(jp, _nf4, jnp.float32)


@pytest.mark.parametrize("attn_layout", ["bhsd", "seqmajor"])
def test_nf4_grouped_forward_f32_matches_jax(rng, jax_kernels_interpreted, monkeypatch,
                                             nf4_flux, attn_layout):
    """nf4 FLUX with ``fuse="grouped"`` (img/txt q|k|v fused, every img/txt
    projection pair one grouped call): the port's transform gives JAX's tree
    bit for bit, and the f32 forward agrees within the near-exact band of
    tests/test_torch_models.py (1e-5), with the default attention and with
    the seq-major layout after the half-split re-layout."""
    monkeypatch.setenv("DIFFUSION_RS_TPU_ATTN_LAYOUT", attn_layout)
    rope = attn_layout == "seqmajor"
    jp = jopt.fuse_flux_qkv(nf4_flux, ("img", "txt"))
    tp = topt.fuse_flux_qkv(port_params(nf4_flux), ("img", "txt"))
    if rope:
        jp = jopt.rope_halfsplit_permute(jp, JFLUX_TINY)
        tp = topt.rope_halfsplit_permute(tp, TFLUX_TINY)
    assert_trees_equal(tp, port_params(jp))
    over = dict(grouped_qmm=True, rope_fused=rope)
    out_j, out_t = _forward(jp, dataclasses.replace(JFLUX_TINY, **over),
                            dataclasses.replace(TFLUX_TINY, **over), "float32",
                            _flux_inputs(rng))
    assert summed_rel(out_t, out_j) <= 1e-5

"""Parity of the port's grouped quantized matmul (K8's dispatch) with the
JAX package's ``quantized_matmul_grouped`` (Pallas in interpret mode).

Groups of one format at the double blocks' two row counts (an img-like and
a txt-like M): q8t takes the s8 branch, GGUF q8_0 and q4_0 the affine one.
K8's plain version is the per-group plain K1 / K4, bit for bit, and is held
against the JAX grouped call at the bands of tests/test_torch_qmm.py.
Groups that differ in format run per group in both packages; the 4-bit
codebook branch (K11) has its own file, tests/test_torch_nf4_grouped.py.
"""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_rs_tpu.ops.qmatmul_pallas import quantized_matmul_grouped as j_grouped
from diffusion_rs_tpu.quant import bnb as jbnb
from diffusion_rs_tpu.quant import qtensor as jq
from diffusion_rs_tpu_torch.ops import _cuda
from diffusion_rs_tpu_torch.ops import qmatmul as tq
from diffusion_rs_tpu_torch.ops.linear import Linear
from diffusion_rs_tpu_torch.quant.qtensor import QuantizedTensor
from test_torch_qmm import K1_BF16_BAND, QMM_BAND
from torch_port_util import port_params, summed_rel, to_np

QUANTIZERS = {"q8t": jq.quantize_q8_tile, "q8_0": jq.quantize_q8_0, "q4_0": jq.quantize_q4_0}
tlinear = importlib.import_module("diffusion_rs_tpu_torch.ops.linear")
MS = (40, 9)  # img-like and txt-like rows, ragged against every tile


def _groups(rng, kind, k=512, n=256, ms=MS):
    ws = [(rng.standard_normal((k, n)) * 0.05).astype(np.float32) for _ in ms]
    xs = [rng.standard_normal((1, m, k)).astype(np.float32) for m in ms]
    return xs, [QUANTIZERS[kind](w) for w in ws]


@pytest.mark.parametrize("kind,plan", [("q8t", "s8"), ("q8_0", "affine"), ("q4_0", "affine")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k8_plain_matches_interpreted_pallas(rng, kind, plan, dtype):
    xs, jqts = _groups(rng, kind)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ys_j = j_grouped([jnp.asarray(x, jd) for x in xs], jqts, interpret=True)
    tqts = [port_params(q) for q in jqts]
    assert tq.grouped_plan(tqts) == plan
    xts = [torch.from_numpy(x).to(td) for x in xs]
    ys_t = tq.quantized_matmul_grouped(xts, tqts)
    band = QMM_BAND if dtype == "float32" or plan == "affine" else K1_BF16_BAND
    if dtype == "bfloat16" and plan == "affine":
        band = 2e-3  # one bf16 output rounding apart at most (test_torch_qmm.py)
    for y_t, y_j, m in zip(ys_t, ys_j, MS):
        assert tuple(y_t.shape) == (1, m, 256) and y_t.dtype == td
        assert summed_rel(to_np(y_t), np.asarray(y_j, np.float32)) <= band
    # the plain grouped call is the per-group plain call, bit for bit
    x2s = [x.reshape(-1, 512) for x in xts]
    for y, y1 in zip(tq.qmm_grouped_plain(x2s, tqts, td),
                     [tq.quantized_matmul(x, q) for x, q in zip(x2s, tqts)]):
        assert torch.equal(y, y1)
    assert _cuda.launch_counts()["qmm_grouped_s8"] == 0  # plain versions on the CPU


@pytest.mark.parametrize("case", ["format", "shape", "bias", "unsupported"])
def test_mismatched_groups_run_per_group(rng, case):
    """The JAX ``same`` test and ``supports``: mixed formats, shapes or bias
    presence, or a format the kernels do not tile (N=64), take per-group
    quantized_matmul; the results equal the per-group calls, and match
    JAX's per-group fallback."""
    xs, jqts = _groups(rng, "q8_0")
    if case == "format":
        jqts[1] = jq.quantize_q4_0(np.asarray(jq.dequantize(jqts[1], jnp.float32)))
    elif case == "shape":
        w = (rng.standard_normal((512, 384)) * 0.05).astype(np.float32)
        jqts[1] = jq.quantize_q8_0(w)
    elif case == "bias":
        jqts[1] = dataclasses.replace(jqts[1], bias=jnp.zeros_like(jqts[1].scale))
    else:
        xs, jqts = _groups(rng, "q8_0", n=64)
    tqts = [port_params(q) for q in jqts]
    assert tq.grouped_plan(tqts) is None
    xts = [torch.from_numpy(x) for x in xs]
    ys = tq.quantized_matmul_grouped(xts, tqts)
    for y, x, q in zip(ys, xts, tqts):
        assert torch.equal(y, tq.quantized_matmul(x, q))
    for y, y_j in zip(ys, j_grouped([jnp.asarray(x) for x in xs], jqts, interpret=True)):
        assert summed_rel(to_np(y), np.asarray(y_j)) <= QMM_BAND


def test_grouped_codebook_plain_on_cpu_raises_elsewhere(rng):
    """nf4 groups: per-group plain versions on the CPU (equal to the JAX
    grouped call); off the CPU the call reaches K11's wrapper, which
    launches or raises, and never runs per group (checked on the 'meta'
    device, which is not the CPU)."""
    ws = [(rng.standard_normal((256, 512)) * 0.05).astype(np.float32) for _ in MS]
    jqts = [jbnb.quantize_nf4(w) for w in ws]  # [out, in] -> [K=512, N=256]
    xs = [rng.standard_normal((m, 512)).astype(np.float32) for m in MS]
    tqts = [port_params(q) for q in jqts]
    assert tq.grouped_plan(tqts) == "codebook"
    ys = tq.quantized_matmul_grouped([torch.from_numpy(x) for x in xs], tqts)
    for y, y_j in zip(ys, j_grouped([jnp.asarray(x) for x in xs], jqts, interpret=True)):
        assert summed_rel(to_np(y), np.asarray(y_j)) <= QMM_BAND
    meta = [q.map(lambda t: t.to("meta")) for q in tqts]
    xm = [torch.zeros((m, 512), dtype=torch.bfloat16, device="meta") for m in MS]
    with pytest.raises(ValueError, match="CUDA"):
        tq.quantized_matmul_grouped(xm, meta)
    with pytest.raises(ValueError, match="CUDA"):
        tq.qmm_grouped_nf4(xm, meta, torch.bfloat16)


def test_grouped_wrappers_have_no_fallback():
    """Given tensors that are not on the CPU, K8's wrappers launch or raise;
    they never run the plain version."""
    for kind, bits, packed in (("q8t", 8, torch.zeros((256, 128), dtype=torch.int8)),
                               ("q4_0", 4, torch.zeros((128, 128), dtype=torch.uint8))):
        qt = QuantizedTensor(packed=packed, scale=torch.ones((256 // 32, 128)),
                             bias=torch.zeros((256 // 32, 128)) if bits == 4 else None,
                             codebook=None, kind=kind, bits=bits,
                             group=256 if kind == "q8t" else 32, split=256,
                             shape=(256, 128), out_dtype="bfloat16")
        if kind == "q8t":
            qt = dataclasses.replace(qt, scale=torch.ones((1, 128)))
        x = torch.zeros((4, 256), dtype=torch.bfloat16, device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            tq.quantized_matmul_grouped([x, x], [qt, qt])


def test_linear_grouped_adds_bias_and_falls_back(rng):
    """Biases are added after the grouped product; dense weights and LoRA
    terms run per-group linear."""
    xs, jqts = _groups(rng, "q4_0")
    tqts = [port_params(q) for q in jqts]
    bs = [torch.from_numpy(rng.standard_normal(256).astype(np.float32)) for _ in MS]
    lins = [Linear(w=q, b=b) for q, b in zip(tqts, bs)]
    xts = [torch.from_numpy(x) for x in xs]
    for y, x, lin in zip(tlinear.linear_grouped(xts, lins), xts, lins):
        assert torch.equal(y, tlinear.linear(x, lin))
    dense = [Linear(w=torch.from_numpy(rng.standard_normal((512, 256)).astype(np.float32)),
                    b=b) for b in bs]
    lora = [dataclasses.replace(lins[0], lora=(torch.ones((512, 2)), torch.ones((2, 256)))),
            lins[1]]
    for group in (dense, lora):
        for y, x, lin in zip(tlinear.linear_grouped(xts, group), xts, group):
            assert torch.equal(y, tlinear.linear(x, lin))

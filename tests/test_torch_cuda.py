"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips without a CUDA device. This file imports
only torch and the port (the GPU host has no JAX), so run it there without
the repo's conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Shapes cover what chip_smoke.py does not: ragged M, K-tiles of 64, split
128, ragged and unequal q/kv lengths, batch 2, every affine (GGUF, bnb int8)
format through K4, seq-major operands that are column slices of wider rows
(K6, K7), grouped calls of 2 to 8 groups with ragged and empty groups
(K8, K11), the int8 attention modes (K9, K10, both) and their prepass
kernel over one or several quantization blocks with a ragged last block,
and the fast16 decodes (K12
for nf4 / fp4, K13 for every affine format and Q4_K with s == 0 groups:
decoded weights bit for bit through the identity) with their dispatch,
K14's four entries (the output and per-row log-sum-exp of K3 and of the
int8 modes), a two-rank ring on one card over gloo, and K1, K2 and K4
launched on two cards from one process (needs two). The Hopper bodies
(TMA + wgmma) of the bf16 flash kernels and of the affine kernels are also
held at FLUX's lengths (S4608, the ragged S4112, below one tile), with K7's
rotation pass ``rope_qk`` bit for bit, the default layout's attention
prologue ``qk_norm_rope`` against its plain route (``-k qk_norm_rope``),
the affine decoded weights bit for bit for every format under K4 and K13,
the M1 modulation shapes, and K8's
groups against K4 on both sides of the small-M plan. Offloading on the card:
HostOffload's pinned host copy and its ``resident`` / ``release``, and a
streamed tiny q8t FLUX through a two-slot ring against the resident steps,
bit for bit (``-k "offload or streamed"``). Serving: a tiny FluxServer on
the card (lanes against their offline images, launches per forward), and
two threads' first launches racing in a fresh process with an empty build
directory (``-k "server or race"``). Tensor parallelism: the f32-output
entries of K1, K2, K12, K4 and K13 against their plain versions at the
K-slices of FLUX's proj and linear2 (K1 bit for bit), and the grouped
kernels' refusal of f32 (``-k f32``). The grad guard: K1 and K3 refuse an
input that requires grad under grad mode (``-k grad_guard``).

    python -m pytest --noconftest tests/test_torch_cuda.py -q -k "k3 or k4 or k6 or k7 or k8 or k13 or k14 or bf16_flash or rope or affine or dispatch"
"""

import dataclasses

import numpy as np
import pytest
import torch

from diffusion_rs_tpu_torch.ops import _cuda, flash, qmatmul
from diffusion_rs_tpu_torch.quant.bnb import bnb_int8_to_canonical
from diffusion_rs_tpu_torch.quant.gguf_quants import (
    ENCODERS, GGML_FORMATS, gguf_to_canonical)
from diffusion_rs_tpu_torch.ops.rope import expand_rope_tables, rope_tables
from diffusion_rs_tpu_torch.quant.qtensor import dequantize
from diffusion_rs_tpu_torch.util.synthetic import random_qtensor
from torch_mesh_workers import RING_MODES

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _summed_rel(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).abs().sum() / (b.abs().sum() + 1e-9))


def _within_summation_order(y, ref, x, qt) -> bool:
    """Every element within what two f32 summation orders of the same
    products can give after the bf16 cast: one bf16 ulp (at most
    max(|y|, |ref|) * 2^-7) plus 2 * K * 2^-24 * sum_k |x_k * w_k|. The
    second term matters where the sum cancels to a small |y|."""
    y, ref = y.float(), ref.float()
    mag = x.float().abs() @ dequantize(qt, torch.float32).abs()
    tol = torch.maximum(y.abs(), ref.abs()) * 2.0 ** -7 + mag * (2 * qt.k * 2.0 ** -24)
    return bool(((y - ref).abs() <= tol).all())


@pytest.mark.parametrize("m,k,n", [(1, 768, 384), (200, 768, 384), (513, 64, 256),
                                   (33, 3072, 128), (4, 320, 256)]
                         + [(m, 64, n) for m in (1, 8, 9, 65, 257) for n in (128, 384)])
def test_k1_matches_plain(dev, m, k, n):
    """Bit for bit: same IEEE quotient, same integer dot (exact in s32 and in
    the plain version's float64), same f32 fold order, so torch.equal. The
    kernel's edges: M of one row, below and across 64 and the 128-row tile
    (1, 8, 9, 65, 257), K = 64 (img_in: one 64-wide K-tile, one 64-k ring
    stage), N of one and of three 128-column tiles, and K-tiles of 64 over
    K = 320 (five K-tiles of one stage each)."""
    gen = torch.Generator(device=dev).manual_seed(m)
    qt = random_qtensor(gen, k, n, kind="q8t", device=dev)
    qt.scale.uniform_(0.5e-3, 2e-3, generator=gen)
    x = torch.randn((m, k), generator=gen, device=dev).bfloat16()
    before = _cuda.launch_counts()["qmm_s8"]
    y = qmatmul.qmm_s8(x, qt, torch.bfloat16)
    assert _cuda.launch_counts()["qmm_s8"] == before + 1
    ref = qmatmul.qmm_s8_plain(x, qt.packed, qt.scale, torch.bfloat16)
    assert torch.equal(y, ref)


@pytest.mark.parametrize("m,k,n", [(1, 1024, 384), (130, 1024, 384), (64, 640, 128)])
def test_k2_matches_plain(dev, m, k, n):
    """f32 accumulation order differs; bf16 outputs: band 2e-3."""
    gen = torch.Generator(device=dev).manual_seed(m)
    qt = random_qtensor(gen, k, n, kind="nf4", device=dev)
    qt.scale.uniform_(0.01, 0.03, generator=gen)
    x = torch.randn((m, k), generator=gen, device=dev).bfloat16()
    y = qmatmul.qmm_nf4(x, qt, torch.bfloat16)
    ref = qmatmul.qmm_dequant_plain(x, qt, torch.bfloat16)
    assert _summed_rel(y, ref) <= 2e-3


@pytest.mark.parametrize("kind", ["nf4", "fp4"])
@pytest.mark.parametrize("k,split", [(192, 64), (384, 128), (512, 256)])
@pytest.mark.parametrize("group", [32, 64])
def test_k2_decodes_dequantize_exactly(dev, kind, k, split, group):
    """K2's decoded weight, the product with the identity, equals
    ``dequantize(qt, f32).to(bf16)`` bit for bit (each output is one weight
    times 1 plus zeros): the f32 codebook entry times the f32 group scale,
    rounded once. Splits 64 (K=192: a last ring stage of 32 packed rows),
    128 and 256; scale groups of 32 and 64."""
    from diffusion_rs_tpu_torch.quant.bnb import CODEBOOKS

    gen = torch.Generator(device=dev).manual_seed(k + group)
    qt = random_qtensor(gen, k, 256, kind="nf4", group=group, device=dev)
    assert qt.split == split
    qt.scale.uniform_(0.01, 0.03, generator=gen)
    if kind == "fp4":
        qt = dataclasses.replace(qt, kind="fp4", codebook=torch.as_tensor(
            CODEBOOKS["fp4"], device=dev))
    eye = torch.eye(k, device=dev, dtype=torch.bfloat16)
    before = _cuda.launch_counts()["qmm_nf4"]
    w = qmatmul.qmm_nf4(eye, qt, torch.bfloat16)
    assert _cuda.launch_counts()["qmm_nf4"] == before + 1
    assert torch.equal(w, dequantize(qt, torch.float32).to(torch.bfloat16))


@pytest.mark.parametrize("fast16", [False, True])
def test_k2_rows_do_not_depend_on_block_rows(dev, fast16):
    """The plan runs M4608 N12288 in 256-row tiles and M512 of the same
    weight in 128-row tiles (wgmma N 256 and 128); each row must come out
    the same either way: config D's grouped K11 runs the txt rows in the
    img rows' 256-row tiles, D0's K2 in 128-row ones, and D's latent must
    equal D0's."""
    gen = torch.Generator(device=dev).manual_seed(7)
    qt = random_qtensor(gen, 3072, 12288, kind="nf4", device=dev)
    qt.scale.uniform_(0.01, 0.03, generator=gen)
    x = torch.randn((4608, 3072), generator=gen, device=dev).bfloat16()
    plan = lambda m: qmatmul.qmm_plan("nf4", m, 3072, 12288, split=qt.split, group=qt.group)
    assert (plan(4608).block_m, plan(512).block_m) == (256, 128)
    kern = qmatmul.qmm_nf4_fast16 if fast16 else qmatmul.qmm_nf4
    assert torch.equal(kern(x, qt, torch.bfloat16)[:512],
                       kern(x[:512].contiguous(), qt, torch.bfloat16))


def _affine_qtensor(fmt: str, k: int, n: int, seed: int):
    """A canonical affine tensor on the host: GGUF blocks from the port's
    encoders (Q8_K, which has none, from random blocks with a valid f32
    scale), or bnb int8 from random codes and row scales."""
    rng = np.random.default_rng(seed)
    if fmt == "int8":
        q = rng.integers(-127, 128, size=(n, k), dtype=np.int8)
        scb = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
        return bnb_int8_to_canonical(q, scb)
    if fmt == "q8_k":
        f = GGML_FORMATS[fmt]
        blocks = rng.integers(0, 256, size=(n * k // f.block_elems, f.block_bytes),
                              dtype=np.uint8)
        d = rng.uniform(1e-3, 2e-3, size=len(blocks)).astype(np.float32)
        blocks[:, 0:4] = d[:, None].view(np.uint8)
        return gguf_to_canonical(fmt, blocks.tobytes(), (n, k))
    w = (rng.standard_normal((n, k)) * 0.05).astype(np.float32)
    return gguf_to_canonical(fmt, ENCODERS[fmt](w), (n, k))


K4_FORMATS = ["q4_0", "q4_1", "q5_0", "q5_1", "q8_0", "q2_k", "q3_k", "q4_k",
              "q5_k", "q6_k", "q8_k", "int8"]


@pytest.mark.parametrize("fmt", K4_FORMATS)
@pytest.mark.parametrize("m,k,n", [(1, 512, 256), (33, 512, 256), (130, 768, 384)])
def test_k4_matches_plain(dev, fmt, m, k, n):
    """Same decoded bf16 weight as the plain version, bit for bit; only the
    f32 summation order differs: every element within that order's bound,
    summed-rel band 1e-5."""
    qt = _affine_qtensor(fmt, k, n, seed=m).map(lambda t: t.to(dev))
    assert qt.codebook is None and qmatmul.supports(qt) and not qmatmul.q8t_ok(qt)
    gen = torch.Generator(device=dev).manual_seed(m)
    x = torch.randn((m, k), generator=gen, device=dev).bfloat16()
    before = _cuda.launch_counts()["qmm_affine"]
    y = qmatmul.quantized_matmul(x, qt)
    assert _cuda.launch_counts()["qmm_affine"] == before + 1
    ref = qmatmul.qmm_dequant_plain(x, qt, torch.bfloat16)
    assert torch.isfinite(y).all() and _within_summation_order(y, ref, x, qt)
    assert _summed_rel(y, ref) <= 1e-5


@pytest.mark.parametrize("kind,m,k,n", [("q4_0", 513, 64, 256), ("q8_0", 513, 64, 256),
                                        ("q4_0", 4, 3072, 128), ("q8_0", 1, 15360, 128)])
def test_k4_synthetic_kinds_match_plain(dev, kind, m, k, n):
    """The synthetic GGUF kinds of the main path, at its K extremes (img_in
    K=64 with a single split-block run, linear2 K=15360). Every element
    within the summation-order bound; summed-rel 1e-4, since at K=15360 the f32
    summation order flips one output in ~100 by an ulp and N=128 outputs
    leave no average (measured 1.6e-5 at M1 K15360 N128, NVIDIA H100 80GB
    HBM3, 700 W)."""
    gen = torch.Generator(device=dev).manual_seed(k)
    qt = random_qtensor(gen, k, n, kind=kind, device=dev)
    x = torch.randn((m, k), generator=gen, device=dev).bfloat16()
    y = qmatmul.qmm_affine(x, qt, torch.bfloat16)
    ref = qmatmul.qmm_dequant_plain(x, qt, torch.bfloat16)
    assert _within_summation_order(y, ref, x, qt)
    assert _summed_rel(y, ref) <= 1e-4


@pytest.mark.parametrize("b,h,sq,skv", [(1, 3, 64, 64), (2, 2, 300, 300), (1, 2, 1, 130),
                                        (1, 1, 200, 65)])
def test_k3_matches_plain(dev, b, h, sq, skv):
    gen = torch.Generator(device=dev).manual_seed(sq + skv)
    q = torch.randn((b, h, sq, 128), generator=gen, device=dev).bfloat16()
    k, v = (torch.randn((b, h, skv, 128), generator=gen, device=dev).bfloat16()
            for _ in range(2))
    y = flash.flash_fwd(q, k, v, 128 ** -0.5)
    ref = flash.flash_attention_plain(q, k, v, 128 ** -0.5)
    assert _summed_rel(y, ref.transpose(1, 2).reshape(b, sq, h * 128)) <= 5e-4


def test_grad_guard_refuses_inputs_that_require_grad(dev):
    """The kernels have no backward: under grad mode a q8t linear (K1,
    through ops.linear) and a flash call (K3, through sdpa) on an input that
    requires grad raise RuntimeError naming the wrapper and the
    DIFFUSION_RS_TPU_NO_FLASH knob, and launch nothing; under no_grad both
    run; nothing falls back to the plain version."""
    from diffusion_rs_tpu_torch.ops import Linear, linear
    from diffusion_rs_tpu_torch.ops.attention import sdpa

    gen = torch.Generator(device=dev).manual_seed(0)
    lin = Linear(w=random_qtensor(gen, 256, 128, kind="q8t", device=dev))
    x = torch.randn((4, 256), generator=gen, device=dev).bfloat16().requires_grad_(True)
    q = torch.randn((1, 2, 64, 128), generator=gen, device=dev).bfloat16().requires_grad_(True)
    before = _cuda.launch_counts()
    with pytest.raises(RuntimeError, match="qmm_s8.*no backward.*DIFFUSION_RS_TPU_NO_FLASH"):
        linear(x, lin)
    with pytest.raises(RuntimeError, match="flash_fwd.*no backward.*DIFFUSION_RS_TPU_NO_FLASH"):
        sdpa(q, q, q)
    assert _cuda.launch_counts() == before
    with torch.no_grad():
        linear(x, lin)
        sdpa(q, q, q)
    after = _cuda.launch_counts()
    assert after["qmm_s8"] == before["qmm_s8"] + 1
    assert after["flash_fwd"] == before["flash_fwd"] + 1


def test_quantized_matmul_dispatch_on_card(dev):
    """q8t, nf4 and the affine kinds reach their kernels through
    ``quantized_matmul``; N=64 takes the dequantize + matmul fallback
    without a launch."""
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((2, 5, 256), generator=gen, device=dev).bfloat16()
    _cuda.reset_launch_counts()
    for kind in ("q8t", "nf4", "q4_0", "q8_0"):
        y = qmatmul.quantized_matmul(x, random_qtensor(gen, 256, 128, kind=kind, device=dev))
        assert tuple(y.shape) == (2, 5, 128) and y.dtype == torch.bfloat16
    for kind in ("q8t", "q4_0"):
        qmatmul.quantized_matmul(x, random_qtensor(gen, 256, 64, kind=kind, device=dev))
    assert _cuda.launch_counts() == {**dict.fromkeys(_cuda.KERNELS, 0), "qmm_s8": 1,
                                     "qmm_nf4": 1, "qmm_affine": 2}


def _tables(b, s, dev):
    """Expanded RoPE tables of FLUX-style positions (text rows at 0, then an
    image grid) on the card."""
    n_txt = s // 8
    r = torch.arange(s - n_txt, device=dev)
    img = torch.stack([torch.zeros_like(r), r // 64, r % 64], -1).float()
    ids = torch.cat([torch.zeros((n_txt, 3), device=dev), img])
    cos, sin = rope_tables(ids[None].expand(b, s, 3), (16, 56, 56))
    return expand_rope_tables(cos, sin)


@pytest.mark.parametrize("b,h,sq,skv,wide", [(1, 3, 64, 64, False), (2, 2, 300, 300, True),
                                             (1, 2, 1, 130, False), (1, 1, 200, 65, True)])
def test_k6_k7_match_plain(dev, b, h, sq, skv, wide):
    """K6 against its plain version (band 5e-4, as K3); K7 against its plain
    version, and equal to K6 run on plain-rotated q/k bit for bit. ``wide``
    passes q/k/v as column slices of wider rows (as the single blocks'
    fused projection gives v)."""
    gen = torch.Generator(device=dev).manual_seed(sq + skv)
    n = h * 128
    width = 3 * n + 256 if wide else n

    def operand(s, i):
        t = torch.randn((b, s, width), generator=gen, device=dev).bfloat16()
        return t[..., i * n:(i + 1) * n] if wide else t

    q, k, v = operand(sq, 0), operand(skv, 1), operand(skv, 2)
    scale = 128 ** -0.5
    before = _cuda.launch_counts()
    y6 = flash.flash_sm(q, k, v, scale)
    assert _summed_rel(y6, flash.flash_sm_plain(q, k, v, 128, scale)) <= 5e-4
    if sq != skv:
        return  # K7 takes the same tables for q and k only at equal lengths
    ce, se = _tables(b, sq, dev)
    y7 = flash.flash_rope(q, k, v, ce, se, ce, se, scale)
    assert _summed_rel(y7, flash.flash_rope_plain(q, k, v, ce, se, ce, se, 128, scale)) <= 5e-4
    qr = flash.rope_halfsplit_seqmajor(q, ce, se, 128)
    kr = flash.rope_halfsplit_seqmajor(k, ce, se, 128)
    assert torch.equal(y7, flash.flash_sm(qr, kr, v, scale))
    after = _cuda.launch_counts()
    assert (after["flash_sm"] - before["flash_sm"], after["flash_rope"] - before["flash_rope"],
            after["flash_fwd"] - before["flash_fwd"]) == (2, 1, 0)


@pytest.mark.parametrize("kind", ["q8t", "q8_0", "q4_0", "nf4"])
@pytest.mark.parametrize("ms", [(130, 17), (64, 0, 1, 200, 3, 128, 5, 33)])
def test_k8_matches_per_group_kernels(dev, kind, ms):
    """Each group's output equals K1's (q8t), K4's (q8_0, q4_0) or K2's
    (nf4: K11) output for that group, bit for bit, and is within its band of
    the plain version (K2's 2e-3 for nf4); one launch for the whole call."""
    gen = torch.Generator(device=dev).manual_seed(len(ms))
    k, n = 768, 384
    qts = [random_qtensor(gen, k, n, kind=kind, device=dev) for _ in ms]
    if kind in ("q8t", "nf4"):
        for qt in qts:
            qt.scale.uniform_(*((0.5e-3, 2e-3) if kind == "q8t" else (0.01, 0.03)),
                              generator=gen)
    xs = [torch.randn((m, k), generator=gen, device=dev).bfloat16() for m in ms]
    plan, name, single = {
        "q8t": ("s8", "qmm_grouped_s8", qmatmul.qmm_s8),
        "nf4": ("codebook", "qmm_grouped_nf4", qmatmul.qmm_nf4),
    }.get(kind, ("affine", "qmm_grouped_affine", qmatmul.qmm_affine))
    assert qmatmul.grouped_plan(qts) == plan
    before = _cuda.launch_counts()[name]
    ys = qmatmul.quantized_matmul_grouped(xs, qts)
    assert _cuda.launch_counts()[name] == before + 1
    for x, qt, y in zip(xs, qts, ys):
        assert torch.equal(y, single(x, qt, torch.bfloat16))
        if x.shape[0]:
            ref = qmatmul.qmm_grouped_plain([x], [qt], torch.bfloat16)[0]
            assert _summed_rel(y, ref) <= (2e-3 if kind == "nf4" else 1e-5)


INT8_MODES = {"flash_s8": (True, False), "flash_s8pv": (False, True),
              "flash_s8_s8pv": (True, True)}


@pytest.mark.parametrize("entry", list(INT8_MODES))
@pytest.mark.parametrize("b,h,sq,skv,qblock", [
    (1, 3, 64, 64, None), (2, 2, 300, 300, None), (1, 2, 1, 130, None),
    (1, 1, 200, 65, None), (1, 2, 300, 300, 128), (1, 2, 130, 1600, None),
    (1, 4, 256, 3000, None)])
def test_k9_k10_match_plain(dev, entry, b, h, sq, skv, qblock):
    """K9 / K10 / both against their plain version: the quantized codes and
    integer dots are exact in both, so only f32 summation orders (K9's bf16
    P.V, K10's bf16-mode QK^T, the prepass kernel's mean), expf against
    torch.exp of the same arguments, and the codes that order moves by one
    differ: K3's band, 5e-4. One launch of the prepass kernel, one of the
    mode's entry point and none of K3's. (S1600: two quantization blocks of
    1536, the second ragged; S3000: two blocks, the second ragged inside a
    64-row tile; qblock 128 at S300: three, the last ragged.)"""
    s8, s8_pv = INT8_MODES[entry]
    gen = torch.Generator(device=dev).manual_seed(sq + skv)
    q = torch.randn((b, h, sq, 128), generator=gen, device=dev).bfloat16()
    k = torch.randn((b, h, skv, 128), generator=gen, device=dev).bfloat16()
    v = (torch.randn((b, h, skv, 128), generator=gen, device=dev) + 1.0).bfloat16()
    before = _cuda.launch_counts()
    y = flash.flash_int8(q, k, v, 128 ** -0.5, s8, s8_pv, qblock=qblock)
    after = _cuda.launch_counts()
    assert [after[n] - before[n] for n in (entry, "flash_quant", "flash_fwd")] == [1, 1, 0]
    ref = flash.flash_int8_plain(q, k, v, 128 ** -0.5, s8, s8_pv, qblock=qblock)
    assert torch.isfinite(y).all()
    assert _summed_rel(y, ref.transpose(1, 2).reshape(b, sq, h * 128)) <= 5e-4


@pytest.mark.parametrize("entry", list(INT8_MODES))
def test_int8_plan_is_the_compiled_layout(dev, entry):
    """int8_flash_plan's kv tile, ring stages and shared-memory bytes are
    the compiled body's (``flash_int8_layout``), which launches nothing."""
    s8, s8_pv = INT8_MODES[entry]
    plan = flash.int8_flash_plan(1, 24, 4608, 4608, flash.quant_block(4608), s8, s8_pv)
    before = _cuda.launch_counts()
    assert (plan.block_kv, plan.stages, plan.smem_bytes) == _cuda.int8_layout(s8, s8_pv)
    assert _cuda.launch_counts() == before


def _quant_planes_match(got, ref, s_real: int, transposed: bool) -> None:
    """The prepass kernel's (codes, scales, mean) against the plain
    versions' in test_quantize_prepasses_match_jax's bands: mean within rtol
    1e-6 (the kernel sums in f64 in another order), scales within one f32
    ulp, codes off by one on at most 1e-3 of the entries; the padding rows
    zero."""
    codes, scales, mean = got
    rc, rs, rm = ref
    assert codes.shape == rc.shape and codes.dtype == torch.int8 and scales.shape == rs.shape
    assert torch.allclose(mean, rm, rtol=1e-6, atol=1e-7)
    assert int((scales.view(torch.int32) - rs.view(torch.int32)).abs().max()) <= 1
    diff = (codes.int() - rc.int()).abs()
    assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) <= 1e-3
    rows = torch.arange(codes.shape[-1 if transposed else 2], device=codes.device)
    if transposed:  # the source row of each position of v_kernel_layout
        rows = flash.v_kernel_layout(rows[None, None, :, None])[0, 0, 0]
        assert not codes[..., rows >= s_real].any()
    else:
        assert not codes[:, :, rows >= s_real].any()


@pytest.mark.parametrize("b,h,skv,qblock", [(1, 24, 4608, None), (1, 24, 4112, None),
                                            (2, 2, 300, 128), (1, 3, 130, None),
                                            (1, 2, 1600, None)])
def test_flash_quant_matches_plain(dev, b, h, skv, qblock):
    """The prepass kernel (``flash_quant``: k and v in one launch) against
    quantize_k / quantize_v + v_kernel_layout on the same card, at FLUX's
    joint length, a ragged one, several blocks of 128, a ragged chunk and two
    blocks of 1536; k alone and v alone give the same planes (torch.equal)."""
    gen = torch.Generator(device=dev).manual_seed(skv)
    k = (torch.randn((b, h, skv, 128), generator=gen, device=dev) * 0.3 + 0.1).bfloat16()
    v = (torch.randn((b, h, skv, 128), generator=gen, device=dev) + 1.0).bfloat16()
    qb = qblock or flash.quant_block(skv)
    before = _cuda.launch_counts()["flash_quant"]
    kres, vres = flash.quantize_kv(k, v, qb)
    assert _cuda.launch_counts()["flash_quant"] == before + 1
    vq, sv, vm = flash.quantize_v(v, qb)
    _quant_planes_match(kres, flash.quantize_k(k, qb), skv, transposed=False)
    _quant_planes_match(vres, (flash.v_kernel_layout(vq), sv, vm), skv, transposed=True)
    k_alone, none = flash.quantize_kv(k, None, qb)
    none2, v_alone = flash.quantize_kv(None, v, qb)
    assert none == none2 == (None, None, None)
    assert all(torch.equal(a, c) for a, c in zip(kres + vres, k_alone + v_alone))


def _q4_k_with_zero_scales(k: int, n: int, seed: int):
    """A Q4_K tensor whose first super-block of the first 16 output columns
    holds values in [-4e-6, -2e-6]: d underflows f16 (scale 0) while dmin
    does not (bias != 0), the groups the fast16 decode keeps on the plain
    bias add."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n, k)) * 0.05).astype(np.float32)
    w[:16, :256] = rng.uniform(-4e-6, -2e-6, size=(16, 256)).astype(np.float32)
    qt = gguf_to_canonical("q4_k", ENCODERS["q4_k"](w), (n, k))
    zero = qt.scale == 0
    assert zero.any() and (qt.bias[zero] != 0).any()
    return qt


def _fast16_within_summation_order(y, ref, x, w16) -> bool:
    """``_within_summation_order`` against the fast16 weight ``w16``."""
    y, ref = y.float(), ref.float()
    mag = x.float().abs() @ w16.float().abs()
    tol = torch.maximum(y.abs(), ref.abs()) * 2.0 ** -7 + mag * (2 * w16.shape[0] * 2.0 ** -24)
    return bool(((y - ref).abs() <= tol).all())


@pytest.mark.parametrize("kind", ["nf4", "fp4"])
@pytest.mark.parametrize("m,k,n", [(1, 1024, 384), (130, 1024, 384), (64, 640, 128)])
def test_k12_matches_plain(dev, kind, m, k, n):
    """K12's decoded weight (the product with the identity) equals the plain
    fast16 decode bit for bit; its output is within the f32 summation-order
    bound of the plain version and K2's 2e-3 band; one K12 launch, no K2."""
    from diffusion_rs_tpu_torch.quant.bnb import CODEBOOKS

    gen = torch.Generator(device=dev).manual_seed(m + k)
    qt = random_qtensor(gen, k, n, kind="nf4", device=dev)
    qt.scale.uniform_(0.01, 0.03, generator=gen)
    if kind == "fp4":
        qt = dataclasses.replace(qt, kind="fp4", codebook=torch.as_tensor(
            CODEBOOKS["fp4"], device=dev))
    w16 = qmatmul.dequantize_fast16(qt, torch.bfloat16)
    eye = torch.eye(k, device=dev, dtype=torch.bfloat16)
    assert torch.equal(qmatmul.qmm_nf4_fast16(eye, qt, torch.bfloat16), w16)
    x = torch.randn((m, k), generator=gen, device=dev).bfloat16()
    before = _cuda.launch_counts()
    y = qmatmul.qmm_nf4_fast16(x, qt, torch.bfloat16)
    after = _cuda.launch_counts()
    assert (after["qmm_nf4_fast16"] - before["qmm_nf4_fast16"],
            after["qmm_nf4"] - before["qmm_nf4"]) == (1, 0)
    ref = qmatmul.qmm_dequant_fast16_plain(x, qt, torch.bfloat16)
    assert _fast16_within_summation_order(y, ref, x, w16)
    assert _summed_rel(y, ref) <= 2e-3


@pytest.mark.parametrize("fmt", K4_FORMATS + ["q4_k_zero_scales"])
@pytest.mark.parametrize("m,k,n", [(1, 512, 256), (130, 768, 384)])
def test_k13_matches_plain(dev, fmt, m, k, n):
    """K13's decoded weight equals the plain fast16 decode bit for bit (Q4_K
    with s == 0 groups included); its output is within the f32
    summation-order bound of the plain version and K4's 1e-5 band."""
    if fmt == "q4_k_zero_scales":
        qt = _q4_k_with_zero_scales(k, n, seed=m)
    else:
        qt = _affine_qtensor(fmt, k, n, seed=m)
    qt = qt.map(lambda t: t.to(dev))
    w16 = qmatmul.dequantize_fast16(qt, torch.bfloat16)
    eye = torch.eye(k, device=dev, dtype=torch.bfloat16)
    assert torch.equal(qmatmul.qmm_affine_fast16(eye, qt, torch.bfloat16), w16)
    gen = torch.Generator(device=dev).manual_seed(m)
    x = torch.randn((m, k), generator=gen, device=dev).bfloat16()
    before = _cuda.launch_counts()
    y = qmatmul.qmm_affine_fast16(x, qt, torch.bfloat16)
    after = _cuda.launch_counts()
    assert (after["qmm_affine_fast16"] - before["qmm_affine_fast16"],
            after["qmm_affine"] - before["qmm_affine"]) == (1, 0)
    ref = qmatmul.qmm_dequant_fast16_plain(x, qt, torch.bfloat16)
    assert torch.isfinite(y).all() and _fast16_within_summation_order(y, ref, x, w16)
    assert _summed_rel(y, ref) <= 1e-5


F32_ENTRIES = [("qmm_s8", "q8t"), ("qmm_nf4", "nf4"), ("qmm_nf4_fast16", "nf4"),
               ("qmm_affine", "q4_0"), ("qmm_affine", "q8_0"), ("qmm_affine", "q4_k"),
               ("qmm_affine_fast16", "q4_0"), ("qmm_affine_fast16", "q4_k")]


@pytest.mark.parametrize("name,fmt", F32_ENTRIES)
@pytest.mark.parametrize("m,k,n", [(33, 1536, 256), (300, 7680, 384)])
def test_f32_entries_match_plain(dev, name, fmt, m, k, n):
    """K1, K2, K12, K4 and K13 storing f32 (a row-parallel linear's partial,
    the K-slices of FLUX's proj and linear2 at tp=2): one launch of the
    ``_f32`` entry and none of the bf16 one; the f32 output cast to bf16 is
    the bf16 entry's output bit for bit (the same accumulators); K1 equals
    its plain version bit for bit, the decoding kernels stay within the f32
    summation-order bound of theirs (2 K 2^-24 sum |x w| per element)."""
    gen = torch.Generator(device=dev).manual_seed(m + k)
    if fmt in ("q8t", "nf4"):
        qt = random_qtensor(gen, k, n, kind=fmt, device=dev)
        qt.scale.uniform_(0.5e-3, 2e-3, generator=gen)
    else:
        qt = _affine_qtensor(fmt, k, n, seed=m).map(lambda t: t.to(dev))
    x = torch.randn((m, k), generator=gen, device=dev).bfloat16()
    fn = getattr(qmatmul, name)
    before = _cuda.launch_counts()
    y = fn(x, qt, torch.float32)
    after = _cuda.launch_counts()
    assert (after[f"{name}_f32"] - before[f"{name}_f32"], after[name] - before[name]) == (1, 0)
    assert y.dtype == torch.float32 and y.shape == (m, n)
    assert torch.equal(y.bfloat16(), fn(x, qt, torch.bfloat16))
    if name == "qmm_s8":
        assert torch.equal(y, qmatmul.qmm_s8_plain(x, qt.packed, qt.scale, torch.float32))
        return
    fast16 = name.endswith("fast16")
    w = (qmatmul.dequantize_fast16(qt, torch.bfloat16) if fast16
         else dequantize(qt, torch.float32).bfloat16()).float()
    ref = (qmatmul.qmm_dequant_fast16_plain if fast16 else qmatmul.qmm_dequant_plain)(
        x, qt, torch.float32)
    tol = (x.float().abs() @ w.abs()) * (2 * k * 2.0 ** -24)
    assert bool(((y - ref).abs() <= tol).all())


def test_grouped_entries_refuse_f32(dev):
    """The grouped kernels (K8, K11) have no f32 entry: asked for one on the
    card they raise rather than store bf16."""
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((8, 256), generator=gen, device=dev).bfloat16()
    for kind, grouped in (("q8t", qmatmul.qmm_grouped_s8), ("nf4", qmatmul.qmm_grouped_nf4),
                          ("q4_0", qmatmul.qmm_grouped_affine)):
        qt = random_qtensor(gen, 256, 128, kind=kind, device=dev)
        with pytest.raises(ValueError, match="produces bfloat16, not torch.float32"):
            grouped([x, x], [qt, qt], torch.float32)


def test_fast16_dispatch_on_card(dev, monkeypatch):
    """With DIFFUSION_RS_TPU_QMM_FAST16 set, nf4 takes K12 and the affine
    kinds K13; q8t keeps K1 and the grouped calls keep K11 / K8 (JAX passes
    fast16=False to them); f32 activations leave fast16 off."""
    monkeypatch.setenv("DIFFUSION_RS_TPU_QMM_FAST16", "1")
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((2, 5, 256), generator=gen, device=dev).bfloat16()
    _cuda.reset_launch_counts()
    for kind in ("q8t", "nf4", "q4_0", "q8_0"):
        qmatmul.quantized_matmul(x, random_qtensor(gen, 256, 128, kind=kind, device=dev))
    for kind in ("nf4", "q4_0"):
        qts = [random_qtensor(gen, 256, 128, kind=kind, device=dev) for _ in range(2)]
        qmatmul.quantized_matmul_grouped([x, x[:1]], qts)
    assert _cuda.launch_counts() == {**dict.fromkeys(_cuda.KERNELS, 0), "qmm_s8": 1,
                                     "qmm_nf4_fast16": 1, "qmm_affine_fast16": 2,
                                     "qmm_grouped_nf4": 1, "qmm_grouped_affine": 1}
    assert not qmatmul.fast16_enabled(x.float())


LSE_ENTRIES = {"flash_fwd_lse": (False, False), **{f"{e}_lse": m for e, m in INT8_MODES.items()}}


@pytest.mark.parametrize("entry", list(LSE_ENTRIES))
@pytest.mark.parametrize("b,h,sq,skv", [(1, 3, 64, 64), (2, 2, 300, 300), (1, 2, 1, 130),
                                        (1, 1, 200, 65), (1, 2, 130, 1600)])
def test_k14_matches_plain(dev, entry, b, h, sq, skv):
    """K14 against the plain versions: o within K3's band (5e-4), lse within
    1e-3 max-abs (f32 summation orders, and K3's MUFU.EX2 or the int8 body's
    expf against torch.exp, on log-sum-exps of magnitude ~5); one launch of the entry (and of the
    prepass kernel for the int8 modes) and none of K3, K9 or K10; the s8
    entry returns the k mean its prepass removed, within the prepass's mean
    band of the plain one."""
    s8, s8_pv = LSE_ENTRIES[entry]
    gen = torch.Generator(device=dev).manual_seed(sq + skv)
    q = torch.randn((b, h, sq, 128), generator=gen, device=dev).bfloat16()
    k = torch.randn((b, h, skv, 128), generator=gen, device=dev).bfloat16()
    v = (torch.randn((b, h, skv, 128), generator=gen, device=dev) + 1.0).bfloat16()
    _cuda.reset_launch_counts()
    o, lse, km = flash.flash_attention(q, k, v, 128 ** -0.5, out_seqmajor=True, s8=s8,
                                       s8_pv=s8_pv, save_lse=True)
    assert _cuda.launch_counts() == {**dict.fromkeys(_cuda.KERNELS, 0), entry: 1,
                                     **({"flash_quant": 1} if s8 or s8_pv else {})}
    if s8 or s8_pv:
        ref, lse_ref, km_ref = flash.flash_int8_lse_plain(q, k, v, 128 ** -0.5, s8, s8_pv)
        assert (km is None) == (not s8)
        assert km is None or torch.allclose(km, km_ref, rtol=1e-6, atol=1e-7)
    else:
        ref, lse_ref = flash.flash_attention_lse_plain(q, k, v, 128 ** -0.5)
        assert km is None
    assert torch.isfinite(o).all() and tuple(lse.shape) == (b, h, sq)
    assert _summed_rel(o, ref.transpose(1, 2).reshape(b, sq, h * 128)) <= 5e-4
    assert float((lse - lse_ref).abs().max()) <= 1e-3


def test_ring_two_ranks_on_one_card(dev, tmp_path):
    """Two ranks over gloo, on cuda:0 on a one-card host (k/v staged through
    pinned host memory): the ring's output equals the plain attention of the whole
    sequence within 4e-3 summed-rel (each chunk's bf16 output is rounded
    before the f32 merge), and each rank launched K14 once per chunk and
    no other flash kernel."""
    from diffusion_rs_tpu_torch.parallel import spawn
    from torch_mesh_workers import cuda_ring_rank

    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((1, 4, 512, 128)).astype(np.float32) for _ in range(3))
    modes = ["bf16", "s8_pv"]
    np.savez(tmp_path / "inputs.npz", q=q, k=k, v=v + 1.0, modes=np.array(modes))
    spawn(cuda_ring_rank, 2, "gloo", args=(str(tmp_path),))
    parts = _check_cuda_ring(dev, tmp_path, 2, q, k, v, modes)
    # LOCAL_RANK's card, modulo the cards there are: both on cuda:0 on a
    # one-card host
    n = torch.cuda.device_count()
    assert [int(p["device"]) for p in parts] == [0, 1 % n]


def _check_cuda_ring(dev, tmp_path, world, q, k, v, modes):
    """The ranks' ring outputs (``cuda_ring_rank``) against the plain
    attention of the whole sequence, and each rank's launches: K14 once per
    chunk (the int8 modes' prepass kernel too), no other kernel."""
    parts = [np.load(tmp_path / f"cuda_ring_{r}.npz", allow_pickle=True) for r in range(world)]
    qt, kt, vt = (torch.from_numpy(a).to(dev).bfloat16() for a in (q, k, v + 1.0))
    for mode in modes:
        s8, s8_pv = RING_MODES[mode]
        got = torch.from_numpy(np.concatenate([p[mode] for p in parts], axis=1))
        if s8_pv:
            ref = flash.flash_int8_plain(qt, kt, vt, 128 ** -0.5, s8, s8_pv)
        else:
            ref = flash.flash_attention_plain(qt, kt, vt, 128 ** -0.5)
        ref = ref.transpose(1, 2).reshape(1, 512, 512).float().cpu()
        assert _summed_rel(got, ref) <= (4e-3 if mode == "bf16" else 2e-2)
        want = [("flash_fwd_lse", world)] if mode == "bf16" else [
            ("flash_quant", world), ("flash_s8pv_lse", world)]
        for p in parts:
            assert [tuple(x) for x in p[f"{mode}_launches"]] == want
    return parts


def test_ring_nccl_one_card_per_rank(dev, tmp_path):
    """Two ranks over NCCL, each on its own card (init_multihost makes
    ``LOCAL_RANK``'s card current; every launch runs on its operands' card
    and stream): the same outputs and launches as the ranks sharing one
    card, with rank r's tensors and kernels on cuda:r. Needs two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from diffusion_rs_tpu_torch.parallel import spawn
    from torch_mesh_workers import cuda_ring_rank

    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((1, 4, 512, 128)).astype(np.float32) for _ in range(3))
    modes = ["bf16", "s8_pv"]
    np.savez(tmp_path / "inputs.npz", q=q, k=k, v=v + 1.0, modes=np.array(modes))
    spawn(cuda_ring_rank, 2, "nccl", args=(str(tmp_path),))
    parts = _check_cuda_ring(dev, tmp_path, 2, q, k, v, modes)
    assert [int(p["device"]) for p in parts] == [0, 1]


@pytest.mark.parametrize("kind,fmt", [("q8t", None), ("nf4", None), ("affine", "q4_0")])
def test_qmm_kernels_on_two_cards_in_one_process(dev, kind, fmt):
    """K1, K2 and K4 launched on cuda:0 and then on cuda:1 from one process:
    a function's shared-memory limit and the SM count are per device, so the
    second card's first launch must raise its own limit (the launchers keep
    both per device). Each card's product equals its plain version (K1 bit
    for bit, K2 within 2e-3, K4 within the summation-order bound). Needs two
    cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    name = {"q8t": "qmm_s8", "nf4": "qmm_nf4", "affine": "qmm_affine"}[kind]
    for index in (0, 1):
        card = torch.device("cuda", index)
        gen = torch.Generator(device=card).manual_seed(3)
        if kind == "affine":
            qt = _affine_qtensor(fmt, 768, 384, seed=3).map(lambda t: t.to(card))
        else:
            qt = random_qtensor(gen, 768, 384, kind=kind, device=card)
        x = torch.randn((130, 768), generator=gen, device=card).bfloat16()
        before = _cuda.launch_counts()[name]
        y = qmatmul.quantized_matmul(x, qt)
        torch.cuda.synchronize(card)
        assert _cuda.launch_counts()[name] == before + 1 and y.device == card
        if kind == "q8t":
            assert torch.equal(y, qmatmul.qmm_s8_plain(x, qt.packed, qt.scale, torch.bfloat16))
        elif kind == "nf4":
            assert _summed_rel(y, qmatmul.qmm_dequant_plain(x, qt, torch.bfloat16)) <= 2e-3
        else:
            ref = qmatmul.qmm_dequant_plain(x, qt, torch.bfloat16)
            assert _within_summation_order(y, ref, x, qt)


# ---------------------------------------------------------------------------
# The Hopper bodies of the bf16 flash kernels (K3, K6, K7, K14) and of the
# affine kernels (K4, K8-affine, K13) at the main path's shapes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sq,skv", [(4608, 4608), (4112, 4112), (100, 100), (1, 1),
                                    (64, 4112), (4608, 300)])
def test_bf16_flash_entries_at_flux_lengths(dev, sq, skv):
    """K3, K14 (output and lse), K6 and, at equal lengths, K7 against their
    plain versions at FLUX's joint length (24 heads), a ragged length and
    lengths below one 128-row tile: o within 5e-4, lse within 1e-3; K7
    equal to K6 on rope_qk's q/k, and rope_qk's q/k equal to
    rope_halfsplit_seqmajor's (torch.equal)."""
    b, h, scale = 1, 24, 128 ** -0.5
    gen = torch.Generator(device=dev).manual_seed(sq + skv)
    q = torch.randn((b, h, sq, 128), generator=gen, device=dev).bfloat16()
    k, v = (torch.randn((b, h, skv, 128), generator=gen, device=dev).bfloat16()
            for _ in range(2))
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    y3 = flash.flash_fwd(q, k, v, scale)
    y14 = flash.flash_fwd(q, k, v, scale, lse=lse)
    ref, lse_ref = flash.flash_attention_lse_plain(q, k, v, scale)
    ref = ref.transpose(1, 2).reshape(b, sq, h * 128)
    assert torch.equal(y3, y14) and torch.isfinite(y3).all()
    assert _summed_rel(y3, ref) <= 5e-4
    assert float((lse - lse_ref).abs().max()) <= 1e-3

    def seq(t):
        return t.transpose(1, 2).reshape(b, t.shape[2], h * 128)

    y6 = flash.flash_sm(seq(q), seq(k), seq(v), scale)
    assert _summed_rel(y6, ref) <= 5e-4
    if sq != skv:
        return
    ce, se = _tables(b, sq, dev)
    before = _cuda.launch_counts()
    y7 = flash.flash_rope(seq(q), seq(k), seq(v), ce, se, ce, se, scale)
    after = _cuda.launch_counts()
    assert (after["rope_qk"] - before["rope_qk"], after["flash_rope"] - before["flash_rope"],
            after["flash_sm"] - before["flash_sm"]) == (1, 1, 0)
    qr, kr = flash.rope_qk(seq(q), seq(k), ce, se, ce, se)
    assert torch.equal(qr, flash.rope_halfsplit_seqmajor(seq(q), ce, se, 128))
    assert torch.equal(kr, flash.rope_halfsplit_seqmajor(seq(k), ce, se, 128))
    assert torch.equal(y7, flash.flash_sm(qr, kr, seq(v), scale))
    ref7 = flash.flash_rope_plain(seq(q), seq(k), seq(v), ce, se, ce, se, 128, scale)
    assert _summed_rel(y7, ref7) <= 5e-4


@pytest.mark.parametrize("offset", [0, 3072, 6144])
@pytest.mark.parametrize("width", [9216, 21504])
def test_rope_qk_on_fused_projection_slices(dev, offset, width):
    """rope_qk reads q and k as column slices of a fused qkv (9216) or
    qkv_mlp (21504) row and writes contiguous rotated copies equal to the
    plain rotation; K6 takes the slices as they are."""
    s, n = 300, 3072
    gen = torch.Generator(device=dev).manual_seed(width + offset)
    proj = torch.randn((1, s, width), generator=gen, device=dev).bfloat16()
    x = proj[..., offset:offset + n]
    ce, se = _tables(1, s, dev)
    xr, xr2 = flash.rope_qk(x, x, ce, se, ce, se)
    assert xr.is_contiguous() and torch.equal(xr, xr2)
    assert torch.equal(xr, flash.rope_halfsplit_seqmajor(x, ce, se, 128))
    y = flash.flash_sm(x, x, x, 128 ** -0.5)
    assert _summed_rel(y, flash.flash_sm_plain(x, x, x, 128, 128 ** -0.5)) <= 5e-4


def _rotated_pairs_close(x, y) -> bool:
    """Each rotated pair of q or k [..., 128] within 2^-5 of the pair's norm
    of its counterpart: a sum of squares taken in another order moves 1 /
    rms by an f32 ulp, which can flip bf16(x * r) by one ulp; the scale's
    product rounds again (2 ulps of y), and the rotation carries that
    error whole into each output of the pair, however much the output
    cancels (one ulp of the output would not hold there)."""
    x, y = x.float().unflatten(-1, (-1, 2)), y.float().unflatten(-1, (-1, 2))
    norm = torch.maximum(x.norm(dim=-1), y.norm(dim=-1))[..., None]
    return bool(((x - y).abs() <= norm * 2.0 ** -5).all())


# (kind, batch, txt rows, img rows, heads, qkv_mlp / qkv column views, per-sample tables)
QK_NORM_ROPE_CASES = {
    "dev_double": ("double", 1, 512, 4096, 24, False, False),
    "dev_single": ("single", 1, 512, 4096, 24, False, False),
    "schnell_double": ("double", 1, 256, 4096, 24, False, False),
    "served_b4_double": ("double", 4, 256, 1024, 24, False, True),
    "served_b4_single": ("single", 4, 256, 1024, 24, False, False),
    "tp_rank_h12": ("double", 1, 512, 4096, 12, False, False),
    "qkv_mlp_view": ("single", 1, 512, 4096, 24, True, False),
    "qkv_view_ragged": ("double", 1, 7, 34, 2, True, True),
}


@pytest.mark.parametrize("case", list(QK_NORM_ROPE_CASES))
def test_qk_norm_rope_matches_plain(dev, case):
    """The attention prologue kernel (qk_norm_rope) against its plain route
    at FLUX.1-dev's and schnell's joint lengths, a served batch-4 bucket, a
    tp rank's 12 heads, column views of a fused qkv_mlp / qkv projection and
    an odd token count: one launch; v bit for bit; q and k differ only where
    the sum of squares' order moves 1 / rms by an f32 ulp, at most 0.1% of
    their elements, each within :func:`_rotated_pairs_close`."""
    from diffusion_rs_tpu_torch.ops import rope

    kind, b, s_txt, s_img, heads, view, per_sample = QK_NORM_ROPE_CASES[case]
    n = heads * 128
    gen = torch.Generator(device=dev).manual_seed(len(case) * 1000 + s_img + heads)

    def columns(s):
        if not view:
            return tuple(torch.randn((b, s, n), generator=gen, device=dev).bfloat16()
                         for _ in range(3))
        width = 3 * n + (4 * n if kind == "single" else 0)
        fused = torch.randn((b, s, width), generator=gen, device=dev).bfloat16()
        return fused[..., :n], fused[..., n:2 * n], fused[..., 2 * n:3 * n]

    def scales():
        return tuple((0.5 + torch.rand(128, generator=gen, device=dev)).bfloat16()
                     for _ in range(2))

    rows = (s_txt, s_img) if kind == "double" else (s_txt + s_img,)
    streams = [(*columns(s), *scales()) for s in rows]
    ids = torch.randint(0, 128, (b if per_sample else 1, s_txt + s_img, 3), generator=gen,
                        device=dev)
    cos, sin = rope_tables(ids, (16, 56, 56))
    before = _cuda.launch_counts()["qk_norm_rope"]
    got = rope.qk_norm_rope(streams, cos, sin, heads)
    torch.cuda.synchronize()
    assert _cuda.launch_counts()["qk_norm_rope"] == before + 1
    want = rope.qk_norm_rope_plain(streams, cos, sin, heads)
    assert torch.equal(got[2], want[2])
    for x, y in zip(got[:2], want[:2]):
        assert x.shape == y.shape and x.is_contiguous()
        assert _rotated_pairs_close(x, y)
        assert float((x != y).float().mean()) <= 1e-3


def test_qk_norm_rope_refuses_on_card(dev):
    """On the card the prologue never gives way to its plain route: a head
    dim other than 128 raises NotImplementedError, f32 operands ValueError,
    an operand that requires grad under grad mode RuntimeError, each before
    any launch; the same bf16 operands under no_grad launch once."""
    from diffusion_rs_tpu_torch.ops import rope

    gen = torch.Generator(device=dev).manual_seed(18)

    def streams(head_dim, dtype):
        cols = tuple(torch.randn((1, 40, 2 * head_dim), generator=gen, device=dev).to(dtype)
                     for _ in range(3))
        return [(*cols, *(torch.ones(head_dim, device=dev, dtype=dtype) for _ in range(2)))]

    def tables(head_dim):
        ids = torch.randint(0, 64, (1, 40, 3), generator=gen, device=dev)
        return rope_tables(ids, (head_dim // 4, head_dim // 4, head_dim // 2))

    before = _cuda.launch_counts()
    with pytest.raises(NotImplementedError, match="qk_norm_rope"):
        rope.qk_norm_rope(streams(64, torch.bfloat16), *tables(64), 2)
    with pytest.raises(ValueError, match="qk_norm_rope"):
        rope.qk_norm_rope(streams(128, torch.float32), *tables(128), 2)
    grad = [tuple(t.requires_grad_(True) for t in streams(128, torch.bfloat16)[0])]
    with pytest.raises(RuntimeError, match="qk_norm_rope.*no backward"):
        rope.qk_norm_rope(grad, *tables(128), 2)
    assert _cuda.launch_counts() == before
    with torch.no_grad():
        rope.qk_norm_rope(grad, *tables(128), 2)
    assert _cuda.launch_counts()["qk_norm_rope"] == before["qk_norm_rope"] + 1


def test_flash_refuses_misaligned_slices_on_card(dev):
    """A column slice off 16-byte alignment, or rows whose stride is not a
    multiple of 16 bytes, raise before any launch."""
    x = torch.zeros((1, 64, 3 * 256 + 8), dtype=torch.bfloat16, device=dev)
    bad = x[..., 3:3 + 256]
    ok = x[..., 256:512]
    before = _cuda.launch_counts()
    with pytest.raises(ValueError, match="TMA"):
        flash.flash_sm(bad, ok, ok, 0.1)
    rows = torch.zeros((1, 64, 3 * 256 + 4), dtype=torch.bfloat16, device=dev)[..., :256]
    with pytest.raises(ValueError, match="TMA"):
        flash.flash_sm(ok, rows, ok, 0.1)
    assert _cuda.launch_counts() == before


@pytest.mark.parametrize("fmt", K4_FORMATS + ["q4_k_zero_scales"])
@pytest.mark.parametrize("fast16", [False, True])
def test_affine_decoded_weight_bit_for_bit(dev, fmt, fast16):
    """K4 / K13 through the identity give the plain decode (dequantize to
    bf16, or dequantize_fast16) bit for bit for every affine format, at a
    small-M plan (M 16) and a large one (M 768); a product of random x is
    within the summation-order bound."""
    k, n = 768, 384
    qt = (_q4_k_with_zero_scales(k, n, seed=7) if fmt == "q4_k_zero_scales"
          else _affine_qtensor(fmt, k, n, seed=7)).map(lambda t: t.to(dev))
    kern = qmatmul.qmm_affine_fast16 if fast16 else qmatmul.qmm_affine
    w = (qmatmul.dequantize_fast16(qt, torch.bfloat16) if fast16
         else dequantize(qt, torch.float32).to(torch.bfloat16))
    eye = torch.eye(k, device=dev, dtype=torch.bfloat16)
    assert float((kern(eye, qt, torch.bfloat16).float() - w.float()).abs().max()) == 0.0
    assert float((kern(eye[:16], qt, torch.bfloat16).float() - w[:16].float()).abs().max()) == 0.0
    gen = torch.Generator(device=dev).manual_seed(k)
    x = torch.randn((33, k), generator=gen, device=dev).bfloat16()
    y = kern(x, qt, torch.bfloat16)
    ref = (x.float() @ w.float()).bfloat16()
    assert _within_summation_order(y, ref, x, qt)


@pytest.mark.parametrize("kind", ["q8_0", "q4_0"])
@pytest.mark.parametrize("n", [18432, 9216])
@pytest.mark.parametrize("fast16", [False, True])
def test_affine_m1_modulation_shapes(dev, kind, n, fast16):
    """The M1 modulation products (K3072, N18432 and N9216): the m64n8k16
    plan, within the summation-order bound of the plain version, and one
    row equal to that row of an M 4608 product (192- or 256-row tiles)."""
    k = 3072
    gen = torch.Generator(device=dev).manual_seed(n)
    qt = random_qtensor(gen, k, n, kind=kind, device=dev)
    x = torch.randn((4608, k), generator=gen, device=dev).bfloat16()
    kern = qmatmul.qmm_affine_fast16 if fast16 else qmatmul.qmm_affine
    plain = qmatmul.qmm_dequant_fast16_plain if fast16 else qmatmul.qmm_dequant_plain
    assert qmatmul.qmm_plan("affine", 1, k, n, bits=qt.bits, split=qt.split,
                            group=qt.group).block_m == 8
    y1 = kern(x[:1], qt, torch.bfloat16)
    ref = plain(x[:1], qt, torch.bfloat16)
    assert _within_summation_order(y1, ref, x[:1], qt) if not fast16 else (
        _summed_rel(y1, ref) <= 1e-4)
    assert torch.equal(y1, kern(x, qt, torch.bfloat16)[:1])


@pytest.mark.parametrize("ms", [(17, 1, 64), (3, 40), (4096, 512), (300, 65, 1, 0)])
@pytest.mark.parametrize("kind", ["q8_0", "q4_0"])
def test_k8_affine_plans_match_per_group_k4(dev, ms, kind):
    """K8-affine with groups all under the small-M plan, at the double
    blocks' shape (img 4096 + txt 512, K3072 N3072) and with groups on both
    sides of it: each group's output equals K4 on that group alone (max-abs
    0), whatever tile height each of the two launches took."""
    k, n = 3072, 3072
    gen = torch.Generator(device=dev).manual_seed(sum(ms))
    qts = [random_qtensor(gen, k, n, kind=kind, device=dev) for _ in ms]
    xs = [torch.randn((m, k), generator=gen, device=dev).bfloat16() for m in ms]
    ys = qmatmul.qmm_grouped_affine(xs, qts, torch.bfloat16)
    for x, qt, y in zip(xs, qts, ys):
        assert torch.equal(y, qmatmul.qmm_affine(x, qt, torch.bfloat16))


def test_host_offload_resident_lands_on_card(dev):
    """HostOffload on the card: the host copy is pinned, ``resident`` puts
    an equal copy on the card (a non-blocking copy on the current stream),
    and ``release`` frees its bytes."""
    from diffusion_rs_tpu_torch.ops.linear import Linear
    from diffusion_rs_tpu_torch.parallel import HostOffload
    from diffusion_rs_tpu_torch.util.capacity import tree_device_bytes
    from diffusion_rs_tpu_torch.util.tree import tree_leaves

    gen = torch.Generator(device=dev).manual_seed(0)
    tree = {"lin": Linear(w=random_qtensor(gen, 1024, 2048, kind="q8t", device=dev),
                          b=torch.randn(2048, device=dev, generator=gen)),
            "norm": torch.randn(4096, device=dev, generator=gen).bfloat16()}
    off = HostOffload()
    host = off.register("flux", tree)
    assert all(t.device.type == "cpu" and t.is_pinned() for t in tree_leaves(host))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    on_card = off.resident("flux")
    for got, want in zip(tree_leaves(on_card), tree_leaves(tree)):
        assert got.device.type == "cuda" and torch.equal(got, want)
    assert torch.cuda.memory_allocated(dev) - before >= tree_device_bytes(tree)
    del got, on_card
    off.release("flux")
    assert torch.cuda.memory_allocated(dev) == before


def test_streamed_steps_equal_resident_on_card(dev, monkeypatch):
    """Two Euler steps of a tiny q8t FLUX with the blocks streamed through a
    two-slot ring (lookahead 1, where a slot-reuse race would show) equal
    the resident steps bit for bit, with the same kernel launches; the
    packed host buffers are pinned."""
    from diffusion_rs_tpu_torch.models.flux import FluxConfig, compute_pe, flux_forward
    from diffusion_rs_tpu_torch.models.flux_streaming import StreamedFlux
    from diffusion_rs_tpu_torch.pipelines.sampling import make_img_ids, make_txt_ids
    from diffusion_rs_tpu_torch.util.synthetic import init_flux_params_quantized

    monkeypatch.setenv("DIFFUSION_RS_TPU_STREAM_LOOKAHEAD", "1")
    cfg = FluxConfig(in_channels=64, pooled_projection_dim=64, joint_attention_dim=256,
                     num_attention_heads=2, num_layers=2, num_single_layers=3,
                     hidden_size=256)
    params = init_flux_params_quantized(0, cfg, kind="q8t", device=dev)
    sf = StreamedFlux(params, cfg, device=dev)
    assert all(b.is_pinned() for b in sf.dbl_bufs + sf.sgl_bufs)
    gen = torch.Generator(device=dev).manual_seed(1)
    img = torch.randn(1, 256, 64, device=dev, generator=gen)
    txt = torch.randn(1, 32, 256, device=dev, generator=gen).bfloat16()
    y = torch.randn(1, 64, device=dev, generator=gen).bfloat16()
    g = torch.full((1,), 3.5, device=dev)
    pe = compute_pe(cfg, make_txt_ids(1, 32, dev), make_img_ids(1, 16, 16, dev))
    sig = np.array([1.0, 0.6, 0.0], np.float32)

    def resident_step(x, tc, tp):
        t = torch.full((1,), float(tc), dtype=torch.float32, device=dev)
        pred = flux_forward(params, cfg, x.bfloat16(), txt, t, y, g, pe=pe)
        return x + pred.float() * float(tp - tc)

    counts = []
    outs = []
    for step in (resident_step, lambda x, tc, tp: sf.step(x, txt, tc, tp, y, g, pe)):
        _cuda.reset_launch_counts()
        x = img
        for tc, tp in zip(sig[:-1], sig[1:]):
            x = step(x, tc, tp)
        outs.append(x)
        counts.append(_cuda.launch_counts())
    assert counts[0] == counts[1] and counts[0]["qmm_s8"] > 0
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("mode", ["full", "stream"])
def test_offloading_pipeline_loads_onto_card(dev, tmp_path, mode):
    """``Pipeline(offloading=Full|Stream, device="cuda")`` from a tiny
    diffusers directory: under ``Stream`` the encoders and the VAE are on
    the card and the transformer's blocks in pinned host buffers, under
    ``Full`` every component's host copy is pinned; the latent equals the
    resident pipeline's bit for bit, with the same kernel launches."""
    from diffusion_rs_tpu_torch import DiffusionGenerationParams, ModelSource, Pipeline
    from diffusion_rs_tpu_torch.models.clip import ClipTextConfig
    from diffusion_rs_tpu_torch.models.flux import FluxConfig
    from diffusion_rs_tpu_torch.models.t5 import T5Config
    from diffusion_rs_tpu_torch.models.vae import VAEConfig
    from diffusion_rs_tpu_torch.pipelines.api import Offloading
    from diffusion_rs_tpu_torch.util.synthetic import write_diffusers_dir
    from diffusion_rs_tpu_torch.util.tree import tree_leaves

    cfgs = dict(
        flux_cfg=FluxConfig(in_channels=64, pooled_projection_dim=64, joint_attention_dim=256,
                            num_attention_heads=2, num_layers=1, num_single_layers=2,
                            hidden_size=256, axes_dim=(16, 56, 56)),
        t5_cfg=T5Config(vocab_size=512, d_model=256, d_kv=64, d_ff=512, num_layers=2,
                        num_heads=4),
        clip_cfg=ClipTextConfig(vocab_size=512, projection_dim=64, intermediate_size=128,
                                num_hidden_layers=2, num_attention_heads=4),
        vae_cfg=VAEConfig(block_out_channels=(32, 32, 32, 32), norm_num_groups=8))
    write_diffusers_dir(tmp_path, cfgs, seed=0)
    src = ModelSource.from_model_id(str(tmp_path))
    gen = DiffusionGenerationParams(height=64, width=64, num_steps=2, guidance_scale=3.5, seed=7)
    prompts = ["a photo of a cat"]
    lats, counts = [], []
    for offloading in (None, Offloading.Full if mode == "full" else Offloading.Stream):
        pipe = Pipeline(src, silent=True, offloading=offloading, device=dev)
        inner = pipe._inner
        if offloading is Offloading.Stream:
            assert inner.flux_params is None
            assert all(b.is_pinned() for b in inner.streamed.dbl_bufs + inner.streamed.sgl_bufs)
            for name in ("t5", "clip", "vae"):
                assert all(t.is_cuda for t in tree_leaves(getattr(inner, f"{name}_params")))
        elif offloading is Offloading.Full:
            for name in ("t5", "clip", "vae", "flux"):
                assert all(t.is_pinned() for t in tree_leaves(getattr(inner, f"{name}_params")))
        _cuda.reset_launch_counts()
        lats.append(pipe.forward_latents(prompts, gen))
        counts.append(_cuda.launch_counts())
    assert counts[0] == counts[1] and counts[0]["flash_fwd"] > 0
    assert np.array_equal(lats[0], lats[1])


def _tiny_cuda_pipeline(dev):
    """A tiny q8t FLUX pipeline on the card (T5 nf4, head dim 128)."""
    from diffusion_rs_tpu_torch import FluxPipeline
    from diffusion_rs_tpu_torch.models.clip import ClipTextConfig
    from diffusion_rs_tpu_torch.models.flux import FluxConfig
    from diffusion_rs_tpu_torch.models.t5 import T5Config
    from diffusion_rs_tpu_torch.models.vae import VAEConfig
    from diffusion_rs_tpu_torch.pipelines.scheduler import SchedulerConfig
    from diffusion_rs_tpu_torch.util import synthetic as syn

    cfgs = dict(
        flux_cfg=FluxConfig(in_channels=64, pooled_projection_dim=64, joint_attention_dim=256,
                            num_attention_heads=2, num_layers=1, num_single_layers=2,
                            hidden_size=256, axes_dim=(16, 56, 56)),
        t5_cfg=T5Config(vocab_size=512, d_model=256, d_kv=64, d_ff=512, num_layers=2,
                        num_heads=4),
        clip_cfg=ClipTextConfig(vocab_size=512, projection_dim=64, intermediate_size=128,
                                num_hidden_layers=2, num_attention_heads=4),
        vae_cfg=VAEConfig(block_out_channels=(32, 32, 32, 32), norm_num_groups=8))
    return FluxPipeline(
        flux_params=syn.init_flux_params_quantized(0, cfgs["flux_cfg"], kind="q8t", device=dev),
        t5_params=syn.init_t5_params_quantized(1, cfgs["t5_cfg"], kind="nf4", device=dev),
        clip_params=syn.init_clip_params(2, cfgs["clip_cfg"], device=dev),
        vae_params={**syn.init_vae_decoder_params(3, cfgs["vae_cfg"], device=dev),
                    **syn.init_vae_encoder_params(4, cfgs["vae_cfg"], device=dev)},
        scheduler=SchedulerConfig(use_dynamic_shifting=True),
        t5_tokenizer=syn.WordTokenizer(512), clip_tokenizer=syn.WordTokenizer(512),
        dtype=torch.bfloat16, device=dev, **cfgs)


def test_tiny_server_on_card(dev):
    """FluxServer on the card: three lanes (one img2img) share forwards at
    batch buckets 1-4; each image is within the JAX server's band of the
    offline image for its seed; K1 and K3 run a batch-1 step's count per
    forward and K2 once per encode."""
    from diffusion_rs_tpu_torch import DiffusionGenerationParams
    from diffusion_rs_tpu_torch.serving import FluxServer

    pipe = _tiny_cuda_pipeline(dev)
    init = np.random.default_rng(3).integers(0, 256, (64, 64, 3), dtype=np.uint8)

    def params(steps, seed):
        return DiffusionGenerationParams(height=64, width=64, num_steps=steps,
                                         guidance_scale=3.5, seed=seed)

    reqs = [("a cat", params(2, 1), {}), ("a dog", params(4, 2), {}),
            ("a fox", params(4, 9), dict(init_image=init, strength=0.5))]
    _cuda.reset_launch_counts()
    pipe.forward_arrays(["a cat"], params(2, 1))
    one = _cuda.launch_counts()
    per_step = {k: one[k] // 2 for k in ("qmm_s8", "flash_fwd", "qk_norm_rope")}
    server = FluxServer(pipe, max_batch=4, poll_ms=500.0)
    _cuda.reset_launch_counts()
    try:
        outs = [f.result(timeout=600) for f in [server.submit(p, gp, **kw)
                                                for p, gp, kw in reqs]]
    finally:
        server.shutdown()
    counts, s = _cuda.launch_counts(), server.stats()
    assert s["completed"] == 3 and s["failed"] == 0 and s["lane_steps"] == 2 + 4 + 2
    assert s["forwards"] < s["lane_steps"]
    for k, n in per_step.items():
        assert counts[k] == n * s["forwards"], (k, counts[k], n, s)
    assert counts["qmm_nf4"] == 3 * one["qmm_nf4"]
    for (p, gp, kw), got in zip(reqs, outs):
        want = pipe.forward_arrays([p], gp, **kw)[0]
        d = np.abs(got.astype(np.float32) - want.astype(np.float32))
        assert d.mean() < 1.0 and d.max() <= 16, (p, d.mean(), d.max())


def test_first_launches_race_from_two_threads(dev, tmp_path):
    """Two threads' first launches (K1 and K2) in a fresh process with an
    empty build directory: one build, no temporary left behind, both
    results equal to their plain versions, each launch counted."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import threading, torch\n"
        "from diffusion_rs_tpu_torch.ops import _cuda, qmatmul\n"
        "from diffusion_rs_tpu_torch.util.synthetic import random_qtensor\n"
        "g = torch.Generator(device='cuda').manual_seed(0)\n"
        "qs = random_qtensor(g, 1024, 512, kind='q8t', device='cuda')\n"
        "qn = random_qtensor(g, 1024, 512, kind='nf4', device='cuda')\n"
        "x = torch.randn((64, 1024), generator=g, device='cuda').bfloat16()\n"
        "builds, out, go = [], {}, threading.Barrier(2)\n"
        "real = _cuda.build_all\n"
        "_cuda.build_all = lambda: builds.append(1) or real()\n"
        "def run(name, fn, qt):\n"
        "    go.wait()\n"
        "    out[name] = fn(x, qt, torch.bfloat16)\n"
        "ts = [threading.Thread(target=run, args=a) for a in\n"
        "      (('s8', qmatmul.qmm_s8, qs), ('nf4', qmatmul.qmm_nf4, qn))]\n"
        "[t.start() for t in ts]; [t.join(600) for t in ts]\n"
        "torch.cuda.synchronize()\n"
        "assert builds == [1], builds\n"
        "assert torch.equal(out['s8'], qmatmul.qmm_s8_plain(x, qs.packed, qs.scale,\n"
        "                                                   torch.bfloat16))\n"
        "ref = qmatmul.qmm_dequant_plain(x, qn, torch.bfloat16)\n"
        "assert (out['nf4'].float() - ref.float()).abs().max() < 0.1\n"
        "c = _cuda.launch_counts()\n"
        "assert c['qmm_s8'] == 1 and c['qmm_nf4'] == 1, c\n"
        "left = sorted(p.name for p in _cuda.BUILD_DIR.iterdir() if '.tmp' in p.name)\n"
        "assert not left, left\n"
        "assert all(_cuda._lib_path(n).exists() for n in _cuda.SOURCES)\n"
    )
    env = dict(os.environ, DIFFUSION_RS_TORCH_BUILD=str(tmp_path / "build"))
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                       timeout=900, cwd=Path(__file__).resolve().parents[1])
    assert r.returncode == 0, r.stdout + r.stderr

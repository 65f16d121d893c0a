"""Parity of the port's load-time layout transforms (models/optimize.py) and
the FLUX / T5 paths they open, with the JAX package.

The transforms must give the port the same trees the JAX package makes,
bit for bit (the JAX tree carried over by the bridge), for dense bf16, q8t
and q4_0 stacked weights. The tiny FLUX forward (hidden 256, 2 heads of 128,
so every seq-major and grouped path takes its full-size dispatch) runs each
fuse subset, the grouped double blocks and the half-split RoPE layouts
against the JAX forward with Pallas in interpret mode, within the FLUX
forward bands of tests/test_torch_models.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_rs_tpu.models import flux as jflux
from diffusion_rs_tpu.models import optimize as jopt
from diffusion_rs_tpu.models import t5 as jt5
from diffusion_rs_tpu.ops.linear import Linear as JLinear
from diffusion_rs_tpu.quant import bnb as jbnb
from diffusion_rs_tpu.quant import qtensor as jq
from diffusion_rs_tpu_torch.models import flux as tflux
from diffusion_rs_tpu_torch.models import optimize as topt
from diffusion_rs_tpu_torch.models import t5 as tt5
from diffusion_rs_tpu_torch.ops.linear import Linear as TLinear
from diffusion_rs_tpu_torch.quant import qtensor as tqt
from test_torch_loader import assert_trees_equal
from test_torch_models import JFLUX_TINY, TFLUX_TINY, _flux_inputs
from torch_port_util import (  # noqa: F401
    jax_kernels_interpreted, port_params, quantize_tree, summed_rel, to_np)

QUANTIZERS = {"q8t": jq.quantize_q8_tile, "q4_0": jq.quantize_q4_0}
KINDS = ["bf16", "q8t", "q4_0"]
STREAMS = [("img",), ("txt",), ("single",), ("img", "txt", "single")]


@functools.lru_cache(None)
def _jax_flux(kind: str, dtype: str = "bfloat16"):
    """The tiny FLUX tree in the JAX package: dense, or every linear
    quantized (biases small random values)."""
    jp = jflux.init_flux_params(jax.random.PRNGKey(0), JFLUX_TINY)
    if kind == "bf16":
        return jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    return quantize_tree(jp, QUANTIZERS[kind], getattr(jnp, dtype))


@pytest.mark.parametrize("kind", ["q8t", "q4_0"])
def test_permute_n_matches_jax(rng, kind):
    """2-D and stacked [L, K, N] planes, permuted column for column."""
    ws = (rng.standard_normal((3, 256, 384)) * 0.05).astype(np.float32)
    jqts = [QUANTIZERS[kind](w) for w in ws]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *jqts)
    idx = rng.permutation(384)
    for jqt in (jqts[0], stacked):
        t = tqt.permute_n(port_params(jqt), idx)
        assert_trees_equal(t, port_params(jq.permute_n(jqt, idx)))
        assert t.shape == (256, 384)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("streams", STREAMS, ids="+".join)
def test_fuse_flux_qkv_matches_jax(kind, streams):
    jp = _jax_flux(kind)
    fused = topt.fuse_flux_qkv(port_params(jp), streams)
    assert_trees_equal(fused, port_params(jopt.fuse_flux_qkv(jp, streams)))
    assert ("qkv" in fused["double"]["img_attn"]) == ("img" in streams)
    assert ("qkv_mlp" in fused["single"]) == ("single" in streams)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fused", [False, True])
def test_rope_halfsplit_permute_matches_jax(kind, fused):
    """Separate q/k or fused qkv / qkv_mlp columns, and the QK-norm scales."""
    jp = _jax_flux(kind)
    if fused:
        jp = jopt.fuse_flux_qkv(jp)
    tp = topt.rope_halfsplit_permute(port_params(jp), TFLUX_TINY)
    assert_trees_equal(tp, port_params(jopt.rope_halfsplit_permute(jp, JFLUX_TINY)))


T5_TINY = dict(vocab_size=64, d_model=256, d_kv=64, d_ff=512, num_layers=2, num_heads=4,
               relative_attention_num_buckets=8, relative_attention_max_distance=16)


def _jax_t5(kind: str):
    jp = jt5.init_t5_params(jax.random.PRNGKey(0), jt5.T5Config(**T5_TINY), dtype=jnp.float32)
    if kind == "nf4":
        return quantize_tree(jp, lambda w: jbnb.quantize_nf4(np.ascontiguousarray(w.T)),
                             jnp.float32)
    if kind == "bf16":
        return jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    return quantize_tree(jp, QUANTIZERS[kind], jnp.float32)


@pytest.mark.parametrize("kind", KINDS)
def test_fuse_t5_matches_jax(kind):
    jp = _jax_t5(kind)
    fused = topt.fuse_t5(port_params(jp))
    assert "qkv" in fused["blocks"]["attn"] and "wi01" in fused["blocks"]["ff"]
    assert_trees_equal(fused, port_params(jopt.fuse_t5(jp)))


def test_fused_t5_encode_matches_jax(jax_kernels_interpreted):
    """nf4 (K2's dispatch) fused T5 in f32: the port's fused encode against
    the JAX package's fused encode, and equal to the port's unfused one."""
    jp = jopt.fuse_t5(_jax_t5("nf4"))
    cfg_j, cfg_t = jt5.T5Config(**T5_TINY), tt5.T5Config(**T5_TINY)
    ids = np.random.default_rng(3).integers(0, 64, size=(2, 16)).astype(np.int32)
    out_j = np.asarray(jt5.t5_encode(jp, cfg_j, jnp.asarray(ids)))
    tp = port_params(jp)
    out_t = tt5.t5_encode(tp, cfg_t, torch.from_numpy(ids))
    assert summed_rel(to_np(out_t), out_j) <= 1e-5
    unfused = tt5.t5_encode(port_params(_jax_t5("nf4")), cfg_t, torch.from_numpy(ids))
    assert torch.equal(out_t, unfused)


@pytest.mark.parametrize("case", ["mixed", "lora", "bias"])
def test_fuse_refusals_match_jax(case):
    """Mixed dense/quantized weights, runtime LoRA terms and mixed bias
    presence raise ValueError in both packages."""
    w = np.random.default_rng(0).standard_normal((256, 128)).astype(np.float32)
    jd = JLinear(w=jnp.asarray(w), b=jnp.zeros(128))
    jlins = {
        "mixed": [jd, JLinear(w=jq.quantize_q8_tile(w), b=jnp.zeros(128))],
        "lora": [jd, JLinear(w=jnp.asarray(w), b=jnp.zeros(128),
                             lora=(jnp.ones((256, 2)), jnp.ones((2, 128))))],
        "bias": [jd, JLinear(w=jnp.asarray(w))],
    }[case]
    with pytest.raises(ValueError):
        jopt._fuse_linears(jlins)
    with pytest.raises(ValueError):
        topt._fuse_linears([port_params(l) for l in jlins])
    assert isinstance(port_params(jlins[0]), TLinear)


def _forward(jp, jcfg, tcfg, dtype, inputs):
    """(JAX output, port output) of the tiny FLUX forward."""
    img, txt, t, y, g, txt_ids, img_ids = inputs
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    out_j = jflux.flux_forward(
        jp, jcfg, jnp.asarray(img, jd), jnp.asarray(txt, jd), jnp.asarray(t),
        jnp.asarray(y, jd), jnp.asarray(g), txt_ids=jnp.asarray(txt_ids),
        img_ids=jnp.asarray(img_ids))
    out_t = tflux.flux_forward(
        port_params(jp), tcfg, torch.from_numpy(img).to(td), torch.from_numpy(txt).to(td),
        torch.from_numpy(t), torch.from_numpy(y).to(td), torch.from_numpy(g),
        txt_ids=torch.from_numpy(txt_ids), img_ids=torch.from_numpy(img_ids))
    assert tuple(out_t.shape) == (1, 16, 64) and out_t.dtype == td
    return np.asarray(out_j, np.float32), to_np(out_t)


def _layout(kind, dtype, streams, grouped=False, rope=False):
    """The JAX tree and both configs after the loader's transforms, in its
    order: fusion (grouped adds img and txt), then the half-split
    re-layout."""
    jp = _jax_flux(kind, dtype)
    if grouped:
        streams = tuple(dict.fromkeys(streams + ("img", "txt")))
    jp = jopt.fuse_flux_qkv(jp, streams)
    over = dict(grouped_qmm=grouped, rope_fused=rope)
    if rope:
        jp = jopt.rope_halfsplit_permute(jp, JFLUX_TINY)
    return (jp, dataclasses.replace(JFLUX_TINY, **over),
            dataclasses.replace(TFLUX_TINY, **over))


@pytest.mark.parametrize("streams", STREAMS, ids="+".join)
def test_fused_forward_f32_matches_jax(rng, jax_kernels_interpreted, streams):
    """Each fuse subset of a q8t tree in f32: the near-exact band of
    tests/test_torch_models.py (1e-5)."""
    out_j, out_t = _forward(*_layout("q8t", "float32", streams), "float32",
                            _flux_inputs(rng))
    assert summed_rel(out_t, out_j) <= 1e-5


@pytest.mark.parametrize("kind", ["q8t", "q4_0"])
@pytest.mark.parametrize("layout", ["bhsd", "seqmajor", "inkernel"])
def test_rope_fused_grouped_forward_f32_matches_jax(rng, jax_kernels_interpreted,
                                                     monkeypatch, kind, layout):
    """Grouped double blocks (K8's dispatch: s8 for q8t, affine for q4_0) and
    half-split RoPE under each DIFFUSION_RS_TPU_ATTN_LAYOUT (K3, K6 or K7's
    plain version here; JAX's Pallas kernels in interpret mode), f32."""
    monkeypatch.setenv("DIFFUSION_RS_TPU_ATTN_LAYOUT", layout)
    out_j, out_t = _forward(*_layout(kind, "float32", ("single",), grouped=True, rope=True),
                            "float32", _flux_inputs(rng))
    assert summed_rel(out_t, out_j) <= 1e-5


def test_rope_fused_grouped_forward_bf16_as_close_as_jax(rng, jax_kernels_interpreted,
                                                         monkeypatch):
    """bf16, the working dtype, every option at once (every stream fused,
    grouped, in-kernel RoPE): the band of tests/test_torch_models.py,
    against the f32 forward of the same layout."""
    monkeypatch.setenv("DIFFUSION_RS_TPU_ATTN_LAYOUT", "inkernel")
    inputs = _flux_inputs(rng)
    streams = ("img", "txt", "single")
    ref, _ = _forward(*_layout("q8t", "float32", streams, True, True), "float32", inputs)
    out_j, out_t = _forward(*_layout("q8t", "bfloat16", streams, True, True), "bfloat16",
                            inputs)
    assert summed_rel(out_t, ref) <= 1.25 * summed_rel(out_j, ref)
    assert summed_rel(out_t, out_j) <= 3e-2


def test_rope_fused_matches_interleaved_port(rng, monkeypatch):
    """Within the port: the half-split re-layout leaves the forward as it
    was (attention is invariant under the shared q/k permutation), for
    each layout, in f32 (JAX's own test allows 5e-4)."""
    img, txt, t, y, g, txt_ids, img_ids = (torch.from_numpy(a) for a in _flux_inputs(rng))
    tp = port_params(_jax_flux("q8t", "float32"))
    base = tflux.flux_forward(tp, TFLUX_TINY, img, txt, t, y, g, txt_ids, img_ids)
    pp = topt.rope_halfsplit_permute(tp, TFLUX_TINY)
    cfg = dataclasses.replace(TFLUX_TINY, rope_fused=True)
    for layout in ("bhsd", "seqmajor", "inkernel"):
        monkeypatch.setenv("DIFFUSION_RS_TPU_ATTN_LAYOUT", layout)
        out = tflux.flux_forward(pp, cfg, img, txt, t, y, g, txt_ids, img_ids)
        assert summed_rel(to_np(out), to_np(base)) <= 1e-5, layout

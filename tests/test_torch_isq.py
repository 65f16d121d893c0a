"""In-situ quantization (ISQ), imatrix files and the capacity accounting of
the port against the JAX package (quant/isq.py, io/imatrix.py,
util/capacity.py), and ``Pipeline(isq=, isq_t5=, imatrix=, lora=)`` against
the JAX ``Pipeline`` on tests/synth.py checkpoints.

The port quantizes with torch on the weight's device (here the CPU); the
JAX package encodes GGML bytes in numpy and canonicalizes them. Codes, scale
planes and bias planes must be equal. The imatrix refinement sums each
group in numpy's order, so it is expected equal too; its stated band (for
another device's reductions) is at most 0.1% of the codes moved and an
importance-weighted error within 1e-3 of the JAX package's, far inside the
weighted-vs-unweighted gap that tests/test_isq.py relies on.
"""

import importlib
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_rs_tpu import DiffusionGenerationParams as JParams
from diffusion_rs_tpu import ModelDType as JDType
from diffusion_rs_tpu import ModelSource as JSource
from diffusion_rs_tpu import Pipeline as JPipeline
from diffusion_rs_tpu.io import imatrix as jimatrix
from diffusion_rs_tpu.models.flux import FluxConfig as JFluxConfig
from diffusion_rs_tpu.models.flux import init_flux_params as j_init_flux
from diffusion_rs_tpu.models.t5 import T5Config as JT5Config
from diffusion_rs_tpu.models.t5 import init_t5_params as j_init_t5
from diffusion_rs_tpu.pipelines.sampling import get_noise as j_get_noise
from diffusion_rs_tpu.quant import isq as jisq
from diffusion_rs_tpu.quant.qtensor import dequantize as j_dequantize
from diffusion_rs_tpu.util import capacity as jcap
from diffusion_rs_tpu_torch.io import imatrix as timatrix
from diffusion_rs_tpu_torch.ops.linear import Linear
from diffusion_rs_tpu_torch.pipelines.api import ModelDType as TDType
from diffusion_rs_tpu_torch.pipelines.api import ModelSource as TSource
from diffusion_rs_tpu_torch.pipelines.api import Pipeline as TPipeline
from diffusion_rs_tpu_torch.pipelines.flux_pipeline import DiffusionGenerationParams as TParams
from diffusion_rs_tpu_torch.pipelines.loader import apply_weight_options
from diffusion_rs_tpu_torch.quant import isq as tisq
from diffusion_rs_tpu_torch.quant.qtensor import QuantizedTensor, dequantize
from diffusion_rs_tpu_torch.util import capacity as tcap
from synth import FLUX_HIDDEN, write_checkpoint
from torch_port_util import jax_kernels_interpreted, port_params, summed_rel  # noqa: F401

TARGETS = list(jisq.SUPPORTED)
CODE_MOVE_BAND = 1e-3     # share of codes another order may move at a tie
WEIGHTED_ERR_BAND = 1e-3  # relative importance-weighted error difference


def _weight(seed: int, k: int = 512, n: int = 384) -> np.ndarray:
    """Gaussian weight with an all-zero block, a block below f16's range
    (k-quant d underflows) and one of small negative values (d underflows,
    dmin does not: the s == 0, b != 0 groups)."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) * 0.03).astype(np.float32)
    w[:256, :5] = 0.0
    w[256:, 5:9] = rng.standard_normal((k - 256, 4)).astype(np.float32) * 1e-9
    w[:256, 9:13] = rng.uniform(-4e-6, -2e-6, size=(256, 4)).astype(np.float32)
    return w


def _importance(seed: int, k: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    imp = np.full(k, 0.01, np.float32)
    imp[rng.choice(k, k // 16, replace=False)] = 10.0
    return imp * rng.uniform(0.5, 1.5, size=k).astype(np.float32)


def _codes(qt) -> np.ndarray:
    from diffusion_rs_tpu_torch.quant.qtensor import unpack4

    p = qt.packed
    return (unpack4(p, qt.split) if qt.bits == 4 else p).numpy().astype(np.int32)


def _assert_qt_equal(t: QuantizedTensor, j) -> None:
    assert (t.kind, t.bits, t.group, t.split, tuple(t.shape), t.out_dtype) == (
        j.kind, j.bits, j.group, j.split, tuple(j.shape), j.out_dtype)
    np.testing.assert_array_equal(t.packed.numpy(), np.asarray(j.packed))
    np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))
    assert (t.bias is None) == (j.bias is None)
    if t.bias is not None:
        np.testing.assert_array_equal(t.bias.numpy(), np.asarray(j.bias))
    assert (t.codebook is None) == (j.codebook is None)
    if t.codebook is not None:
        np.testing.assert_array_equal(t.codebook.numpy(), np.asarray(j.codebook))


@pytest.mark.parametrize("target", TARGETS)
def test_isq_quantize_weight_matches_jax(target):
    """Every target: the device quantizer's codes, scale and bias planes
    equal the JAX package's GGML-bytes-then-canonical result."""
    w = _weight(1)
    _assert_qt_equal(tisq.isq_quantize_weight(torch.from_numpy(w), target),
                     jisq.isq_quantize_weight(w, target))


@pytest.mark.parametrize("kind", ["nf4", "fp4"])
def test_bnb_encoders_match_jax(kind):
    """The host encoders (bnb byte layout, canonical nf4 / fp4) give JAX's
    bytes and planes, and the device encoder ISQ uses gives the same
    canonical tensor."""
    from diffusion_rs_tpu.quant import bnb as jbnb
    from diffusion_rs_tpu_torch.quant import bnb as tbnb

    w = np.ascontiguousarray(_weight(4).T)  # torch layout [out, in]
    jp, ja = jbnb.quantize_4bit_bnb_layout(w, 64, kind)
    tp_, ta = tbnb.quantize_4bit_bnb_layout(w, 64, kind)
    np.testing.assert_array_equal(tp_, jp)
    np.testing.assert_array_equal(ta, ja)
    enc = {"nf4": (tbnb.quantize_nf4, jbnb.quantize_nf4),
           "fp4": (tbnb.quantize_fp4, jbnb.quantize_fp4)}[kind]
    j = enc[1](w)
    _assert_qt_equal(enc[0](w), j)
    _assert_qt_equal(tbnb.quantize_4bit_canonical(torch.from_numpy(w.T.copy()), kind), j)


@pytest.mark.parametrize("target", TARGETS)
def test_refine_with_imatrix_within_band(target):
    """The importance-weighted refinement against JAX's: codes moved and the
    weighted error within their bands (measured: equal, every target), both
    far inside the gap between weighted and unweighted quantization."""
    w = _weight(2)
    imp = _importance(3, w.shape[0])
    t = tisq.isq_quantize_weight(torch.from_numpy(w), target, imatrix=imp)
    j = jisq.isq_quantize_weight(w, target, imatrix=imp)
    moved = float((_codes(t) != _codes(port_params(j, "cpu"))).mean())
    assert moved <= CODE_MOVE_BAND

    def werr(w_hat):
        return float((imp[:, None] * (w - w_hat) ** 2).sum())

    e_t = werr(dequantize(t, torch.float32).numpy())
    e_j = werr(np.asarray(j_dequantize(j, jnp.float32)))
    e_plain = werr(np.asarray(j_dequantize(jisq.isq_quantize_weight(w, target), jnp.float32)))
    assert abs(e_t - e_j) <= WEIGHTED_ERR_BAND * e_j
    assert e_j < e_plain and (e_plain - e_j) > 10 * WEIGHTED_ERR_BAND * e_j


def _assert_trees_equal(t, j_as_port) -> None:
    if isinstance(t, dict):
        assert sorted(t) == sorted(j_as_port)
        for key in t:
            _assert_trees_equal(t[key], j_as_port[key])
    elif isinstance(t, Linear):
        assert isinstance(t.w, QuantizedTensor) == isinstance(j_as_port.w, QuantizedTensor)
        _assert_trees_equal(t.w, j_as_port.w)
        _assert_trees_equal(t.b, j_as_port.b)
        assert (t.lora is None) == (j_as_port.lora is None)
        for x, y in zip(t.lora or (), j_as_port.lora or ()):
            assert torch.equal(x, y)
    elif isinstance(t, QuantizedTensor):
        assert (t.kind, t.bits, t.group, t.split, tuple(t.shape)) == (
            j_as_port.kind, j_as_port.bits, j_as_port.group, j_as_port.split,
            tuple(j_as_port.shape))
        for f in ("packed", "scale", "bias", "codebook"):
            a, b = getattr(t, f), getattr(j_as_port, f)
            assert (a is None and b is None) or torch.equal(a, b), f
    elif t is None:
        assert j_as_port is None
    elif t.is_floating_point():
        # dense weights: a fused LoRA delta's rank-r sum may round last
        # bits otherwise (numpy's matmul against torch's)
        assert t.dtype == j_as_port.dtype
        assert torch.allclose(t, j_as_port, rtol=1e-6, atol=1e-7)
    else:
        assert torch.equal(t, j_as_port)


def _tiny_flux_cfg():
    return dict(in_channels=64, pooled_projection_dim=64, joint_attention_dim=256,
                num_attention_heads=2, num_layers=2, num_single_layers=2,
                hidden_size=256, axes_dim=(16, 56, 56))


def _tiny_trees():
    jf = j_init_flux(jax.random.PRNGKey(0), JFluxConfig(**_tiny_flux_cfg()), jnp.float32)
    jt = j_init_t5(jax.random.PRNGKey(1), JT5Config(vocab_size=64, d_model=256, d_kv=64,
                                                     d_ff=512, num_layers=2, num_heads=4))
    return jf, jt


def _linear_names(tree, prefix=()):
    """(dotted name, stacked) of every Linear of a JAX tree."""
    from diffusion_rs_tpu.ops.linear import Linear as JLinear

    out = []
    for key, v in tree.items():
        if isinstance(v, JLinear):
            out.append((".".join(prefix + (key,)), np.asarray(v.w).ndim == 3,
                        np.asarray(v.w).shape[-2]))
        elif isinstance(v, dict):
            out += _linear_names(v, prefix + (key,))
    return out


@pytest.mark.parametrize("target,min_env", [("q4_k", "256"), ("q8_0", "512"), ("nf4", "64"),
                                            ("q8t", "256")])
def test_isq_tree_matches_jax(monkeypatch, target, min_env):
    """isq_tree on the tiny FLUX and T5 trees: the same linears quantized
    (DIFFUSION_RS_TPU_ISQ_MIN and the K divisor gate alike, stacked weights
    layer by layer) with equal planes; the rest left dense."""
    monkeypatch.setenv("DIFFUSION_RS_TPU_ISQ_MIN", min_env)
    for jtree in _tiny_trees():
        want = port_params(jisq.isq_tree(jtree, target), "cpu")
        got = tisq.isq_tree(port_params(jtree, "cpu"), target)
        _assert_trees_equal(got, want)
        n_q = sum(isinstance(v.w, QuantizedTensor) for v in _walk_linears(got))
        assert (n_q > 0) == (min_env != "512")


def _walk_linears(tree):
    if isinstance(tree, Linear):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _walk_linears(v)


def test_isq_tree_requantizes_nf4_to_q8t_like_jax():
    """nf4 FLUX weights with an explicit q8t target are requantized from
    their f32 dequantization, layer by layer (stacked planes); an nf4
    target leaves them as they are, in both packages."""
    jf, _ = _tiny_trees()
    jnf4 = jisq.isq_tree(jf, "nf4", min_features=64)
    tnf4 = port_params(jnf4, "cpu")
    got = tisq.isq_tree(tnf4, "q8t", min_features=64)
    _assert_trees_equal(got, port_params(jisq.isq_tree(jnf4, "q8t", min_features=64), "cpu"))
    assert got["double"]["img_attn"]["q"].w.kind == "q8t"
    assert got["double"]["img_attn"]["q"].w.packed.shape == (2, 256, 256)
    same = tisq.isq_tree(tnf4, "nf4", min_features=64)
    assert same["double"]["img_attn"]["q"] is tnf4["double"]["img_attn"]["q"]


def test_imatrix_names_refine_the_same_linears():
    """The same imatrix (per-layer keys, whole-stack keys, ``.weight``
    suffixes, a wrong-length vector) refines the same linears with the same
    planes in both packages."""
    jf, jt = _tiny_trees()
    rng = np.random.default_rng(4)
    imat = {}
    for name, stacked, k in _linear_names(jf):
        if stacked:
            head, _, rest = name.partition(".")
            imat[f"{head}.0.{rest}.weight"] = _importance(len(imat), k)
            imat[f"{head}.1.{rest}"] = _importance(len(imat), k)
        else:
            imat[name] = _importance(len(imat), k)
    imat["txt_in"] = rng.uniform(0.1, 1.0, size=7).astype(np.float32)  # wrong length
    for name, _, k in _linear_names(jt):
        imat[name + ".weight"] = _importance(len(imat), k)
    for jtree in (jf, jt):
        want = jisq.isq_tree(jtree, "q4_0", min_features=64, imatrix=imat)
        got = tisq.isq_tree(port_params(jtree, "cpu"), "q4_0", min_features=64, imatrix=imat)
        _assert_trees_equal(got, port_params(want, "cpu"))
    plain = tisq.isq_tree(port_params(jf, "cpu"), "q4_0", min_features=64)
    refined = tisq.isq_tree(port_params(jf, "cpu"), "q4_0", min_features=64, imatrix=imat)
    assert not torch.equal(plain["double"]["img_attn"]["q"].w.scale,
                           refined["double"]["img_attn"]["q"].w.scale)
    assert torch.equal(plain["txt_in"].w.scale, refined["txt_in"].w.scale)


@pytest.mark.parametrize("ncall", [0, 16])
def test_imatrix_files_match_jax(tmp_path, ncall):
    """save_imatrix writes JAX's bytes; each package reads the other's file."""
    rng = np.random.default_rng(ncall)
    data = {"double.0.img_attn.q.weight": rng.uniform(0.1, 2, 256).astype(np.float32),
            "txt_in": rng.uniform(0.1, 2, 64).astype(np.float32)}
    timatrix.save_imatrix(str(tmp_path / "t.dat"), data, ncall=ncall)
    jimatrix.save_imatrix(str(tmp_path / "j.dat"), data, ncall=ncall)
    assert (tmp_path / "t.dat").read_bytes() == (tmp_path / "j.dat").read_bytes()
    a = timatrix.load_imatrix(str(tmp_path / "j.dat"))
    b = jimatrix.load_imatrix(str(tmp_path / "t.dat"))
    assert list(a) == list(b) == list(data)
    for key in data:
        np.testing.assert_array_equal(a[key], b[key])


def test_capacity_bytes_match_jax(monkeypatch):
    """tree_device_bytes, estimate_isq_tree_bytes and the activation
    estimate give JAX's integers on the same trees (dense, quantized,
    stacked, with LoRA terms)."""
    monkeypatch.setenv("DIFFUSION_RS_TPU_ISQ_MIN", "256")
    jf, jt = _tiny_trees()
    jq = jisq.isq_tree(jf, "nf4", min_features=64)
    for jtree in (jf, jt, jq):
        ttree = port_params(jtree, "cpu")
        assert tcap.tree_device_bytes(ttree) == jcap.tree_device_bytes(jtree)
        for target in ("q4_k", "q8t", "nf4", "bogus"):
            assert (tcap.estimate_isq_tree_bytes(ttree, target)
                    == jcap.estimate_isq_tree_bytes(jtree, target))
    for args in ((1, 4096, 512, 3072), (8, 4096, 256, 3072), (2, 64, 16, 64)):
        assert (tcap.estimate_denoise_activation_bytes(*args)
                == jcap.estimate_denoise_activation_bytes(*args))


@pytest.mark.parametrize("budget", ["weights/2", "weights+act/2", "weights+act*2"])
def test_denoise_capacity_decides_like_jax(monkeypatch, budget):
    """With DIFFUSION_RS_TPU_HBM_BYTES set on both sides, the check raises,
    warns or passes alike."""
    jf, _ = _tiny_trees()
    tf = port_params(jf, "cpu")
    w = jcap.tree_device_bytes(jf)
    act = jcap.estimate_denoise_activation_bytes(1, 64, 16, 256)
    hbm = {"weights/2": w // 2, "weights+act/2": w + act // 2,
           "weights+act*2": w + 2 * act}[budget]
    monkeypatch.setenv("DIFFUSION_RS_TPU_HBM_BYTES", str(hbm))
    kw = dict(batch=1, img_tokens=64, txt_tokens=16, hidden=256)
    if budget == "weights/2":
        for check in (lambda: jcap.check_denoise_capacity(jf, **kw),
                      lambda: tcap.check_denoise_capacity(tf, device="cpu", **kw)):
            with pytest.raises(ValueError, match="cannot fit"):
                check()
    else:
        j_msg = jcap.check_denoise_capacity(jf, **kw)
        t_msg = tcap.check_denoise_capacity(tf, device="cpu", **kw)
        assert (j_msg is None) == (t_msg is None) == (budget == "weights+act*2")


def test_hbm_budget_needs_the_card_or_the_override(monkeypatch):
    monkeypatch.setenv("DIFFUSION_RS_TPU_HBM_BYTES", str(3 * 1024 ** 3))
    assert tcap.per_chip_hbm_bytes("cpu") == 3 * 1024 ** 3
    monkeypatch.delenv("DIFFUSION_RS_TPU_HBM_BYTES")
    with pytest.raises(ValueError, match="DIFFUSION_RS_TPU_HBM_BYTES"):
        tcap.per_chip_hbm_bytes("cpu")


@pytest.mark.parametrize("case", ["fits", "over", "forced"])
def test_t5_guard_decides_like_jax(monkeypatch, caplog, case):
    """The loader's T5 capacity guard: nf4 T5 with isq='q8_0' (a larger
    format) is kept in nf4 when FLUX + the T5 estimate exceed 92% of the
    budget, with a warning, as the JAX guard's formula decides on the JAX
    trees; a large budget, or isq_t5=, requantizes it."""
    from diffusion_rs_tpu_torch.models.flux import FluxConfig
    from diffusion_rs_tpu_torch.util import tracing

    jf, jt = _tiny_trees()
    jt_nf4 = jisq.isq_tree(jt, "nf4", min_features=64)
    monkeypatch.setenv("DIFFUSION_RS_TPU_ISQ_MIN", "64")
    flux_b = jcap.tree_device_bytes(jisq.isq_tree(jf, "q8_0"))
    t5_isq = jcap.estimate_isq_tree_bytes(jt_nf4, "q8_0")
    hbm = (flux_b + t5_isq) * (4 if case in ("fits", "forced") else 1)
    monkeypatch.setenv("DIFFUSION_RS_TPU_HBM_BYTES", str(hbm))
    jax_keeps = (flux_b + t5_isq > int(0.92 * hbm)
                 and jcap.tree_device_bytes(jt_nf4) < t5_isq)
    assert jax_keeps == (case == "over")
    tracing._warned.discard("isq-t5-capacity")
    with caplog.at_level(logging.WARNING, logger="diffusion_rs_tpu_torch"):
        _, t5 = apply_weight_options(port_params(jf, "cpu"), FluxConfig(**_tiny_flux_cfg()),
                                     port_params(jt_nf4, "cpu"), isq="q8_0",
                                     isq_t5="q8_0" if case == "forced" else None)
    kind = t5["blocks"]["attn"]["q"].w.kind
    assert kind == ("nf4" if case == "over" else "q8_0")
    assert any("keeping T5" in r.message for r in caplog.records) == (case == "over")


def test_imatrix_and_isq_t5_need_isq(tmp_path):
    """As in the JAX loader, ``imatrix`` and ``isq_t5`` without ``isq`` do
    nothing (the imatrix file is not even opened)."""
    from diffusion_rs_tpu_torch.models.flux import FluxConfig

    jf, jt = _tiny_trees()
    tf, tt = port_params(jf, "cpu"), port_params(jt, "cpu")
    f2, t2 = apply_weight_options(tf, FluxConfig(**_tiny_flux_cfg()), tt, isq_t5="q8_0",
                                  imatrix=str(tmp_path / "missing.dat"))
    assert f2 is tf and t2 is tt


# -- Pipeline(isq=, isq_t5=, imatrix=, lora=) against the JAX Pipeline ----------

PSNR_FLOOR = 42.0  # tests/test_quality_gate.py
LATENT_BAND = 2e-5  # tests/test_torch_load_pipeline.py: f32 summation orders only
GEN = dict(height=64, width=64, num_steps=2, guidance_scale=3.5, seed=42)
PROMPTS = ["a photo of a cat"]


@pytest.fixture
def same_noise(monkeypatch):
    tpl = importlib.import_module("diffusion_rs_tpu_torch.pipelines.flux_pipeline")

    def jax_noise(seed, n, h, w, device):
        return torch.from_numpy(np.array(j_get_noise(jax.random.PRNGKey(seed), n, h, w)))

    monkeypatch.setattr(tpl, "get_noise", jax_noise)


def _write_tiny_lora(path, seed: int) -> None:
    """A rank-4 diffusers-PEFT LoRA on a double block's to_q and to_out.0, a
    single block's proj_out and the x_embedder."""
    from diffusion_rs_tpu_torch.io.safetensors import save_safetensors

    rng = np.random.default_rng(seed)
    h = 32  # tests/synth.py FLUX_HIDDEN
    t = {}
    for base, k_in, n_out in (("transformer_blocks.0.attn.to_q", h, h),
                              ("transformer_blocks.1.attn.to_out.0", h, h),
                              ("single_transformer_blocks.0.proj_out", 5 * h, h),
                              ("x_embedder", 64, h)):
        t[f"transformer.{base}.lora_A.weight"] = (
            rng.standard_normal((4, k_in)) * 0.2).astype(np.float32)
        t[f"transformer.{base}.lora_B.weight"] = (
            rng.standard_normal((n_out, 4)) * 0.2).astype(np.float32)
    save_safetensors(str(path), t)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("isq")
    kw = dict(seed=0, guidance=True, dynamic_shifting=True)
    out = {"dense": str(write_checkpoint(root / "dense", **kw)),
           "nf4": str(write_checkpoint(root / "nf4", quant="nf4", **kw))}
    imat = {}
    for i in range(2):
        imat[f"double.{i}.img_attn.q"] = _importance(i, FLUX_HIDDEN)
        imat[f"double.{i}.img_mlp.out.weight"] = _importance(10 + i, 4 * FLUX_HIDDEN)
    imat["single.linear2"] = _importance(20, 5 * FLUX_HIDDEN)
    timatrix.save_imatrix(str(root / "imatrix.dat"), imat, ncall=4)
    _write_tiny_lora(root / "lora.safetensors", seed=1)
    _write_tiny_lora(root / "lora2.safetensors", seed=2)
    out["imatrix"] = str(root / "imatrix.dat")
    out["lora"] = str(root / "lora.safetensors")
    out["lora2"] = str(root / "lora2.safetensors")
    return out


# name -> (checkpoint, Pipeline kwargs); the tiny widths (32..160) take the
# 32-block formats (k-quants need K % 256)
PIPELINE_CASES = {
    "dense_q4_0_imatrix_lora": ("dense", dict(isq="q4_0", imatrix=True, lora=True)),
    # requantized nf4, T5 to its own target, two LoRA files with their scales
    "nf4_q8_0_t5_q4_0_two_loras": ("nf4", dict(isq="q8_0", isq_t5="q4_0",
                                               lora=("lora", "lora2"),
                                               lora_scale=(1.0, 0.5))),
}


def _kwargs(ckpts, spec: dict) -> dict:
    kw = dict(spec)
    if kw.get("imatrix"):
        kw["imatrix"] = ckpts["imatrix"]
    lora = kw.get("lora")
    if lora is True:
        kw["lora"] = ckpts["lora"]
    elif lora:
        kw["lora"] = [ckpts[x] for x in lora]
    return kw


@pytest.mark.parametrize("fast16", [False, True], ids=["f32_decode", "fast16"])
@pytest.mark.parametrize("name", list(PIPELINE_CASES))
def test_isq_lora_pipeline_matches_jax(name, fast16, ckpts, jax_kernels_interpreted,
                                       same_noise, monkeypatch):
    """Both loaders apply the options alike (the same linears quantized in
    the same formats, the same runtime LoRA terms); f32 latents within
    LATENT_BAND (f32 activations never take fast16), bf16 images above the
    PSNR floor with DIFFUSION_RS_TPU_QMM_FAST16 set or unset on both sides."""
    ck, spec = PIPELINE_CASES[name]
    kw = _kwargs(ckpts, spec)
    monkeypatch.setenv("DIFFUSION_RS_TPU_ISQ_MIN", "16")
    if fast16:
        monkeypatch.setenv("DIFFUSION_RS_TPU_QMM_FAST16", "1")
    src_j, src_t = JSource.from_model_id(ckpts[ck]), TSource.from_model_id(ckpts[ck])
    if not fast16:  # f32 activations never take the fast16 decode
        jp = JPipeline(src_j, silent=True, dtype=JDType.F32, **kw)
        tp = TPipeline(src_t, silent=True, dtype=TDType.F32, device="cpu", **kw)
        for key in ("flux_params", "t5_params"):
            _assert_trees_equal(getattr(tp._inner, key),
                                port_params(getattr(jp._inner, key), "cpu"))
        lat_j = jp.forward_latents(PROMPTS, JParams(**GEN))
        lat_t = tp.forward_latents(PROMPTS, TParams(**GEN))
        assert summed_rel(lat_t, lat_j) <= LATENT_BAND

    jp = JPipeline(src_j, silent=True, **kw)
    tp = TPipeline(src_t, silent=True, device="cpu", **kw)
    img_j = [np.asarray(i) for i in jp.forward_images(PROMPTS, JParams(**GEN))]
    img_t = tp.forward_images(PROMPTS, TParams(**GEN))
    for a, b in zip(img_t, img_j):
        mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
        assert mse == 0 or 10.0 * np.log10(255.0 ** 2 / mse) >= PSNR_FLOOR

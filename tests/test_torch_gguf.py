"""Parity of the port's quantized-format code with the JAX package: the GGUF
block decoders and encoders (quant/gguf_quants.py), the bnb parsers
(quant/bnb.py), the Q4_0/Q8_0 quantizers and N slicing (quant/qtensor.py),
the GGUF and safetensors files (io/gguf.py, io/safetensors.py), and K4's
plain version (ops/qmatmul.py ``qmm_affine`` on the CPU) against the
interpreted Pallas kernel.

Inputs come from numpy seeds. Decoders, encoders, planes and file bytes
must be exactly equal; the matmul bands are stated at each test.
"""

import json
from dataclasses import astuple
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from diffusion_rs_tpu.io import gguf as jgguf
from diffusion_rs_tpu.io import safetensors as jst
from diffusion_rs_tpu.io.varstore import VarStore as JVarStore
from diffusion_rs_tpu.ops.qmatmul_pallas import quantized_matmul as j_qmm
from diffusion_rs_tpu.quant import bnb as jbnb
from diffusion_rs_tpu.quant import gguf_quants as jgq
from diffusion_rs_tpu.quant import qtensor as jq
from diffusion_rs_tpu_torch.io import gguf as tgguf
from diffusion_rs_tpu_torch.io import safetensors as tst
from diffusion_rs_tpu_torch.io.varstore import VarStore as TVarStore
from diffusion_rs_tpu_torch.ops import qmatmul as tq
from diffusion_rs_tpu_torch.quant import bnb as tbnb
from diffusion_rs_tpu_torch.quant import gguf_quants as tgq
from diffusion_rs_tpu_torch.quant import qtensor as tqt
from torch_port_util import port_params, summed_rel, to_np

FIXTURES = Path(__file__).parent / "fixtures"
ALL_FORMATS = sorted(jgq.GGML_FORMATS)

# K4's plain version against the interpreted Pallas kernel: f32 outputs
# agree to the near-exact qmm band of tests/test_ops.py:176 (same decoded
# weight, f32 sums in another order); bf16 outputs to 1e-3, the one-ulp
# output flips that tests/test_torch_qmm.py:31-36 explains.
F32_BAND, BF16_BAND = 1e-5, 1e-3


def _raw_blocks(fmt: str, n_out: int, k_in: int, seed: int) -> bytes:
    """GGML blocks of a [n_out, k_in] weight: the JAX encoder's bytes where
    the format has one, else random blocks with valid f16/f32 scales."""
    rng = np.random.default_rng(seed)
    if fmt in jgq.ENCODERS:
        w = (rng.standard_normal((n_out, k_in)) * 0.05).astype(np.float32)
        return jgq.ENCODERS[fmt](w)
    f = jgq.GGML_FORMATS[fmt]
    b = rng.integers(0, 256, size=(n_out * k_in // f.block_elems, f.block_bytes),
                     dtype=np.uint8)
    if fmt == "q8_k":  # f32 d
        b[:, 0:4] = rng.uniform(1e-3, 2e-3, len(b)).astype(np.float32)[:, None].view(np.uint8)
    else:  # q8_1: f16 d (and f16 sum, unused by the decoder)
        b[:, 0:2] = rng.uniform(1e-3, 2e-3, len(b)).astype(np.float16)[:, None].view(np.uint8)
    return b.tobytes()


def _assert_same_qt(t, j):
    np.testing.assert_array_equal(t.packed.numpy(), np.asarray(j.packed))
    np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))
    assert (t.bias is None) == (j.bias is None)
    if j.bias is not None:
        np.testing.assert_array_equal(t.bias.numpy(), np.asarray(j.bias))
    assert (j.codebook is None) == (t.codebook is None)
    if j.codebook is not None:
        np.testing.assert_array_equal(t.codebook.numpy(), np.asarray(j.codebook))
    assert (t.kind, t.bits, t.group, t.split, tuple(t.shape), t.out_dtype) == (
        j.kind, j.bits, j.group, j.split, tuple(j.shape), j.out_dtype)


# ---------------------------------------------------------------------------
# Block formats
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ALL_FORMATS)
def test_gguf_to_canonical_matches_jax(fmt):
    """All 12 formats: the same raw bytes give exactly the same packed,
    scale and bias planes (and the same f32 rows through dequantize_rows)."""
    t, j = tgq.GGML_FORMATS[fmt], jgq.GGML_FORMATS[fmt]
    assert (t.name, t.block_elems, t.block_bytes) == (j.name, j.block_elems, j.block_bytes)
    raw = _raw_blocks(fmt, 128, 512, seed=len(fmt))
    _assert_same_qt(tgq.gguf_to_canonical(fmt, raw, (128, 512)),
                    jgq.gguf_to_canonical(fmt, raw, (128, 512)))
    np.testing.assert_array_equal(tgq.dequantize_rows(fmt, raw, (128, 512)),
                                  jgq.dequantize_rows(fmt, raw, (128, 512)))


@pytest.mark.parametrize("fmt", sorted(jgq.ENCODERS))
def test_encoders_byte_identical_to_jax(fmt):
    assert sorted(tgq.ENCODERS) == sorted(jgq.ENCODERS)
    w = (np.random.default_rng(3).standard_normal((64, 512)) * 0.1).astype(np.float32)
    w[0, :32] = 0.0  # an all-zero block takes the d == 0 branches
    assert tgq.ENCODERS[fmt](w) == jgq.ENCODERS[fmt](w)


def test_quantizers_and_n_slicing_match_jax(rng):
    w = (rng.standard_normal((512, 384)) * 0.1).astype(np.float32)
    for name in ("quantize_q4_0", "quantize_q8_0"):
        t, j = getattr(tqt, name)(w), getattr(jq, name)(w)
        _assert_same_qt(t, j)
        _assert_same_qt(tqt.slice_n(t, 128, 256), jq.slice_n(j, 128, 256))
        parts = [tqt.slice_n(t, 256, 384), tqt.slice_n(t, 0, 256)]
        _assert_same_qt(tqt.concat_n(parts),
                        jq.concat_n([jq.slice_n(j, 256, 384), jq.slice_n(j, 0, 256)]))
    with pytest.raises(ValueError, match="identical"):
        tqt.concat_n([tqt.quantize_q4_0(w), tqt.quantize_q8_0(w)])


# ---------------------------------------------------------------------------
# bitsandbytes
# ---------------------------------------------------------------------------


def test_bnb_nf4_nested_fixture_matches_jax():
    """The committed byte-level bitsandbytes nf4 double-quant fixture parses
    to the JAX package's planes exactly, and dequantizes to its recorded
    weights (tests/test_quant.py's bands)."""
    jstore = JVarStore(default_dtype=jnp.float32)
    jstore.add_safetensors(jst.SafeTensors.from_file(str(FIXTURES / "bnb_nf4_nested.safetensors")))
    tstore = TVarStore(default_dtype=torch.float32, device="cpu")
    tstore.add_safetensors(tst.SafeTensors.from_file(str(FIXTURES / "bnb_nf4_nested.safetensors")))
    jw = jstore.pp("proj").linear(bias=False).w
    tw = tstore.pp("proj").linear(bias=False).w
    _assert_same_qt(tw, jw)
    exp = np.load(FIXTURES / "bnb_nf4_nested_expected.npz")
    got = tqt.dequantize(tw, torch.float32).numpy()
    np.testing.assert_allclose(got, exp["weight_f32"].T, rtol=1e-6, atol=1e-7)
    assert np.abs(got - exp["original"].T).max() < 0.05


@pytest.mark.parametrize("kind", ["nf4", "fp4"])
def test_bnb4bit_and_absmax_match_jax(rng, kind):
    np.testing.assert_array_equal(tbnb.CODEBOOKS[kind], jbnb.CODEBOOKS[kind])
    w = rng.standard_normal((96, 256)).astype(np.float32)
    packed, absmax = jbnb.quantize_4bit_bnb_layout(w, 64, kind)
    # a nested absmax: u8 codes into a 256-entry map with its own blockwise scale
    codes = rng.integers(0, 256, size=absmax.size, dtype=np.uint8)
    qmap = np.linspace(-1, 1, 256).astype(np.float32)
    nested = rng.uniform(0.5, 1.5, size=-(-absmax.size // 8)).astype(np.float32)
    t_abs = tbnb.resolve_absmax(codes, nested, qmap, 8, 0.25)
    np.testing.assert_array_equal(t_abs, jbnb.resolve_absmax(codes, nested, qmap, 8, 0.25))
    _assert_same_qt(tbnb.bnb4bit_to_canonical(packed, t_abs, w.shape, 64, kind),
                    jbnb.bnb4bit_to_canonical(packed, t_abs, w.shape, 64, kind))


def test_bnb_int8_matches_jax(rng):
    q = rng.integers(-127, 128, size=(384, 512), dtype=np.int8)
    scb = rng.uniform(0.5, 4.0, size=384).astype(np.float32)
    _assert_same_qt(tbnb.bnb_int8_to_canonical(q, scb), jbnb.bnb_int8_to_canonical(q, scb))


# ---------------------------------------------------------------------------
# K4's plain version vs the interpreted Pallas kernel
# ---------------------------------------------------------------------------

K4_FORMATS = ["q4_0", "q4_1", "q2_k", "q4_k", "q5_0", "q6_k", "q8_0", "q8_k", "int8"]


def _k4_pair(fmt: str):
    """(JAX tensor, port tensor) of one [K=512, N=256] weight."""
    if fmt == "int8":
        r = np.random.default_rng(9)
        q = r.integers(-127, 128, size=(256, 512), dtype=np.int8)
        scb = r.uniform(0.02, 0.1, size=256).astype(np.float32)
        return jbnb.bnb_int8_to_canonical(q, scb), tbnb.bnb_int8_to_canonical(q, scb)
    raw = _raw_blocks(fmt, 256, 512, seed=7)
    return jgq.gguf_to_canonical(fmt, raw, (256, 512)), tgq.gguf_to_canonical(fmt, raw, (256, 512))


@pytest.mark.parametrize("fmt", K4_FORMATS)
@pytest.mark.parametrize("m", [1, 33])
@pytest.mark.parametrize("dtype,band", [("float32", F32_BAND), ("bfloat16", BF16_BAND)])
def test_k4_plain_matches_interpreted_pallas(fmt, m, dtype, band):
    jqt, tqt_ = _k4_pair(fmt)
    assert tq.supports(tqt_) and not tq.q8t_ok(tqt_) and tqt_.codebook is None
    x = np.random.default_rng(m).standard_normal((m, 512)).astype(np.float32)
    y_j = np.asarray(j_qmm(jnp.asarray(x, dtype), jqt, interpret=True), np.float32)
    y_t = to_np(tq.quantized_matmul(torch.from_numpy(x).to(getattr(torch, dtype)), tqt_))
    assert y_t.shape == (m, 256)
    assert summed_rel(y_t, y_j) <= band


def test_k4_plain_group_equals_k_tile_structure(rng):
    """bnb int8's whole-column group (group = K > the 256-row K-tile): the
    plain version applies row 0 of the plane to every k, as the Pallas
    kernel's repeated plane does (_tile_scale_plane)."""
    jqt, tqt_ = _k4_pair("int8")
    assert tqt_.group == 512 and tuple(tqt_.scale.shape) == (1, 256)
    w = tqt.dequantize(tqt_, torch.float32).numpy()
    np.testing.assert_array_equal(w, np.asarray(jq.dequantize(jqt, jnp.float32)))
    np.testing.assert_array_equal(
        w, tqt_.packed.numpy().astype(np.float32) * tqt_.scale.numpy()[0])


# ---------------------------------------------------------------------------
# Files
# ---------------------------------------------------------------------------


def test_gguf_file_reads_jax_written_file_and_writes_same_bytes(tmp_path, rng):
    """Dense f32/f16/bf16/i32 and quantized tensors: the port reads a
    JAX-written file byte for byte, and its writer produces the same file."""
    w = rng.standard_normal((64, 32)).astype(np.float32)
    bf = w.astype(ml_dtypes.bfloat16)
    tensors = {
        "a.f32": ("f32", w.shape, w.tobytes()),
        "a.f16": ("f16", w.shape, w.astype(np.float16).tobytes()),
        "a.bf16": ("bf16", w.shape, bf.tobytes()),
        "a.i32": ("i32", (7,), np.arange(7, dtype=np.int32).tobytes()),
        "a.q4_0": ("q4_0", w.shape, jgq.ENCODERS["q4_0"](w)),
        "a.q6_k": ("q6_k", (2, 256), jgq.ENCODERS["q6_k"](np.resize(w, (2, 256)))),
    }
    meta = {"general.name": "tiny", "general.alignment": 32, "x.flag": True, "x.f": 0.5}
    jpath, tpath = tmp_path / "j.gguf", tmp_path / "t.gguf"
    jgguf.write_gguf(str(jpath), tensors, metadata=meta)
    tgguf.write_gguf(str(tpath), tensors, metadata=meta)
    assert tpath.read_bytes() == jpath.read_bytes()
    jf, tf = jgguf.GgufFile(str(jpath)), tgguf.GgufFile(str(jpath))
    assert tf.metadata == jf.metadata and list(tf.keys()) == list(jf.keys())
    for name in tensors:
        assert astuple(tf.tensors[name]) == astuple(jf.tensors[name])
        np.testing.assert_array_equal(tf.raw(name), jf.raw(name))
    for name in ("a.f32", "a.f16", "a.i32"):
        np.testing.assert_array_equal(tf.numpy(name), jf.numpy(name))
        np.testing.assert_array_equal(tf.tensor(name).numpy(), jf.numpy(name))
    assert tf.tensor("a.bf16").dtype == torch.bfloat16
    np.testing.assert_array_equal(tf.tensor("a.bf16").view(torch.int16).numpy(),
                                  np.asarray(jf.numpy("a.bf16")).view(np.int16))
    np.testing.assert_array_equal(tf.numpy("a.bf16"), bf.view(np.uint16))
    with pytest.raises(ValueError, match="quantized"):
        tf.numpy("a.q4_0")


def test_safetensors_reads_jax_written_file_and_round_trips(tmp_path, rng):
    w = rng.standard_normal((5, 6)).astype(np.float32)
    arrays = {"f32": w, "f16": w.astype(np.float16), "bf16": w.astype(ml_dtypes.bfloat16),
              "i8": (w * 10).astype(np.int8), "u8": np.arange(9, dtype=np.uint8),
              "i64": np.arange(3, dtype=np.int64)}
    path = tmp_path / "j.safetensors"
    jst.save_safetensors(str(path), arrays)
    t, j = tst.SafeTensors.from_file(str(path)), jst.SafeTensors.from_file(str(path))
    assert list(t.keys()) == list(j.keys())
    for name, a in arrays.items():
        assert astuple(t.info(name)) == astuple(j.info(name))
        if name == "bf16":
            assert t.tensor(name).dtype == torch.bfloat16
            np.testing.assert_array_equal(t.tensor(name).view(torch.int16).numpy(),
                                          a.view(np.int16))
            np.testing.assert_array_equal(t.numpy(name), a.view(np.uint16))
        else:
            np.testing.assert_array_equal(t.numpy(name), j.numpy(name))
            np.testing.assert_array_equal(t.tensor(name).numpy(), a)
    # the port's writer: numpy or torch (bf16 included) in, the same file out
    out = tmp_path / "t.safetensors"
    tst.save_safetensors(str(out), {n: (torch.from_numpy(w).bfloat16() if n == "bf16" else a)
                                    for n, a in arrays.items()})
    assert out.read_bytes() == path.read_bytes()
    header = json.loads(out.read_bytes()[8:8 + int.from_bytes(out.read_bytes()[:8], "little")])
    assert header["bf16"]["dtype"] == "BF16"


def test_varstore_gguf_linear_matches_jax(tmp_path, rng):
    """A GGUF linear through both VarStores: the same canonical tensor, and
    the dense tensors cast alike (f16 -> bf16 included)."""
    w = (rng.standard_normal((256, 512)) * 0.05).astype(np.float32)
    b = rng.standard_normal(256).astype(np.float16)
    path = tmp_path / "m.gguf"
    jgguf.write_gguf(str(path), {
        "l.weight": ("q4_k", w.shape, jgq.ENCODERS["q4_k"](w)),
        "l.bias": ("f16", b.shape, b.tobytes()),
    })
    js = JVarStore(default_dtype=jnp.bfloat16)
    js.add_gguf(jgguf.GgufFile(str(path)))
    ts = TVarStore(default_dtype=torch.bfloat16, device="cpu")
    ts.add_gguf(tgguf.GgufFile(str(path)))
    jl, tl = js.pp("l").linear(), ts.pp("l").linear()
    _assert_same_qt(tl.w, jl.w)
    np.testing.assert_array_equal(to_np(tl.b), np.asarray(jl.b, np.float32))
    assert tl.b.dtype == torch.bfloat16
    dense = ts.pp("l").linear(dequantize_to_dense=True).w
    np.testing.assert_array_equal(to_np(dense), np.asarray(jq.dequantize(jl.w, jnp.bfloat16),
                                                           np.float32))
    assert port_params(jl.w).kind == "q4_k"

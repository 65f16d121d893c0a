"""Parity of the port's int8 attention modes with the JAX package.

The prepasses (``quantize_k`` / ``quantize_v``), the plain versions of K9
(s8 QK^T), K10 (s8 P.V) and both together, and the ``s8pv_dropped_mass``
diagnostic are held against ``flash_pallas.py`` (Pallas in interpret mode)
and against ``sdpa_xla`` at JAX's own int8 band (2e-2, tests/test_ops.py:387).
The environment knobs and the ``sdpa`` / ``sdpa_merged`` dispatch (head-dim
padding, the ``NotImplementedError`` fallback, ATTN_MERGED=0) follow JAX's
``ops/attention.py``. The CUDA kernels are held against these plain
versions on the card by tests/test_torch_cuda.py.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_rs_tpu import ops as jops
from diffusion_rs_tpu.ops import flash_pallas as jfp
from diffusion_rs_tpu.pipelines.api import DiffusionGenerationParams as JParams
from diffusion_rs_tpu_torch import DiffusionGenerationParams as TParams
from diffusion_rs_tpu_torch.ops import _cuda
from diffusion_rs_tpu_torch.ops import flash as tflash
from test_torch_pipeline import GEN, PROMPTS, _pipelines, same_noise  # noqa: F401
from torch_port_util import jax_kernels_interpreted, summed_rel, to_np  # noqa: F401

INT8_BAND = 2e-2  # tests/test_ops.py:387, against sdpa_xla
# The port's plain versions against JAX's interpreted kernel: the same
# quantized codes and integer dots, so only f32 summation orders differ (the
# k / v mean, the bf16-mode QK^T, the f32 P.V of K9). Measured <= 2.3e-7.
PORT_BAND = 1e-5
MODES = [(True, False), (False, True), (True, True)]
MODE_IDS = ["s8", "s8_pv", "s8+s8_pv"]
jattention = importlib.import_module("diffusion_rs_tpu.ops.attention")
tattention = importlib.import_module("diffusion_rs_tpu_torch.ops.attention")
KNOBS = ("_s8_default", "_s8_pv_default", "_merged_default")


def _clear_knobs():
    for mod in (jattention, tattention):
        for knob in KNOBS:
            getattr(mod, knob).cache_clear()


@pytest.fixture
def knobs(monkeypatch):
    """Set attention environment knobs for a test, in both packages."""
    _clear_knobs()
    yield monkeypatch
    monkeypatch.undo()
    _clear_knobs()


def _qkv(rng, s, d, v_shift=3.0):
    q, k, v = (rng.standard_normal((1, 2, s, d)).astype(np.float32) for _ in range(3))
    return q, k, v + v_shift  # non-zero v means: the centring is added back


@pytest.mark.parametrize("which", ["k", "v"])
@pytest.mark.parametrize("s,block", [(300, 384), (130, 128), (4608, 1536)])
def test_quantize_prepasses_match_jax(rng, which, s, block):
    """Scales within one f32 ulp; int8 codes equal except a share of at most
    1e-3 off by one (the mean's summation order can move a value across a
    rounding boundary); the same zero padding."""
    x = (rng.standard_normal((1, 2, s, 128)) * 0.3 + 0.1).astype(np.float32)
    if which == "k":
        cj, sj = jfp._quantize_k(jnp.asarray(x), block)
        ct, st, mt = tflash.quantize_k(torch.from_numpy(x), block)
        np.testing.assert_allclose(to_np(mt), np.asarray(jnp.mean(jnp.asarray(x), axis=2)),
                                   rtol=1e-6, atol=1e-7)
    else:
        cj, sj, mj = jfp._quantize_v(jnp.asarray(x), block)
        ct, st, mt = tflash.quantize_v(torch.from_numpy(x), block)
        np.testing.assert_allclose(to_np(mt), np.asarray(mj), rtol=1e-6, atol=1e-7)
    cj, sj = np.asarray(cj), np.asarray(sj)
    ct, st = ct.numpy(), st.numpy()
    assert ct.shape == cj.shape and ct.dtype == np.int8 and st.shape == sj.shape
    assert np.abs(st.view(np.int32) - sj.view(np.int32)).max() <= 1
    diff = np.abs(ct.astype(np.int32) - cj.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    assert not ct[:, :, s:].any()


@pytest.mark.parametrize("s8,s8_pv", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("case", ["s300", "ragged_s130_block128", "d64"])
def test_int8_plain_matches_interpreted_pallas(rng, s8, s8_pv, case):
    """K9 / K10 / both: the port's CPU path against ``_flash_kernel`` in the
    same mode, and both within JAX's int8 band of ``sdpa_xla``: at S300, at
    the ragged S130 with a 128-row block (JAX's block_k = 128, the port's
    quantization block = 128), and at head dim 64 (zero-padded to 128)."""
    s, d, block = {"s300": (300, 128, None), "ragged_s130_block128": (130, 128, 128),
                   "d64": (256, 64, None)}[case]
    q, k, v = _qkv(rng, s, d)
    kw = {} if block is None else dict(block_q=block, block_k=block)
    o_j = np.asarray(jfp.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         interpret=True, s8=s8, s8_pv=s8_pv, **kw))
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    if block is None:
        o_t = tflash.flash_attention(qt, kt, vt, s8=s8, s8_pv=s8_pv)
    else:
        o_t = tflash.flash_int8_plain(qt, kt, vt, d ** -0.5, s8, s8_pv, qblock=block)
    assert tuple(o_t.shape) == (1, 2, s, d)
    ref = np.asarray(jops.sdpa_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    assert summed_rel(to_np(o_t), o_j) <= PORT_BAND
    assert summed_rel(to_np(o_t), ref) <= INT8_BAND
    assert _cuda.launch_counts() == dict.fromkeys(_cuda.KERNELS, 0)


def test_int8_bf16_inputs_match_interpreted_pallas(rng):
    """bf16 q/k/v, both modes: the kernel's operand dtype. The int8 path
    rounds nothing in bf16 but p.V's output; band 4e-3 as for K3's bf16
    test (tests/test_torch_flash.py)."""
    q, k, v = _qkv(rng, 200, 128)
    for s8, s8_pv in MODES:
        o_j = np.asarray(jfp.flash_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                                             interpret=True, s8=s8, s8_pv=s8_pv,
                                             out_seqmajor=True), np.float32)
        o_t = tflash.flash_attention(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
                                     s8=s8, s8_pv=s8_pv, out_seqmajor=True)
        assert o_t.dtype == torch.bfloat16 and tuple(o_t.shape) == (1, 200, 256)
        assert summed_rel(to_np(o_t), o_j) <= 4e-3


@pytest.mark.parametrize("case", ["other_block", "shared_block", "realistic"])
def test_s8_pv_diffuse_tail_matches_jax(rng, case):
    """The three cases of test_flash_attention_s8_pv_diffuse_tail
    (tests/test_ops.py:425-489) at S4608: the port's dropped-mass
    diagnostic equals JAX's (1e-6), its s8_pv output is JAX's within
    PORT_BAND, and the error against sdpa_xla obeys JAX's bounds: 2e-2
    when the tail sits in other blocks or the magnitudes are FLUX's, and
    2d/(1-d) + 0.05 when the sharp key and a tail of dropped share d share
    a block."""
    S, d = 4608, 128
    q = np.zeros((1, 1, 256, d), np.float32)
    q[..., 0] = float(d) ** 0.5  # scale * (q . k_j) == k_j[0]
    v = rng.standard_normal((1, 1, S, d)).astype(np.float32)
    v[:, :, 0] += 5.0
    k = np.zeros((1, 1, S, d), np.float32)
    k[:, :, :, 0] = -6.0
    k[:, :, 0, 0] = 0.0
    if case == "other_block":
        k[:, :, 1:1536, 0] = -30.0
    if case == "realistic":
        q = (rng.standard_normal((1, 1, 512, d)) * 0.3).astype(np.float32)
        k, v = ((rng.standard_normal((1, 1, S, d)) * 0.3).astype(np.float32) for _ in range(2))
        jd, td = jnp.bfloat16, torch.bfloat16
    else:
        jd, td = jnp.float32, torch.float32
    qj, kj, vj = (jnp.asarray(a, jd) for a in (q, k, v))
    qt, kt, vt = (torch.from_numpy(a).to(td) for a in (q, k, v))
    drop_j = np.asarray(jfp.s8pv_dropped_mass(qj, kj))
    drop_t = to_np(tflash.s8pv_dropped_mass(qt, kt))
    np.testing.assert_allclose(drop_t, drop_j, rtol=0, atol=1e-6)
    dropped = float(drop_t.max())
    o_j = np.asarray(jfp.flash_attention(qj, kj, vj, interpret=True, s8_pv=True), np.float32)
    o_t = to_np(tflash.flash_attention(qt, kt, vt, s8_pv=True))
    ref = np.asarray(jops.sdpa_xla(qj, kj, vj), np.float32)
    band = {"other_block": PORT_BAND, "shared_block": PORT_BAND, "realistic": 4e-3}[case]
    assert summed_rel(o_t, o_j) <= band  # realistic: bf16 outputs, as above
    if case == "shared_block":
        assert 0.1 <= dropped <= 0.5
        assert summed_rel(o_t, ref) <= 2 * dropped / (1 - dropped) + 0.05
    else:
        assert dropped <= (1e-3 if case == "other_block" else 2e-2)
        assert summed_rel(o_t, ref) <= INT8_BAND


def test_env_knobs_and_cache_clear(knobs):
    """JAX's names, parsing and defaults (off, off, on); each read once and
    cached until its ``cache_clear``."""
    assert (tattention._s8_default(), tattention._s8_pv_default(),
            tattention._merged_default()) == (False, False, True)
    knobs.setenv("DIFFUSION_RS_TPU_ATTN_S8", "on")
    knobs.setenv("DIFFUSION_RS_TPU_ATTN_S8PV", "TRUE")
    knobs.setenv("DIFFUSION_RS_TPU_ATTN_MERGED", "off")
    assert tattention._s8_default() is False  # still the cached value
    for value, want in (("1", True), ("force", True), ("0", False), ("false", False),
                        ("", False), ("maybe", False)):
        knobs.setenv("DIFFUSION_RS_TPU_ATTN_S8", value)
        for mod in (jattention, tattention):
            mod._s8_default.cache_clear()
        assert tattention._s8_default() is want is jattention._s8_default()
    _clear_knobs()
    assert tattention._s8_pv_default() is True and tattention._merged_default() is False


def test_sdpa_merged_takes_the_knobs(rng, knobs):
    """With ATTN_S8 / ATTN_S8PV set, ``sdpa_merged`` runs the int8 plain
    version of its mode; explicit arguments win over the knobs; ATTN_MERGED=0
    takes the [B, H, S, D] output plus a transpose, bit for bit."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 64, 128))
    base = tattention.sdpa_merged(q, k, v)
    assert torch.equal(base, tflash.flash_attention(q, k, v, out_seqmajor=True))
    for env, mode in (({"DIFFUSION_RS_TPU_ATTN_S8": "1"}, (True, False)),
                      ({"DIFFUSION_RS_TPU_ATTN_S8PV": "1"}, (False, True)),
                      ({"DIFFUSION_RS_TPU_ATTN_S8": "1", "DIFFUSION_RS_TPU_ATTN_S8PV": "1"},
                       (True, True))):
        for name in ("DIFFUSION_RS_TPU_ATTN_S8", "DIFFUSION_RS_TPU_ATTN_S8PV"):
            knobs.setenv(name, env.get(name, "0"))
        _clear_knobs()
        want = tflash.flash_attention(q, k, v, out_seqmajor=True, s8=mode[0], s8_pv=mode[1])
        assert torch.equal(tattention.sdpa_merged(q, k, v), want)
        assert torch.equal(tattention.sdpa(q, k, v).transpose(1, 2).reshape(want.shape), want)
        assert torch.equal(tattention.sdpa_merged(q, k, v, s8=False, s8_pv=False), base)
        knobs.setenv("DIFFUSION_RS_TPU_ATTN_MERGED", "0")
        _clear_knobs()
        assert torch.equal(tattention.sdpa_merged(q, k, v), want)
        knobs.delenv("DIFFUSION_RS_TPU_ATTN_MERGED")


def test_head_dims_pad_or_fall_back(rng):
    """D64 is zero-padded into the kernel (JAX's test_flash_head_dim_64,
    tests/test_partitioned.py:96: atol 2e-5 against sdpa_xla); the merged
    layout with a padded D takes the [B, H, S, D] path plus a transpose;
    D256 raises NotImplementedError in flash_attention and ``sdpa`` runs
    ``sdpa_xla`` instead, as in JAX."""
    q = rng.standard_normal((1, 2, 256, 64)).astype(np.float32)
    qt = torch.from_numpy(q)
    out = tflash.flash_attention(qt, qt, qt)
    ref = np.asarray(jops.sdpa_xla(jnp.asarray(q), jnp.asarray(q), jnp.asarray(q)))
    assert tuple(out.shape) == (1, 2, 256, 64)
    np.testing.assert_allclose(to_np(out), ref, atol=2e-5)
    o_j = np.asarray(jfp.flash_attention(jnp.asarray(q), jnp.asarray(q), jnp.asarray(q),
                                         interpret=True))
    assert summed_rel(to_np(out), o_j) <= 5e-4  # K3's band, tests/test_torch_flash.py
    with pytest.raises(NotImplementedError):
        tflash.flash_attention(qt, qt, qt, out_seqmajor=True)
    merged = tattention.sdpa_merged(qt, qt, qt)
    assert torch.equal(merged, out.transpose(1, 2).reshape(1, 256, 128))
    wide = torch.from_numpy(rng.standard_normal((1, 2, 40, 256)).astype(np.float32))
    with pytest.raises(NotImplementedError):
        tflash.flash_attention(wide, wide, wide)
    assert torch.equal(tattention.sdpa(wide, wide, wide),
                       tattention.sdpa_xla(wide, wide, wide))


def test_int8_wrappers_have_no_fallback():
    """Given tensors that are not on the CPU, the int8 modes launch their
    kernels or raise; they never run the plain versions (checked on the
    'meta' device)."""
    q = torch.zeros((1, 2, 8, 128), dtype=torch.bfloat16, device="meta")
    for s8, s8_pv in MODES:
        with pytest.raises(ValueError, match="CUDA"):
            tflash.flash_attention(q, q, q, out_seqmajor=True, s8=s8, s8_pv=s8_pv)
        with pytest.raises(ValueError, match="CUDA"):
            tflash.flash_int8(q, q, q, 0.1, s8, s8_pv)


@pytest.fixture
def int8_attention(knobs):
    for name in ("DIFFUSION_RS_TPU_ATTN_S8", "DIFFUSION_RS_TPU_ATTN_S8PV"):
        knobs.setenv(name, "1")
    _clear_knobs()


def test_slice_int8_attention_matches_jax(jax_kernels_interpreted, same_noise,
                                          int8_attention):
    """The tiny q8t pipeline (tests/test_torch_pipeline.py) with
    DIFFUSION_RS_TPU_ATTN_S8=1 and ATTN_S8PV=1 in both packages: every FLUX
    attention runs the combined int8 mode. f32 latents within the slice's
    band (5e-3, as there: T5's summation order flips q8t activation codes,
    and the int8 q codes of attention are a step function of the same
    kind, so the tiny differences no longer stay at 1e-7 through the
    denoise)."""
    jpipe, tpipe = _pipelines("float32")
    lat_j = jpipe.forward_arrays(PROMPTS, JParams(**GEN), output_type="latent")
    lat_t = tpipe.forward_arrays(PROMPTS, TParams(**GEN), output_type="latent")
    assert lat_t.shape == lat_j.shape == (2, 16, 64)
    assert summed_rel(lat_t, lat_j) <= 5e-3
    # the int8 mode really ran: the same pipeline without it lands elsewhere
    for mod in (jattention, tattention):
        mod._s8_default.cache_clear()
        mod._s8_pv_default.cache_clear()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DIFFUSION_RS_TPU_ATTN_S8", "0")
        mp.setenv("DIFFUSION_RS_TPU_ATTN_S8PV", "0")
        lat_bf = tpipe.forward_arrays(PROMPTS, TParams(**GEN), output_type="latent")
        _clear_knobs()
    assert summed_rel(lat_t, lat_bf) > 1e-4

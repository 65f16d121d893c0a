"""The plain versions of K14 (the flash kernels' per-row log-sum-exp, which
ring attention merges chunks with) against JAX's ``_flash_call(...,
save_lse=True)`` in interpret mode: bf16 mode and each of s8, s8_pv and both,
on f32 inputs from a numpy seed, at an even, a ragged and a diffuse-tail
shape. The CUDA entry points are held against these plain versions on the
card by tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_rs_tpu.ops import flash_pallas as jfp
from diffusion_rs_tpu_torch.ops import _cuda
from diffusion_rs_tpu_torch.ops import flash as tflash
from torch_port_util import summed_rel, to_np

MODES = {"bf16": (False, False), "s8": (True, False), "s8_pv": (False, True),
         "s8+s8_pv": (True, True)}
# o: the bands of these modes against sdpa_xla (tests/test_ops.py:130 and
# :387); the port's plain versions sit far inside them against JAX's kernel
O_BAND = {"bf16": 5e-4, "int8": 2e-2}
# lse max-abs: bf16 mode 1e-4. The int8 modes quantize the same codes as
# JAX's kernel and sum the same integers; their f32 terms (the k / v means,
# the block factors) differ in summation order only: band 1e-4 as well.
LSE_ATOL = 1e-4
# (Sq, Skv, kv / quantization block): even; ragged Sq and Skv; and a diffuse
# tail (tests/test_torch_flash_s8.py): one sharp key, the rest 6 logits
# below, a whole block 30 below, over four quantization blocks
CASES = {"even": (256, 256, 128), "ragged": (200, 300, 128), "diffuse_tail": (128, 1024, 256)}


def _inputs(case: str):
    sq, skv, block = CASES[case]
    rng = np.random.default_rng(sq + skv)
    if case == "diffuse_tail":
        q = np.zeros((1, 2, sq, 128), np.float32)
        q[..., 0] = 128 ** 0.5  # scale * (q . k_j) == k_j[0]
        k = (rng.standard_normal((1, 2, skv, 128)) * 0.01).astype(np.float32)
        k[..., 0] = -6.0
        k[:, :, 0, 0] = 0.0
        k[:, :, 256:512, 0] = -30.0
        v = rng.standard_normal((1, 2, skv, 128)).astype(np.float32)
        v[:, :, 0] += 5.0
    else:
        q, k, v = (rng.standard_normal((1, 2, s, 128)).astype(np.float32)
                   for s in (sq, skv, skv))
        v += 2.0  # the s8_pv centring is added back
    return q, k, v, block


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mode", list(MODES))
def test_lse_plain_matches_jax(case, mode):
    """o within its mode's band and lse within LSE_ATOL of JAX's kernel at
    the same kv / quantization block; the s8 mode also returns the k mean
    its prepass removed."""
    s8, s8_pv = MODES[mode]
    q, k, v, block = _inputs(case)
    scale = 128 ** -0.5
    o_j, lse_j = (np.asarray(a) for a in jfp._flash_call(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, block, block, True,
        save_lse=True, s8=s8, s8_pv=s8_pv))
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    if s8 or s8_pv:
        o_t, lse_t, km = tflash.flash_int8_lse_plain(qt, kt, vt, scale, s8, s8_pv, qblock=block)
        assert (km is not None) == s8
        if s8:  # the mean quantize_k removed
            np.testing.assert_allclose(to_np(km), k.mean(axis=2), rtol=1e-5, atol=1e-6)
    else:
        o_t, lse_t = tflash.flash_attention_lse_plain(qt, kt, vt, scale)
    assert tuple(lse_t.shape) == lse_j.shape == q.shape[:3] and lse_t.dtype == torch.float32
    assert summed_rel(to_np(o_t), o_j) <= O_BAND["int8" if s8 or s8_pv else "bf16"]
    assert np.abs(to_np(lse_t) - lse_j).max() <= LSE_ATOL
    if mode == "bf16":  # the log-sum-exp of the scores (int8 modes: of the
        # centred k's scores, and of the int8 p, which drops the diffuse tail)
        exact = torch.logsumexp(qt @ kt.transpose(-1, -2) * scale, dim=-1)
        assert (lse_t - exact).abs().max() <= 1e-4


@pytest.mark.parametrize("mode", list(MODES))
def test_lse_dispatch_on_cpu(mode):
    """``flash_attention(..., save_lse=True)`` on CPU tensors: the plain
    versions, o as without ``save_lse`` ([B, H, Sq, D], head dim 64
    zero-padded and sliced back), the lse that of the padded call; no kernel
    launch."""
    s8, s8_pv = MODES[mode]
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 3, 130, 64)).astype(np.float32))
               for _ in range(3))
    o, lse, km = tflash.flash_attention(q, k, v, s8=s8, s8_pv=s8_pv, save_lse=True)
    assert tuple(o.shape) == (2, 3, 130, 64) and tuple(lse.shape) == (2, 3, 130)
    assert (km is not None) == s8 and (km is None or tuple(km.shape) == (2, 3, 64))
    ref = tflash.flash_attention(q, k, v, s8=s8, s8_pv=s8_pv)
    assert torch.equal(o, ref)
    assert _cuda.launch_counts() == dict.fromkeys(_cuda.KERNELS, 0)

"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips without a CUDA device. This file imports
only torch and the port (the GPU host has no JAX), so run it there without
the repo's conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Shapes cover what chip_smoke.py does not: ragged M, K-tiles of 64, split
128, ragged and unequal q/kv lengths, batch 2.
"""

import pytest
import torch

from diffusion_rs_tpu_torch.ops import _cuda, flash, qmatmul
from diffusion_rs_tpu_torch.util.synthetic import random_qtensor

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


@pytest.mark.parametrize("m,k,n", [(1, 768, 384), (200, 768, 384), (513, 64, 256),
                                   (33, 3072, 128)])
def test_k1_matches_plain(dev, m, k, n):
    """Bit for bit: same IEEE quotient, same integer dot, same f32 epilogue
    order; the band allows nothing beyond bf16 output ties."""
    gen = torch.Generator(device=dev).manual_seed(m)
    qt = random_qtensor(gen, k, n, kind="q8t", device=dev)
    qt.scale.uniform_(0.5e-3, 2e-3, generator=gen)
    x = torch.randn((m, k), generator=gen, device=dev).bfloat16()
    before = _cuda.launch_counts()["qmm_s8"]
    y = qmatmul.qmm_s8(x, qt, torch.bfloat16)
    assert _cuda.launch_counts()["qmm_s8"] == before + 1
    ref = qmatmul.qmm_s8_plain(x, qt.packed, qt.scale, torch.bfloat16)
    assert _summed_rel(y, ref) <= 1e-5


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


def test_quantized_matmul_dispatch_on_card(dev):
    """q8t and nf4 reach their kernels through ``quantized_matmul``; N=64
    takes the dequantize + matmul fallback without a launch."""
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((2, 5, 256), generator=gen, device=dev).bfloat16()
    _cuda.reset_launch_counts()
    for kind in ("q8t", "nf4"):
        y = qmatmul.quantized_matmul(x, random_qtensor(gen, 256, 128, kind=kind, device=dev))
        assert tuple(y.shape) == (2, 5, 128) and y.dtype == torch.bfloat16
    qmatmul.quantized_matmul(x, random_qtensor(gen, 256, 64, kind="q8t", device=dev))
    assert _cuda.launch_counts() == {"qmm_s8": 1, "qmm_nf4": 1, "flash_fwd": 0}

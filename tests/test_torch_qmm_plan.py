"""The launch plan and operand checks of the TMA-fed q8t, nf4 and affine kernels.

``ops/qmatmul.qmm_plan`` is what the K1 / K8-s8, K2 / K11 / K12 and K4 /
K8-affine / K13 wrappers launch with (tiles, ring, the s8 path's scale
scratch), and
``check_tma_operand`` what they demand of each operand TMA reads. Host
code only: these run on the CPU, with no card and no kernel build.
"""

import numpy as np
import pytest
import torch

from diffusion_rs_tpu_torch.ops import qmatmul

MS = [1, 512, 4096, 4608]
# FLUX.1-dev linears (K, N): img/txt qkv and proj, mlp in / out, the single
# blocks' linear2 and fused qkv_mlp, the modulation, img_in
FLUX_KN = [(3072, 3072), (3072, 12288), (12288, 3072), (15360, 3072), (3072, 18432),
           (3072, 9216), (64, 3072)]
# T5-XXL linears: q/k/v/o, wi, wo
T5_KN = [(4096, 4096), (4096, 10240), (10240, 4096)]


def _covered_once(plan) -> bool:
    hits = np.zeros((plan.m, plan.n), dtype=np.int32)
    for m0, n0, rows, cols in plan.tiles():
        assert rows > 0 and cols > 0
        hits[m0:m0 + rows, n0:n0 + cols] += 1
    return bool((hits == 1).all())


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("k,n", FLUX_KN)
def test_s8_plan_covers_output_once(m, k, n):
    bk = min(256, k)
    plan = qmatmul.qmm_plan("s8", m, k, n, bk=bk)
    assert _covered_once(plan)
    assert len(plan.tiles()) == plan.grid[0] * plan.grid[1]
    # the transposed scale scratch holds every tile's 128 rows
    assert plan.sx_rows % plan.block_m == 0 and m <= plan.sx_rows < m + plan.block_m
    assert bk % plan.stage_k == 0 and k % plan.stage_k == 0


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("k,n", T5_KN)
@pytest.mark.parametrize("split,group", [(256, 64), (64, 32)])
def test_nf4_plan_covers_output_once(m, k, n, split, group):
    plan = qmatmul.qmm_plan("nf4", m, k, n, split=split, group=group)
    assert _covered_once(plan)
    assert plan.sx_rows == 0
    # a stage's 64 packed rows fall in halves of 32, each inside one run
    assert (k // 2) % 32 == 0 and (split // 2) % 32 == 0


def test_plan_tiles_at_the_main_path_shapes():
    """The numbers the source notes and PERF.md quote."""
    p = qmatmul.qmm_plan("s8", 4096, 3072, 3072, bk=256)
    assert p.grid == (24, 32) and (p.stage_k, p.stages) == (128, 6)
    p = qmatmul.qmm_plan("s8", 4096, 64, 3072, bk=64)  # img_in
    assert p.grid == (24, 32) and (p.stage_k, p.stages) == (64, 8)
    assert qmatmul.qmm_plan("s8", 1, 3072, 3072, bk=256).grid == (24, 1)
    p = qmatmul.qmm_plan("nf4", 512, 10240, 4096, split=256, group=64)
    assert p.grid == (32, 4) and p.block_m == 128
    p = qmatmul.qmm_plan("nf4", 4608, 3072, 12288, split=256, group=64)
    assert p.grid == (96, 18) and (p.block_m, p.stages) == (256, 3)


@pytest.mark.parametrize("ms,n,block_m", [((512,), 4096, 128), ((512,), 10240, 128),
                                          ((4608,), 12288, 256), ((4096, 512), 12288, 256),
                                          ((64, 0, 1, 200, 3, 128, 5, 33), 384, 128)])
def test_nf4_rows_per_tile_follow_the_grid(ms, n, block_m):
    """256-row tiles only where four of them per SM remain;
    a grouped call decides on all its groups' row tiles together."""
    p = qmatmul.qmm_plan("nf4", ms[0], 3072, n, split=256, group=64, group_ms=ms)
    assert p.block_m == block_m
    assert p.stages == (3 if block_m == 256 else 4)


# the affine formats' (bits, split, group): Q4_0 / Q4_1 / Q4_K (4-bit, groups
# of 32), Q2_K / Q3_K (4-bit, groups of 16), Q8_0 / Q5_x (int8, 32), Q6_K
# (int8, 16), Q8_K (int8, 256), bnb int8 (group = K)
AFFINE_FORMATS = [(4, 256, 32), (4, 256, 16), (4, 64, 32), (8, 0, 32), (8, 0, 16),
                  (8, 0, 256), (8, 0, None)]


@pytest.mark.parametrize("m", MS + [33, 64, 65])
@pytest.mark.parametrize("bits,split,group", AFFINE_FORMATS)
def test_affine_plan_covers_output_once(m, bits, split, group):
    k, n = 3072, 3072
    plan = qmatmul.qmm_plan("affine", m, k, n, bits=bits, split=split, group=group or k)
    assert _covered_once(plan)
    assert plan.stage_k == (128 if bits == 4 else 64) and k % plan.stage_k == 0
    # a stage's x slices, code box and 8 plane rows fit 192 KB at every height
    slices = 4 if bits == 4 else 2
    assert 2 <= plan.stages <= 8
    assert plan.stages * (slices * plan.block_m * 64 + 8192 + 8192) <= 196608


@pytest.mark.parametrize("m,n,block_m", [(1, 18432, 8), (8, 3072, 8), (9, 3072, 16),
                                         (33, 3072, 40), (63, 3072, 64), (64, 3072, 64),
                                         (65, 3072, 128), (512, 3072, 128), (512, 9216, 128),
                                         (4096, 3072, 192), (4608, 3072, 192),
                                         (4608, 21504, 192)])
@pytest.mark.parametrize("bits", [4, 8])
def test_affine_rows_per_tile(m, n, block_m, bits):
    """At M <= 64 the tile height (wgmma's N) is M rounded up to 8; above,
    large tiles where two tiles per SM remain (every FLUX product at M4096
    and M4608, N3072 included), 192 rows for 4-bit codes (three stages fit)
    and 256 for int8; 128 at M512."""
    want = 256 if bits == 8 and block_m == 192 else block_m
    plan = qmatmul.qmm_plan("affine", m, 3072, n, bits=bits, split=256, group=32)
    assert plan.block_m == want and plan.stages >= 3


def test_affine_plans_at_the_main_path_shapes():
    """M1: the double blocks' (N18432) and single blocks' (N9216) modulation;
    M512: the text stream and T5 under ISQ; M4608: the single blocks'
    qkv_mlp (N21504)."""
    p = qmatmul.qmm_plan("affine", 1, 3072, 18432, bits=8, group=32)
    assert p.grid == (144, 1) and (p.block_m, p.stages) == (8, 8)
    p = qmatmul.qmm_plan("affine", 1, 3072, 9216, bits=4, split=256, group=32)
    assert p.grid == (72, 1) and p.block_m == 8
    p = qmatmul.qmm_plan("affine", 512, 4096, 4096, bits=4, split=256, group=32)
    assert p.grid == (32, 4) and (p.block_m, p.stages) == (128, 4)
    p = qmatmul.qmm_plan("affine", 4608, 3072, 21504, bits=4, split=256, group=32)
    assert p.grid == (168, 24) and (p.block_m, p.stages) == (192, 3)
    p = qmatmul.qmm_plan("affine", 4608, 3072, 21504, bits=8, group=32)
    assert (p.block_m, p.stages, p.stage_k) == (256, 4, 64)


@pytest.mark.parametrize("ms,block_m", [((4096, 512), 192), ((130, 17), 128), ((17, 1), 24),
                                        ((64, 0, 1, 200, 3, 128, 5, 33), 192),
                                        ((0, 0), 8), ((1, 64, 2), 64), ((512, 512), 192)])
def test_affine_group_tables(ms, block_m):
    """A grouped call (K8-affine) takes one tile height for all its groups,
    from the largest; each group's m-tiles start at its own row 0, and the
    tiles cover every group's rows once."""
    n = 12288
    p = qmatmul.qmm_plan("affine", ms[0], 3072, n, bits=4, split=256, group=32, group_ms=ms)
    assert p.block_m == block_m
    tile0 = np.cumsum([0] + [-(-m // p.block_m) for m in ms])
    for i, m in enumerate(ms):
        rows = np.zeros(m, dtype=np.int32)
        for t in range(tile0[i], tile0[i + 1]):
            m0 = (t - tile0[i]) * p.block_m
            rows[m0:m0 + p.block_m] += 1
        assert (rows == 1).all()
    assert len(ms) <= qmatmul.MAX_GROUPS


@pytest.mark.parametrize("kind,kw,k,n", [
    ("s8", dict(bk=256), 3072, 3000),      # N % 128
    ("s8", dict(bk=96), 3072, 3072),       # K-tile % 64
    ("s8", dict(bk=256), 320, 3072),       # K % K-tile
    ("nf4", dict(split=32, group=32), 4096, 4096),
    ("nf4", dict(split=256, group=48), 4096, 4096),
    ("nf4", dict(split=256, group=64), 4096, 4000),
    ("q4", dict(), 4096, 4096),
    ("affine", dict(bits=4, split=32, group=32), 4096, 4096),   # split % 64
    ("affine", dict(bits=4, split=256, group=8), 4096, 4096),   # group % 16
    ("affine", dict(bits=8, split=0, group=32), 4096, 4000),    # N % 128
    ("affine", dict(bits=8, split=0, group=32), 4000, 4096),    # K % 64
    ("affine", dict(bits=2, split=256, group=32), 4096, 4096),  # bits
    ("affine", dict(bits=8, split=0, group=48), 4096, 4096),    # K % group
])
def test_plan_refuses_untiled_shapes(kind, kw, k, n):
    with pytest.raises(ValueError):
        qmatmul.qmm_plan(kind, 512, k, n, **kw)


def test_tma_operand_accepts_fresh_and_row_sliced_tensors():
    x = torch.zeros((64, 128), dtype=torch.bfloat16)
    qmatmul.check_tma_operand("x", x)
    qmatmul.check_tma_operand("x", x[8:])          # whole rows off a 256-byte row
    qmatmul.check_tma_operand("scale", torch.zeros((12, 3072)))
    qmatmul.check_tma_operand("codebook", torch.zeros(16))


@pytest.mark.parametrize("case", ["base", "row_stride", "column_stride"])
def test_tma_operand_misaligned_raises(case):
    if case == "base":  # one bf16 element past an aligned base
        t = torch.zeros(64 * 64 + 8, dtype=torch.bfloat16)[1:1 + 64 * 64].view(64, 64)
    elif case == "row_stride":  # rows of 68 bf16: 136 bytes
        t = torch.zeros((64, 68), dtype=torch.bfloat16)[:, :64]
    else:
        t = torch.zeros((128, 64), dtype=torch.int8).t()
    with pytest.raises(ValueError, match="TMA"):
        qmatmul.check_tma_operand("x", t)


def test_cpu_wrappers_take_the_plain_versions_unchanged():
    """The plan and checks sit on the CUDA branch only: a CPU call still
    runs the plain version, whatever its operands' alignment."""
    from diffusion_rs_tpu_torch.util.synthetic import random_qtensor

    gen = torch.Generator().manual_seed(0)
    qt = random_qtensor(gen, 256, 128, kind="q8t", device="cpu")
    x = torch.zeros(33 * 256 + 8, dtype=torch.bfloat16)[1:1 + 33 * 256].view(33, 256)
    x.copy_(torch.randn((33, 256), generator=gen).bfloat16())
    y = qmatmul.qmm_s8(x, qt, torch.bfloat16)
    assert torch.equal(y, qmatmul.qmm_s8_plain(x, qt.packed, qt.scale, torch.bfloat16))

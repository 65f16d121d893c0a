"""The launch plan and operand checks of the bf16 flash body (K3, K6, K7, K14).

``ops/flash.flash_plan`` is what the K3 / K14 and K6 / K7 wrappers check
their operands with before a launch: the blocks, the kv tile and ring, and
the rank-3 TMA maps ``csrc/flash_fwd.cu`` encodes; ``check_tma_operand`` is
what TMA demands of each operand. Host code only: these run on the CPU,
with no card and no kernel build.
"""

import numpy as np
import pytest
import torch

from diffusion_rs_tpu_torch.ops import flash, qmatmul

H = 24  # FLUX.1's heads of 128
N = H * 128
# FLUX.1-dev sequence lengths: joint attention at 1024x1024 (4096 image + 512
# text rows), a ragged one, config S's rows per rank, and tiny ones below a tile
SEQS = [4608, 4112, 2304, 130, 64, 1]
# seq-major projections: fused qkv (3 x 3072 columns) and the single blocks'
# qkv_mlp (3 x 3072 + 4 x 3072); q, k, v start at columns 0, 3072, 6144
FUSED_WIDTHS = [3 * N, 7 * N]


@pytest.mark.parametrize("s", SEQS)
def test_bhsd_plan_tiles(s):
    p = flash.flash_plan(1, H, s, s)
    assert p.grid == (-(-s // 128), H)
    assert p.kv_tiles == -(-s // 64) and (p.block_q, p.block_kv) == (128, 64)
    assert (p.stages, p.threads) == (4, 384) and p.smem_bytes <= 232448
    for name in "qkv":
        m = p.maps[name]
        # (128, S, B*H): a head is one plane, so a ragged box stops at S
        assert m.dims == (128, s, H) and m.strides == (256, s * 256)
        # q boxes of a block's rows, k / v boxes of a kv tile's; 64 columns
        # span the 128-byte swizzle
        assert m.box == ((128, 64) if name == "q" else (64, 64))
    assert [p.box_origin("q", 0, h) for h in range(3)] == [(0, 0), (0, 1), (0, 2)]


def test_plan_numbers_at_the_main_path_shape():
    """The numbers the source notes and PERF.md quote: 36 q blocks of each
    of 24 heads, 72 kv tiles, 160 KB of ring and q tile."""
    p = flash.flash_plan(1, 24, 4608, 4608)
    assert p.grid == (36, 24) and p.grid[0] * p.grid[1] == 864 and p.kv_tiles == 72
    assert p.smem_bytes == 1024 + 32768 + 4 * 32768 + 13 * 8
    assert flash.flash_plan(2, 24, 2304, 4608).grid == (18, 48)


@pytest.mark.parametrize("width", FUSED_WIDTHS)
@pytest.mark.parametrize("s", [4608, 4112, 1])
def test_seqmajor_slices_of_fused_projections(width, s):
    """q/k/v as column slices of one fused projection [1, S, width]: each map
    is (3072, S, 1) over rows of ``width`` columns, its base the slice's
    first column, and head h's box starts at column 128 h."""
    proj = torch.zeros((1, s, width), dtype=torch.bfloat16)
    ops = {name: proj[..., i * N:(i + 1) * N] for i, name in enumerate("qkv")}
    for name, t in ops.items():
        qmatmul.check_tma_operand(name, t)
    p = flash.flash_plan(1, H, s, s, "seqmajor",
                         strides={n: t.stride()[:2] for n, t in ops.items()},
                         bases={n: t.data_ptr() for n, t in ops.items()})
    for i, name in enumerate("qkv"):
        assert ops[name].data_ptr() - proj.data_ptr() == i * N * 2  # offsets 0 / 3072 / 6144
        assert p.maps[name].dims == (N, s, 1) and p.maps[name].strides == (width * 2, s * width * 2)
    cols = np.zeros(N, dtype=np.int32)
    for h in range(H):
        c0, plane = p.box_origin("k", 0, h)
        assert plane == 0
        cols[c0:c0 + 128] += 1  # two boxes of 64 columns
    assert (cols == 1).all()


@pytest.mark.parametrize("b", [1, 2])
def test_seqmajor_batch_strides(b):
    """Batch 2 takes the operand's batch stride; batch 1 ignores it."""
    x = torch.zeros((b, 300, 3 * 256), dtype=torch.bfloat16)
    ops = {name: x[..., i * 256:(i + 1) * 256] for i, name in enumerate("qkv")}
    p = flash.flash_plan(b, 2, 300, 300, "seqmajor",
                         strides={n: t.stride()[:2] for n, t in ops.items()},
                         bases={n: t.data_ptr() for n, t in ops.items()})
    assert p.maps["v"].strides == (768 * 2, 300 * 768 * 2)
    assert p.grid == (3, 2 * b) and [p.box_origin("v", bb, 1) for bb in range(b)] == [
        (128, bb) for bb in range(b)]


@pytest.mark.parametrize("case", ["head_dim", "row_stride", "column_offset", "narrow_rows",
                                  "no_kv", "layout"])
def test_plan_refuses_what_the_kernel_does_not_take(case):
    strides = {n: (4608 * 9216, 9216) for n in "qkv"}
    bases = {"q": 0, "k": 6144, "v": 12288}
    kw = dict(strides=strides, bases=bases)
    s_kv = 4608
    if case == "head_dim":
        with pytest.raises(NotImplementedError):
            flash.flash_plan(1, H, 4608, 4608, d=64)
        return
    if case == "row_stride":  # rows 9220 elements apart: 18440 bytes, not a multiple of 16
        strides["k"] = (4608 * 9220, 9220)
    elif case == "column_offset":  # a slice starting 3 columns in: 6 bytes past alignment
        bases["v"] = 12288 + 6
    elif case == "narrow_rows":  # rows narrower than 24 heads of 128
        strides["q"] = (4608 * 2048, 2048)
    elif case == "no_kv":
        s_kv = 0
    else:
        with pytest.raises(ValueError):
            flash.flash_plan(1, H, 4608, 4608, "bshd")
        return
    with pytest.raises(ValueError):
        flash.flash_plan(1, H, 4608, s_kv, "seqmajor", **kw)


@pytest.mark.parametrize("case", ["base", "row_stride", "column_stride"])
def test_tma_operand_rejects_misaligned_attention_operands(case):
    """The 3-D operands: every stride but the last must be 16-byte aligned."""
    x = torch.zeros((1, 64, 3 * 256 + 8), dtype=torch.bfloat16)
    if case == "base":
        t = x[..., 3:3 + 256]
    elif case == "row_stride":  # rows of 3 * 256 + 4 bf16: 1544 bytes
        t = torch.zeros((1, 64, 3 * 256 + 4), dtype=torch.bfloat16)[..., :256]
    else:
        t = torch.zeros((1, 256, 64), dtype=torch.bfloat16).transpose(1, 2)
    with pytest.raises(ValueError, match="TMA"):
        qmatmul.check_tma_operand("q", t)
    qmatmul.check_tma_operand("q", x[..., 256:512])  # a slice at column 256 is fine


def test_cpu_attention_takes_the_plain_version_whatever_the_alignment():
    """The plan and checks sit on the CUDA branch only: misaligned column
    slices on the CPU still run the plain versions."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((1, 40, 3 * 128 + 3), generator=gen).bfloat16()
    q, k, v = (x[..., 3 + i * 128:3 + (i + 1) * 128] for i in range(3))
    ce = torch.ones((1, 40, 128))
    se = torch.zeros((1, 40, 128))
    y = flash.flash_attention_fused(q, k, v, ce, se, 128, rope_in_kernel=False)
    assert torch.equal(y, flash.flash_sm_plain(q, k, v, 128, 128 ** -0.5))
    y7 = flash.flash_attention_fused(q, k, v, ce, se, 128, rope_in_kernel=True)
    assert torch.equal(y7, y)  # the identity rotation


@pytest.mark.parametrize("skv", [1, 63, 64, 65, 300])
def test_plain_blocks_are_the_kernel_kv_tiles(skv):
    """K3's plain version walks kv in the body's 64-row tiles: with one
    tile the online softmax is one exact softmax step, and a call with a
    larger block differs only past the first tile."""
    gen = torch.Generator().manual_seed(skv)
    q = torch.randn((1, 2, 7, 128), generator=gen)
    k, v = (torch.randn((1, 2, skv, 128), generator=gen) for _ in range(2))
    assert flash.BLOCK_K == flash.flash_plan(1, 2, 7, skv).block_kv == 64
    o = flash.flash_attention_plain(q, k, v, 0.1)
    o_one = flash.flash_attention_plain(q, k, v, 0.1, block_k=4096)
    if skv <= 64:
        assert torch.equal(o, o_one)
    else:
        assert torch.allclose(o, o_one, atol=1e-5)

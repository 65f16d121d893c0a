"""Fused dequantize-matmul: ``y = x @ deq(W)`` with W kept quantized.

Port of ``diffusion_rs_tpu/ops/qmatmul_pallas.py``. The dispatch mirrors
``quantized_matmul`` there exactly:

* :func:`supports` (qmatmul_pallas.py:300) decides whether a tensor fits the
  kernels at all; one that does not (FLUX ``final.proj``, N=64) takes the
  dequantize + matmul fallback, as JAX does at :421-431;
* a q8t tensor (:446-450) always takes the s8 x s8 kernel, since the JAX
  crossover default is 2^30 rows (:297);
* a 4-bit codebook tensor (nf4/fp4) takes the nf4 kernel;
* every other tensor without a codebook (the affine formats: GGUF
  Q4_0..Q8_K, bnb int8, ``w = q * scale + bias``) takes the affine kernel;
* with DIFFUSION_RS_TPU_QMM_FAST16 set and 16-bit activations (:466-471),
  the nf4 and affine kernels decode in bf16 arithmetic instead (K12, K13).

Each of K1, K2, K12, K4 and K13 also has an f32-output entry (``<name>_f32``,
``out_dtype=torch.float32``): the same kernel storing its f32 accumulators
uncast, which a row-parallel linear's partial product takes before its
all-reduce (ops/partitioned.py), as JAX's K-sharded rule runs the Pallas
kernel with an f32 output (partitioned.py:380-386).

Three hand-written Hopper kernel sources (``csrc/qmm_s8.cu``, ``csrc/qmm_nf4.cu``,
``csrc/qmm_affine.cu``) serve the CUDA path. Beside each is its plain PyTorch version, which follows
the Pallas math tile for tile. A wrapper given a CPU tensor runs the plain
version; given a CUDA tensor it launches the kernel or raises. All three
are fed by TMA: :func:`qmm_plan` is their launch plan (tiles, ring,
scratch layout) and :func:`check_tma_operand` the alignment their operands
need.

:func:`quantized_matmul_grouped` (``quantized_matmul_grouped`` at
qmatmul_pallas.py:664) runs several same-format ``[K, N]`` products in one
launch: K8, the grouped entry points of the q8t and affine kernels, and K11,
that of the nf4 kernel. Groups that differ in format, or a format the
kernels do not tile, take per-group :func:`quantized_matmul`, as JAX does.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import torch

from ..quant.qtensor import QuantizedTensor, dequantize, unpack4
from . import _cuda


def supports(qt: QuantizedTensor) -> bool:
    """Static check that the canonical tensor fits the kernels' tiling
    (same rule as the JAX ``supports``)."""
    k, n = qt.shape
    if qt.bits == 4 and qt.split % 2 != 0:
        return False
    bk = qt.split if qt.bits == 4 else min(256, k)
    if k % bk != 0 or bk % 8 != 0:
        return False
    if qt.group <= bk:
        if bk % qt.group != 0:
            return False
    elif qt.group % bk != 0:
        return False
    return n % 128 == 0


def q8t_ok(qt: QuantizedTensor) -> bool:
    """Whether the tensor runs the s8 x s8 path: one weight scale per
    (K-tile, column), K-tile = min(256, K)."""
    return (
        qt.kind == "q8t" and qt.bits == 8 and qt.bias is None
        and qt.codebook is None and qt.group == min(256, qt.k)
    )


def _codebook_ok(qt: QuantizedTensor) -> bool:
    return qt.bits == 4 and qt.codebook is not None and qt.bias is None


def dense_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``jnp.matmul(x, w, preferred_element_type=f32).astype(x.dtype)``."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dt), w.to(dt)).to(x.dtype)


# ---------------------------------------------------------------------------
# Launch plans of the TMA-fed kernels: K1 / K8-s8, K2 / K11 / K12 and
# K4 / K8-affine / K13
# ---------------------------------------------------------------------------


SMS = 132  # streaming multiprocessors of the H100 SXM the plans are made for


@dataclasses.dataclass(frozen=True)
class QmmPlan:
    """How ``csrc/qmm_s8.cu`` (``kind="s8"``: K1, K8-s8),
    ``csrc/qmm_nf4.cu`` (``"nf4"``: K2, K11, K12) or ``csrc/qmm_affine.cu``
    (``"affine"``: K4, K8-affine, K13) tiles one ``[M, K] x [K, N]``
    product; the numbers mirror the sources' constants. An output
    tile is ``block_m`` rows x ``block_n`` columns, computed by two consumer
    warpgroups that walk K through a ring of ``stages`` TMA stages of
    ``stage_k`` k values each; the kernels are persistent, min(tiles, SMs)
    blocks taking the tiles in order. ``sx_rows`` is the row count of the
    s8 path's activation-scale scratch ``[K / bk, sx_rows]``: M rounded up
    to ``block_m``, so that a tile's scales of one K-tile are one 512-byte
    copy (0 for nf4)."""

    kind: str
    m: int
    k: int
    n: int
    block_m: int
    block_n: int
    stage_k: int
    stages: int
    sx_rows: int

    @property
    def grid(self) -> Tuple[int, int]:
        """(column tiles, row tiles) of a one-group call of ``m`` rows."""
        return self.n // self.block_n, -(-self.m // self.block_m)

    def tiles(self) -> List[Tuple[int, int, int, int]]:
        """``(m0, n0, rows, cols)`` of every output tile, rows clipped to M."""
        gx, gy = self.grid
        return [(by * self.block_m, bx * self.block_n,
                 min(self.block_m, self.m - by * self.block_m), self.block_n)
                for by in range(gy) for bx in range(gx)]


def qmm_plan(kind: str, m: int, k: int, n: int, *, bk: Optional[int] = None,
             split: Optional[int] = None, group: Optional[int] = None,
             group_ms: Optional[Sequence[int]] = None, bits: Optional[int] = None) -> QmmPlan:
    """The launch plan of the q8t kernel (``kind="s8"``, K-tile ``bk``), the
    4-bit codebook kernel (``"nf4"``, ``split``, ``group``) or the affine
    kernel (``"affine"``, ``bits`` 4 or 8, ``split``, ``group``) for an
    ``[m, k] x [k, n]`` product, or for a grouped call whose groups have
    ``group_ms`` rows. Raises ValueError for a shape the kernel does not
    take.

    q8t tiles are 128 x 128 and stage 128 k where the K-tile allows (64
    for img_in's K = 64): at M4096 K3072 N3072, 768 tiles, 5.8 per SM of
    the card's 132. nf4 tiles are 128 columns by 256 rows where that still
    leaves four tiles per SM (M4608 N12288: 1728 tiles), else 128 rows (the
    T5 shapes, M512 N4096: 128 tiles).

    Affine tiles are 128 columns by 256 rows (int8 codes: four stages fit)
    or 192 (4-bit codes, whose stage carries four x slices: 192 rows keep
    three stages where 256 would leave two) where that still leaves two
    tiles per SM (every M4096 / M4608 product of FLUX: M4608 N3072 takes
    576 tiles of 192 rows, M4608 N21504 4032), else 128 rows (M512); where
    every group has at most 64 rows, by M rounded up to 8 (the wgmma N): the M1 modulation
    products issue m64n8k16 and are bound by their bytes, not their MMAs.
    There the column tiles fill the card: at M1 N18432 (the double blocks'
    modulation) 144 tiles meet 132 SMs, so 12 SMs stream a second tile; at
    N9216 (the single blocks') 72 blocks stream 128 columns each. A stage
    moves 64 code rows (128 k for 4-bit, 64 for int8) with their plane
    rows; the ring holds as many stages as 192 KB allow (3 at 192 rows, 4
    at 128 and at int8's 256, 6 to 8 at small M), so a small-M block keeps
    up to eight stages of codes in flight. ``stage_k`` is the k of one
    stage."""
    if kind == "s8":
        _require(k % 64 == 0 and bk % 64 == 0 and k % bk == 0 and n % 128 == 0,
                 f"qmm_s8 needs K, K-tile % 64 == 0 and N % 128 == 0 (K={k}, "
                 f"tile={bk}, N={n})")
        stage_k = 128 if bk % 128 == 0 else 64
        return QmmPlan("s8", m, k, n, block_m=128, block_n=128, stage_k=stage_k,
                       stages=6 if stage_k == 128 else 8, sx_rows=-(-m // 128) * 128)
    ms = [m] if group_ms is None else group_ms
    wide = sum(-(-mi // 256) for mi in ms) * (n // 128) >= 4 * SMS
    if kind == "nf4":
        _require(split % 64 == 0 and k % split == 0 and group % 32 == 0
                 and k % group == 0 and n % 128 == 0,
                 f"qmm_nf4 needs split % 64 == 0, group % 32 == 0 and N % 128 == 0 "
                 f"(split={split}, group={group}, N={n})")
        block_m = 256 if wide else 128
        return QmmPlan("nf4", m, k, n, block_m=block_m, block_n=128, stage_k=128,
                       stages=3 if wide else 4, sx_rows=0)
    if kind == "affine":
        _require(bits in (4, 8) and k % 64 == 0 and n % 128 == 0 and group % 16 == 0
                 and k % group == 0 and (bits == 8 or (split % 64 == 0 and k % split == 0)),
                 f"qmm_affine needs 4- or 8-bit codes, K % 64 == 0, N % 128 == 0, "
                 f"group % 16 == 0, K % group == 0 and a 4-bit split % 64 == 0 "
                 f"(bits={bits}, K={k}, N={n}, group={group}, split={split})")
        top = max(ms)
        big = 192 if bits == 4 else 256  # 4-bit: 192 rows, so that three stages fit
        if top <= 64:
            block_m = max(8, -(-top // 8) * 8)
        elif sum(-(-mi // big) for mi in ms) * (n // 128) >= 2 * SMS:
            block_m = big
        else:
            block_m = 128
        slices = 4 if bits == 4 else 2  # x slices of 32 k per stage
        stage_bytes = slices * block_m * 64 + 64 * 128 + 2 * 8 * 512
        return QmmPlan("affine", m, k, n, block_m=block_m, block_n=128,
                       stage_k=128 if bits == 4 else 64,
                       stages=min(8, 196608 // stage_bytes), sx_rows=0)
    raise ValueError(f"qmm_plan: no TMA-fed kernel of kind {kind!r}")


TMA_ALIGN = 16  # bytes


def check_tma_operand(name: str, t: torch.Tensor) -> None:
    """Raise unless ``t`` can be read by TMA (and by K1's quantize pass,
    which loads 16 bytes per lane): a 16-byte aligned base and, for a
    matrix or a stack of them, 16-byte aligned strides over every dimension
    but the last, which has unit stride."""
    base = t.data_ptr() % TMA_ALIGN
    outer = [s * t.element_size() for s, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1]
    unit = t.dim() < 2 or t.stride(-1) == 1
    if base or any(s % TMA_ALIGN for s in outer) or not unit:
        raise ValueError(f"{name}: TMA needs a {TMA_ALIGN}-byte aligned base and row "
                         f"stride (base {base} bytes past alignment, strides "
                         f"{[s * t.element_size() for s in t.stride()]} bytes, column "
                         f"stride {t.stride(-1)})")


# ---------------------------------------------------------------------------
# K1: s8 x s8 -> s32 (q8t)
# ---------------------------------------------------------------------------


def qmm_s8_plain(x2: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                 out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of the q8t kernel, K-tile by K-tile as the Pallas s8
    branch (qmatmul_pallas.py:144-151): per row, ``sx = max|x| / 127``
    (1 where the row is 0), ``xq = round_half_even(x / sx)``, an integer dot
    with the int8 plane, then ``acc += i32 * (sx * scale[kt])`` in f32.
    The integer dot runs in float64, where every partial sum is exact."""
    m, k = x2.shape
    n = packed.shape[-1]
    bk = k // scale.shape[0]
    acc = torch.zeros((m, n), dtype=torch.float32, device=x2.device)
    for kt in range(k // bk):
        x = x2[:, kt * bk:(kt + 1) * bk].float()
        ax = x.abs().amax(dim=1, keepdim=True)
        # Divide by a tensor: PyTorch's CUDA division by a Python scalar
        # multiplies by its reciprocal, which is not the IEEE quotient.
        sx = torch.where(ax == 0.0, torch.ones_like(ax),
                         ax / torch.full_like(ax, 127.0))
        xq = torch.round(x / sx)
        prod = (xq.double() @ packed[kt * bk:(kt + 1) * bk].double()).float()
        acc = acc + prod * (sx * scale[kt][None, :])
    return acc.to(out_dtype)


# Output dtypes of the single-product entries (bf16, or f32 through the
# "_f32" entry) and of the grouped ones (bf16 only)
OUT_DTYPES = (torch.bfloat16, torch.float32)
GROUPED_OUT = (torch.bfloat16,)


def _check_out(name: str, x2: torch.Tensor, out_dtype, outs) -> None:
    _require(x2.dtype == torch.bfloat16 and out_dtype in outs,
             f"{name} takes bf16 activations and produces "
             f"{' or '.join(str(d).removeprefix('torch.') for d in outs)}, not {out_dtype}")


def _entry_name(name: str, out_dtype) -> str:
    """The entry point of kernel ``name`` that stores ``out_dtype``."""
    return f"{name}_f32" if out_dtype == torch.float32 else name


def _check_s8(name: str, x2: torch.Tensor, qt: QuantizedTensor, out_dtype,
              device=None, outs=OUT_DTYPES) -> QmmPlan:
    """What K1 takes (K8-s8 checks each group with it): bf16 x [M, K] on
    ``device`` (any CUDA device when None), the q8t planes beside it, each
    aligned for TMA, and an output dtype of ``outs``. Returns the launch
    plan."""
    m, k = x2.shape
    n, bk = qt.n, qt.group
    _check_out(name, x2, out_dtype, outs)
    plan = qmm_plan("s8", m, k, n, bk=bk)
    _check_cuda(x2, (m, k), torch.bfloat16, "x", device)
    _check_cuda(qt.packed, (k, n), torch.int8, "packed", x2.device)
    _check_cuda(qt.scale, (k // bk, n), torch.float32, "scale", x2.device)
    for nm, t in (("x", x2), ("packed", qt.packed), ("scale", qt.scale)):
        check_tma_operand(nm, t)
    return plan


def _s8_scratch(x2: torch.Tensor, plan: QmmPlan, bk: int):
    """K1's scratch for one group: the int8 copy of x [M, K] and the
    transposed activation scales [K / bk, sx_rows]."""
    xq = torch.empty((plan.m, plan.k), dtype=torch.int8, device=x2.device)
    sx = torch.empty((plan.k // bk, plan.sx_rows), dtype=torch.float32, device=x2.device)
    return xq, sx


def qmm_s8(x2: torch.Tensor, qt: QuantizedTensor,
           out_dtype: torch.dtype) -> torch.Tensor:
    """``x2 [M, K] @ deq(q8t W) [K, N]`` through ``csrc/qmm_s8.cu``."""
    if x2.device.type == "cpu":
        return qmm_s8_plain(x2, qt.packed, qt.scale, out_dtype)
    plan = _check_s8("qmm_s8", x2, qt, out_dtype)
    m, k = x2.shape
    n, bk = qt.n, qt.group
    xq, sx = _s8_scratch(x2, plan, bk)
    out = torch.empty((m, n), dtype=out_dtype, device=x2.device)
    _cuda.launch(_entry_name("qmm_s8", out_dtype), x2.data_ptr(), xq.data_ptr(), sx.data_ptr(),
                 qt.packed.data_ptr(), qt.scale.data_ptr(), out.data_ptr(),
                 m, k, n, bk, device=x2.device)
    return out


# ---------------------------------------------------------------------------
# K2: 4-bit codebook (nf4/fp4) decode + bf16 MMA
# ---------------------------------------------------------------------------


def qmm_dequant_plain(x2: torch.Tensor, qt: QuantizedTensor,
                      out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of the dequantizing branches, K2 and K4
    (qmatmul_pallas.py:57-120, :153-169): decode in f32 (codebook or code,
    times the scale of row ``k // group``, plus its bias: the ``w * scale;
    w + bias`` order of ``_dequant_tile``, for groups inside a K-tile and
    for group = K alike), round the weight to the activation dtype, dot with
    f32 accumulation."""
    w = dequantize(qt, torch.float32).to(x2.dtype)
    return (x2.float() @ w.float()).to(out_dtype)


def _check_nf4(name: str, x2: torch.Tensor, qt: QuantizedTensor, out_dtype,
               device=None, outs=OUT_DTYPES) -> QmmPlan:
    """What K2 takes (K11 checks each group with it): bf16 x [M, K] on
    ``device`` (any CUDA device when None), the 4-bit codebook planes beside
    it, each aligned for TMA, and an output dtype of ``outs``. Returns the
    launch plan."""
    m, k = x2.shape
    n = qt.n
    _check_out(name, x2, out_dtype, outs)
    _require(_codebook_ok(qt), f"{name} takes 4-bit codebook codes without a bias ({qt.kind})")
    plan = qmm_plan("nf4", m, k, n, split=qt.split, group=qt.group)
    _check_cuda(x2, (m, k), torch.bfloat16, "x", device)
    _check_cuda(qt.packed, (k // 2, n), torch.uint8, "packed", x2.device)
    _check_cuda(qt.scale, (k // qt.group, n), torch.float32, "scale", x2.device)
    _check_cuda(qt.codebook, (16,), torch.float32, "codebook", x2.device)
    for nm, t in (("x", x2), ("packed", qt.packed), ("scale", qt.scale)):
        check_tma_operand(nm, t)
    return plan


def qmm_nf4(x2: torch.Tensor, qt: QuantizedTensor,
            out_dtype: torch.dtype) -> torch.Tensor:
    """``x2 [M, K] @ deq(nf4 W) [K, N]`` through ``csrc/qmm_nf4.cu``."""
    if x2.device.type == "cpu":
        return qmm_dequant_plain(x2, qt, out_dtype)
    plan = _check_nf4("qmm_nf4", x2, qt, out_dtype)
    m, k = x2.shape
    n = qt.n
    out = torch.empty((m, n), dtype=out_dtype, device=x2.device)
    if m == 0:
        return out
    _cuda.launch(_entry_name("qmm_nf4", out_dtype), x2.data_ptr(), qt.packed.data_ptr(),
                 qt.scale.data_ptr(), qt.codebook.data_ptr(), out.data_ptr(),
                 m, k, n, qt.split, qt.group, plan.block_m, device=x2.device)
    return out


# ---------------------------------------------------------------------------
# K4: affine 4/8-bit decode (GGUF, bnb int8) + bf16 MMA
# ---------------------------------------------------------------------------


def _check_affine(name: str, x2: torch.Tensor, qt: QuantizedTensor, out_dtype,
                  device=None, outs=OUT_DTYPES) -> QmmPlan:
    """What K4 takes (K8-affine checks each group with it): bf16 x [M, K] on
    ``device`` (any CUDA device when None), the affine planes beside it,
    each aligned for TMA, and an output dtype of ``outs``. Returns the
    launch plan."""
    m, k = x2.shape
    n = qt.n
    _check_out(name, x2, out_dtype, outs)
    _require(qt.codebook is None and qt.bits in (4, 8),
             f"{name} takes 4- or 8-bit codes without a codebook ({qt.kind})")
    plan = qmm_plan("affine", m, k, n, bits=qt.bits, split=qt.split, group=qt.group)
    _check_cuda(x2, (m, k), torch.bfloat16, "x", device)
    if qt.bits == 4:
        _check_cuda(qt.packed, (k // 2, n), torch.uint8, "packed", x2.device)
    else:
        _check_cuda(qt.packed, (k, n), torch.int8, "packed", x2.device)
    _check_cuda(qt.scale, (k // qt.group, n), torch.float32, "scale", x2.device)
    operands = [("x", x2), ("packed", qt.packed), ("scale", qt.scale)]
    if qt.bias is not None:
        _check_cuda(qt.bias, (k // qt.group, n), torch.float32, "bias", x2.device)
        operands.append(("bias", qt.bias))
    for nm, t in operands:
        check_tma_operand(nm, t)
    return plan


def qmm_affine(x2: torch.Tensor, qt: QuantizedTensor,
               out_dtype: torch.dtype) -> torch.Tensor:
    """``x2 [M, K] @ deq(affine W) [K, N]`` through ``csrc/qmm_affine.cu``."""
    if x2.device.type == "cpu":
        return qmm_dequant_plain(x2, qt, out_dtype)
    plan = _check_affine("qmm_affine", x2, qt, out_dtype)
    m, k = x2.shape
    n = qt.n
    out = torch.empty((m, n), dtype=out_dtype, device=x2.device)
    if m == 0:
        return out
    _cuda.launch(_entry_name("qmm_affine", out_dtype), x2.data_ptr(), qt.packed.data_ptr(),
                 qt.scale.data_ptr(),
                 None if qt.bias is None else qt.bias.data_ptr(),
                 out.data_ptr(), m, k, n, qt.bits, qt.split, qt.group, plan.block_m,
                 device=x2.device)
    return out


# ---------------------------------------------------------------------------
# K12 / K13: the fast16 decode (DIFFUSION_RS_TPU_QMM_FAST16) of K2 and K4
# ---------------------------------------------------------------------------


def fast16_enabled(x: torch.Tensor) -> bool:
    """The JAX package's opt-in 16-bit decode (qmatmul_pallas.py:466-471):
    on when DIFFUSION_RS_TPU_QMM_FAST16 is set to anything non-empty and the
    activations are a 2-byte dtype; read at every call, as JAX reads it at
    every trace. q8t (K1) and the grouped calls (K8, K11) never take it."""
    return x.element_size() == 2 and bool(os.environ.get("DIFFUSION_RS_TPU_QMM_FAST16"))


def dequantize_fast16(qt: QuantizedTensor, dtype: torch.dtype) -> torch.Tensor:
    """``_dequant_tile``'s fast16 decode (qmatmul_pallas.py:72-120) of the
    whole ``[K, N]`` weight in the 16-bit ``dtype``, rounded after every op:

    * codebook: the entry in ``dtype`` times the scale in ``dtype``;
    * affine with a bias: ``off = where(s == 0, 0, b / where(s == 0, 1, s))``
      (f32, IEEE quotient) and ``b' = where(s == 0, b, 0)``, both then in
      ``dtype``; ``w = ((q + off) * s) + b'`` (the centred form: for Q4_0
      the offset is the exact integer -8);
    * affine without a bias: ``q * s``.

    The codes are exact in ``dtype`` (|q| <= 128). Per-layer ``[K, N]``
    weights only, as quantized_matmul passes them."""
    k, n = qt.shape
    q = unpack4(qt.packed, qt.split) if qt.bits == 4 else qt.packed
    _require(q.shape == (k, n), f"dequantize_fast16 takes a [K, N] weight, got {tuple(q.shape)}")
    s = qt.scale.float()
    w = qt.codebook.to(dtype)[q.long()] if qt.codebook is not None else q.to(dtype)
    w = w.reshape(k // qt.group, qt.group, n)
    plane = (k // qt.group, 1, n)
    if qt.codebook is None and qt.bias is not None:
        b = qt.bias.float()
        zero = s == 0
        off = torch.where(zero, torch.zeros_like(s), b / torch.where(zero, torch.ones_like(s), s))
        w = w + off.to(dtype).reshape(plane)
        w = w * s.to(dtype).reshape(plane)
        w = w + torch.where(zero, b, torch.zeros_like(b)).to(dtype).reshape(plane)
    else:
        w = w * s.to(dtype).reshape(plane)
        if qt.bias is not None:
            w = w + qt.bias.to(dtype).reshape(plane)
    return w.reshape(k, n)


def qmm_dequant_fast16_plain(x2: torch.Tensor, qt: QuantizedTensor,
                             out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of K12 and K13: :func:`dequantize_fast16` in the
    activation dtype, then the dot with f32 accumulation."""
    w = dequantize_fast16(qt, x2.dtype)
    return (x2.float() @ w.float()).to(out_dtype)


def qmm_nf4_fast16(x2: torch.Tensor, qt: QuantizedTensor,
                   out_dtype: torch.dtype) -> torch.Tensor:
    """K12: ``x2 [M, K] @ deq16(nf4/fp4 W) [K, N]`` through
    ``csrc/qmm_nf4.cu`` (``qmm_nf4_fast16``), K2 with the fast16 decode."""
    if x2.device.type == "cpu":
        return qmm_dequant_fast16_plain(x2, qt, out_dtype)
    plan = _check_nf4("qmm_nf4_fast16", x2, qt, out_dtype)
    m, k = x2.shape
    out = torch.empty((m, qt.n), dtype=out_dtype, device=x2.device)
    if m == 0:
        return out
    _cuda.launch(_entry_name("qmm_nf4_fast16", out_dtype), x2.data_ptr(), qt.packed.data_ptr(),
                 qt.scale.data_ptr(), qt.codebook.data_ptr(), out.data_ptr(),
                 m, k, qt.n, qt.split, qt.group, plan.block_m, device=x2.device)
    return out


def qmm_affine_fast16(x2: torch.Tensor, qt: QuantizedTensor,
                      out_dtype: torch.dtype) -> torch.Tensor:
    """K13: ``x2 [M, K] @ deq16(affine W) [K, N]`` through
    ``csrc/qmm_affine.cu`` (``qmm_affine_fast16``), K4 with the fast16
    decode and K4's plan (scale groups of a multiple of 16 rows)."""
    if x2.device.type == "cpu":
        return qmm_dequant_fast16_plain(x2, qt, out_dtype)
    plan = _check_affine("qmm_affine_fast16", x2, qt, out_dtype)
    m, k = x2.shape
    out = torch.empty((m, qt.n), dtype=out_dtype, device=x2.device)
    if m == 0:
        return out
    _cuda.launch(_entry_name("qmm_affine_fast16", out_dtype), x2.data_ptr(), qt.packed.data_ptr(),
                 qt.scale.data_ptr(),
                 None if qt.bias is None else qt.bias.data_ptr(),
                 out.data_ptr(), m, k, qt.n, qt.bits, qt.split, qt.group, plan.block_m,
                 device=x2.device)
    return out


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def quantized_matmul(x: torch.Tensor, qt: QuantizedTensor,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x [..., K] @ deq(qt) [K, N] -> [..., N]`` with the weight staying
    packed. Shapes the kernels do not tile take dequantize + matmul. With
    DIFFUSION_RS_TPU_QMM_FAST16 set and 16-bit activations, the codebook and
    affine formats decode in 16-bit arithmetic (K12, K13)."""
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    k, n = qt.shape
    x2 = x.reshape(-1, k).contiguous()
    fast16 = fast16_enabled(x)
    if not supports(qt):
        w = dequantize(qt, x.dtype)
        y = torch.matmul(x2.float(), w.float()).to(out_dtype)
    elif q8t_ok(qt):
        y = qmm_s8(x2, qt, out_dtype)
    elif _codebook_ok(qt):
        y = (qmm_nf4_fast16 if fast16 else qmm_nf4)(x2, qt, out_dtype)
    elif qt.codebook is None:
        y = (qmm_affine_fast16 if fast16 else qmm_affine)(x2, qt, out_dtype)
    elif x2.device.type == "cpu":
        y = (qmm_dequant_fast16_plain if fast16 else qmm_dequant_plain)(x2, qt, out_dtype)
    else:
        raise NotImplementedError(
            f"quantized_matmul: no CUDA kernel for a {qt.bits}-bit codebook "
            f"tensor with a bias ({qt.kind})")
    return y.reshape(*lead, n)


# ---------------------------------------------------------------------------
# K8 / K11: grouped products (s8, affine and codebook branches)
# ---------------------------------------------------------------------------

MAX_GROUPS = 8  # group-table capacity of one launch (csrc/qmm_s8.cu, qmm_nf4.cu, qmm_affine.cu)


def grouped_plan(qts: Sequence[QuantizedTensor]) -> Optional[str]:
    """Which grouped branch serves these weights ("s8", "affine" or
    "codebook"), or None when the call must run per group: the groups differ
    in shape, format kind/bits/group/split or bias/codebook presence (the
    JAX ``same`` test, qmatmul_pallas.py:677-684), or the kernels do not
    tile the format (``supports``; the TPU VMEM planner is not ported)."""
    q0 = qts[0]
    same = all(
        tuple(qt.shape) == tuple(q0.shape) and qt.kind == q0.kind and qt.bits == q0.bits
        and qt.group == q0.group and qt.split == q0.split
        and (qt.bias is None) == (q0.bias is None)
        and (qt.codebook is None) == (q0.codebook is None)
        for qt in qts
    )
    if not same or not supports(q0):
        return None
    if q8t_ok(q0):
        return "s8"
    return "affine" if q0.codebook is None else "codebook"


def qmm_grouped_plain(x2s: Sequence[torch.Tensor], qts: Sequence[QuantizedTensor],
                      out_dtype: torch.dtype) -> List[torch.Tensor]:
    """Plain version of K8 and K11: the per-group plain K1, K4 or K2 (the
    affine and codebook formats take the same dequantizing plain version)."""
    if q8t_ok(qts[0]):
        return [qmm_s8_plain(x, qt.packed, qt.scale, out_dtype) for x, qt in zip(x2s, qts)]
    return [qmm_dequant_plain(x, qt, out_dtype) for x, qt in zip(x2s, qts)]


def _table(rows) -> ctypes.Array:
    flat = [int(v) for row in rows for v in row]
    return (ctypes.c_int64 * len(flat))(*flat)


def qmm_grouped_s8(x2s: Sequence[torch.Tensor], qts: Sequence[QuantizedTensor],
                   out_dtype: torch.dtype) -> List[torch.Tensor]:
    """``[x_g [M_g, K] @ deq(q8t W_g) [K, N]]`` in one launch of each pass of
    ``qmm_grouped_s8`` (``csrc/qmm_s8.cu``), at most 8 groups."""
    if x2s[0].device.type == "cpu":
        return qmm_grouped_plain(x2s, qts, out_dtype)
    _require(1 <= len(x2s) <= MAX_GROUPS, f"qmm_grouped_s8 takes 1..{MAX_GROUPS} groups")
    _require(grouped_plan(qts) == "s8", "qmm_grouped_s8 takes groups of one q8t format")
    k, n = qts[0].shape
    bk = qts[0].group
    rows, outs, keep = [], [], []
    for x2, qt in zip(x2s, qts):
        plan = _check_s8("qmm_grouped_s8", x2, qt, out_dtype, x2s[0].device, GROUPED_OUT)
        m = x2.shape[0]
        xq, sx = _s8_scratch(x2, plan, bk)
        out = torch.empty((m, n), dtype=torch.bfloat16, device=x2.device)
        keep += [xq, sx]  # alive until the launch: the table holds bare pointers
        outs.append(out)
        rows.append((x2.data_ptr(), xq.data_ptr(), sx.data_ptr(), qt.packed.data_ptr(),
                     qt.scale.data_ptr(), out.data_ptr(), m))
    table = _table(rows)
    _cuda.launch("qmm_grouped_s8", ctypes.addressof(table), len(rows), k, n, bk,
                 device=x2s[0].device)
    return outs


def qmm_grouped_affine(x2s: Sequence[torch.Tensor], qts: Sequence[QuantizedTensor],
                       out_dtype: torch.dtype) -> List[torch.Tensor]:
    """``[x_g [M_g, K] @ deq(affine W_g) [K, N]]`` in one launch of
    ``qmm_grouped_affine`` (``csrc/qmm_affine.cu``), at most 8 groups."""
    if x2s[0].device.type == "cpu":
        return qmm_grouped_plain(x2s, qts, out_dtype)
    _require(1 <= len(x2s) <= MAX_GROUPS, f"qmm_grouped_affine takes 1..{MAX_GROUPS} groups")
    _require(grouped_plan(qts) == "affine",
             "qmm_grouped_affine takes groups of one affine format")
    q0 = qts[0]
    k, n = q0.shape
    rows, outs = [], []
    for x2, qt in zip(x2s, qts):
        _check_affine("qmm_grouped_affine", x2, qt, out_dtype, x2s[0].device, GROUPED_OUT)
        m = x2.shape[0]
        out = torch.empty((m, n), dtype=torch.bfloat16, device=x2.device)
        outs.append(out)
        rows.append((x2.data_ptr(), qt.packed.data_ptr(), qt.scale.data_ptr(),
                     0 if qt.bias is None else qt.bias.data_ptr(), out.data_ptr(), m))
    table = _table(rows)
    plan = qmm_plan("affine", rows[0][5], k, n, bits=q0.bits, split=q0.split,
                    group=q0.group, group_ms=[r[5] for r in rows])
    _cuda.launch("qmm_grouped_affine", ctypes.addressof(table), len(rows), k, n, q0.bits,
                 q0.split, q0.group, int(q0.bias is not None), plan.block_m,
                 device=x2s[0].device)
    return outs


def qmm_grouped_nf4(x2s: Sequence[torch.Tensor], qts: Sequence[QuantizedTensor],
                    out_dtype: torch.dtype) -> List[torch.Tensor]:
    """``[x_g [M_g, K] @ deq(nf4/fp4 W_g) [K, N]]`` in one launch of
    ``qmm_grouped_nf4`` (K11, ``csrc/qmm_nf4.cu``), at most 8 groups. Its
    plain version is the per-group K2 plain version (there is no fast16
    mode: JAX passes ``fast16=False`` to every grouped call)."""
    if x2s[0].device.type == "cpu":
        return qmm_grouped_plain(x2s, qts, out_dtype)
    _require(1 <= len(x2s) <= MAX_GROUPS, f"qmm_grouped_nf4 takes 1..{MAX_GROUPS} groups")
    _require(grouped_plan(qts) == "codebook",
             "qmm_grouped_nf4 takes groups of one 4-bit codebook format")
    q0 = qts[0]
    k, n = q0.shape
    rows, outs = [], []
    for x2, qt in zip(x2s, qts):
        _check_nf4("qmm_grouped_nf4", x2, qt, out_dtype, x2s[0].device, GROUPED_OUT)
        m = x2.shape[0]
        out = torch.empty((m, n), dtype=torch.bfloat16, device=x2.device)
        outs.append(out)
        rows.append((x2.data_ptr(), qt.packed.data_ptr(), qt.scale.data_ptr(),
                     qt.codebook.data_ptr(), out.data_ptr(), m))
    table = _table(rows)
    plan = qmm_plan("nf4", rows[0][5], k, n, split=q0.split, group=q0.group,
                    group_ms=[r[5] for r in rows])
    _cuda.launch("qmm_grouped_nf4", ctypes.addressof(table), len(rows), k, n, q0.split,
                 q0.group, plan.block_m, device=x2s[0].device)
    return outs


def quantized_matmul_grouped(xs: Sequence[torch.Tensor], qts: Sequence[QuantizedTensor],
                             out_dtype: Optional[torch.dtype] = None) -> List[torch.Tensor]:
    """Grouped ``[x_g @ deq(qt_g) for g]``: one K8 / K11 launch per 8 groups when
    :func:`grouped_plan` finds a grouped branch, else per-group
    :func:`quantized_matmul`. x_g [..., K] -> [..., N]."""
    assert len(xs) == len(qts) and len(xs) >= 2
    k, n = qts[0].shape
    out_dtype = out_dtype or xs[0].dtype
    plan = grouped_plan(qts)
    if plan is None:
        return [quantized_matmul(x, qt, out_dtype) for x, qt in zip(xs, qts)]
    x2s = [x.reshape(-1, k).contiguous() for x in xs]
    ys: List[torch.Tensor] = []
    for i in range(0, len(x2s), MAX_GROUPS):
        xg, qg = x2s[i:i + MAX_GROUPS], qts[i:i + MAX_GROUPS]
        grouped = {"s8": qmm_grouped_s8, "affine": qmm_grouped_affine,
                   "codebook": qmm_grouped_nf4}[plan]
        ys += grouped(xg, qg, out_dtype)
    return [y.reshape(*x.shape[:-1], n) for x, y in zip(xs, ys)]


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_cuda(t: torch.Tensor, shape, dtype, name: str, device=None) -> None:
    if t.device.type != "cuda" or (device is not None and t.device != device):
        where = "a CUDA device" if device is None else f"the CUDA device {device}"
        raise ValueError(f"{name} must be on {where}, got {t.device}")
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")

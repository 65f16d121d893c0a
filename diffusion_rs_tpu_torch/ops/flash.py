"""Blockwise flash attention (forward), port of ``ops/flash_pallas.py``.

Three Pallas kernels are replaced by entry points of the hand-written Hopper
kernel ``csrc/flash_fwd.cu`` (one bf16 body: TMA into an mbarrier ring, a
producer warp and two consumer warpgroups on ``wgmma``; online softmax with
f32 running max/sum/accumulator, ragged kv masked to -1e30, each head's
output written straight into its column slice of ``[B, S, H*D]``):

* K3 ``flash_fwd`` (``_flash_kernel``, bf16, ``seq_out``): q/k/v [B, H, S, D];
* K6 ``flash_sm`` (``_flash_sm_kernel``): seq-major q/k/v [B, S, H*D], each
  head a column slice;
* K7 ``flash_rope`` (``_flash_rope_kernel``): the pass ``rope_qk`` rotates q
  and k (half-split RoPE from the expanded tables) once into scratch
  tensors, then K6's body runs on them.

:func:`flash_plan` is the bf16 body's launch plan (blocks, kv tile, ring,
tensor maps) and raises on operands it does not take; every operand also
passes :func:`~.qmatmul.check_tma_operand`.

The int8 modes of ``_flash_kernel`` (``s8`` and ``s8_pv``) are a second
kernel body of the same design in the same source (int8 ``wgmma``; kv tiles
of 128 rows under ``s8_pv``, with two QK^T passes per quantization block,
else 64), with three entry points: K9 ``flash_s8`` (s8 x s8 QK^T), K10
``flash_s8pv`` (s8 x s8 P.V) and ``flash_s8_s8pv`` (both);
:func:`int8_flash_plan` is its launch plan. Their prepass is the kernel ``flash_quant`` (``csrc/flash_quant.cu``,
one launch for k and v, :func:`quantize_kv`); its plain versions,
:func:`quantize_k`, :func:`quantize_v` and :func:`v_kernel_layout`, run on
the CPU, as JAX leaves the prepass to XLA.

K14 is ``_flash_kernel``'s ``save_lse`` output, which ring attention
(ops/partitioned.py) merges chunks with: both bodies take it as a template
flag, compiled out of K3 / K9 / K10, behind four more entry points
(``flash_fwd_lse``, ``flash_s8_lse``, ``flash_s8pv_lse``,
``flash_s8_s8pv_lse``) that also write each q row's ``m + log(l)`` in f32
[B, H, Sq] (``flash_attention(..., save_lse=True)``).

Beside the kernels are the plain PyTorch versions, which follow the same
per-kv-block online softmax (blocks of the kernels' kv tiles): ``l`` sums
the f32 ``p`` while P.V uses ``p`` cast to the value dtype. A CPU tensor
takes the plain version; a CUDA tensor takes the kernel or raises. The TPU
tiling machinery (``DEFAULT_BLOCK_Q/K``, VMEM planning) and the diagnostic
ablation knobs are not ported.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _cuda
from .qmatmul import check_tma_operand
from .rope import apply_rope_halfsplit

_NEG_INF = -1e30
# kv rows per block of the CUDA kernels (both bodies); the plain versions use
# the same blocking by default so the two accumulate in the same order of
# blocks (the same block maxima, so the same bf16 p).
BLOCK_K = 64
HEAD_DIM = 128
# The int8 modes' quantization block is JAX's kv block, min(1536,
# round_up(Skv, 128)) (flash_pallas.py:763). It is a numerics knob, not a
# tile: it sets how many kv rows share one k / v scale and, under s8_pv, the
# rows whose row max p is quantized against. The kernels keep it whatever
# kv tile they loop over, so s8pv_dropped_mass describes them too.
QUANT_BLOCK_K = 1536
_LOG127 = 4.844187086458591  # ln(127): folds the int8 scale of p into the exp
# entry point of csrc/flash_fwd.cu per (s8, s8_pv)
INT8_ENTRIES = {(True, False): "flash_s8", (False, True): "flash_s8pv",
                (True, True): "flash_s8_s8pv"}
# the same modes with the per-row log-sum-exp (K14)
INT8_LSE_ENTRIES = {mode: f"{name}_lse" for mode, name in INT8_ENTRIES.items()}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float, block_k: int = BLOCK_K) -> torch.Tensor:
    """[B, H, Sq, D] x3 -> [B, H, Sq, D], kv block by kv block."""
    return flash_attention_lse_plain(q, k, v, scale, block_k)[0]


def flash_attention_lse_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              scale: float, block_k: int = BLOCK_K):
    """Plain version of K3 and of K14's bf16 entry: [B, H, Sq, D] x3 -> (o
    [B, H, Sq, D] in q's dtype, lse f32 [B, H, Sq]), the online softmax's
    ``m + log(l)`` with ``l == 0 -> 1`` (``_finalize``)."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    qf = q.float()
    m = torch.full((b, h, sq, 1), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, v.shape[-1]), dtype=torch.float32, device=q.device)
    for j in range(0, skv, block_k):
        kb = k[:, :, j:j + block_k].float()
        vb = v[:, :, j:j + block_k]
        s = (qf @ kb.transpose(-1, -2)) * scale
        m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_next)
        p = torch.exp(s - m_next)
        pv = p.to(v.dtype).float() @ vb.float()
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + pv
        m = m_next
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc * (1.0 / l_safe)).to(q.dtype), (m + torch.log(l_safe))[..., 0]


# ---------------------------------------------------------------------------
# The bf16 body's launch plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TmaMap:
    """One operand's rank-3 tensor map as ``csrc/flash_fwd.cu`` encodes it:
    ``dims`` innermost first (columns, rows, planes), the byte strides of a
    row and of a plane, and the box (rows, columns, in elements: 64 bf16 or
    128 int8 columns, the 128-byte swizzle span). Reads outside ``dims``
    come back zero, so a box never reads into the next head or batch."""

    dims: Tuple[int, int, int]
    strides: Tuple[int, int]
    box: Tuple[int, int]


@dataclasses.dataclass(frozen=True)
class FlashPlan:
    """How the bf16 body tiles one call: blocks of ``block_q`` q rows of one
    (batch, head), ``threads`` threads (a producer warpgroup and two consumer
    warpgroups of 64 rows), kv tiles of ``block_kv`` rows through a ring of
    ``stages``; the numbers mirror the source's constants. ``maps`` holds
    the q, k and v tensor maps: over (128, S, B*H) for ``bhsd`` (K3, K14),
    over (H*128, S, B) with the operand's strides for ``seqmajor`` (K6, K7;
    a column slice's offset lies in its base pointer)."""

    layout: str
    b: int
    h: int
    s_q: int
    s_kv: int
    maps: Dict[str, TmaMap]
    block_q: int = 128
    block_kv: int = BLOCK_K
    stages: int = 4
    threads: int = 384
    smem_bytes: int = 1024 + 2 * 128 * 128 + 4 * 2 * 2 * 64 * 128 + 13 * 8

    @property
    def grid(self) -> Tuple[int, int]:
        """(q blocks, batch * heads)."""
        return -(-self.s_q // self.block_q), self.b * self.h

    @property
    def kv_tiles(self) -> int:
        return -(-self.s_kv // self.block_kv)

    def box_origin(self, name: str, b: int, h: int) -> Tuple[int, int]:
        """(first column, plane) of head ``h`` of batch ``b`` in ``name``'s map."""
        if self.layout == "bhsd":
            return 0, b * self.h + h
        return h * HEAD_DIM, b


def flash_plan(b: int, h: int, s_q: int, s_kv: int, layout: str = "bhsd", *,
               d: int = HEAD_DIM, strides: Optional[Dict[str, Sequence[int]]] = None,
               bases: Optional[Dict[str, int]] = None) -> FlashPlan:
    """The bf16 body's plan for ``b`` x ``h`` heads of ``s_q`` q rows over
    ``s_kv`` kv rows. ``layout`` is ``"bhsd"`` (contiguous [B, H, S, 128]) or
    ``"seqmajor"`` ([B, S, H*128] rows with ``strides[name] = (batch, row)``
    in elements and ``bases[name]`` the data pointer, for q, k and v).
    Raises NotImplementedError for a head dim other than 128 and ValueError
    for what TMA cannot read: a row or batch stride that is not a multiple
    of 16 bytes, rows narrower than the heads, a base (a column slice) off
    16-byte alignment, or no kv row."""
    if d != HEAD_DIM:
        raise NotImplementedError(f"flash kernel takes head_dim {HEAD_DIM}, got {d}")
    if s_kv <= 0 or s_q <= 0 or b <= 0 or h <= 0:
        raise ValueError(f"flash kernel needs rows and heads (B={b}, H={h}, Sq={s_q}, "
                         f"Skv={s_kv})")
    maps = {}
    for name, s in (("q", s_q), ("k", s_kv), ("v", s_kv)):
        box = (128 if name == "q" else BLOCK_K, 64)
        if layout == "bhsd":
            row = HEAD_DIM * 2
            maps[name] = TmaMap((HEAD_DIM, s, b * h), (row, s * row), box)
            continue
        if layout != "seqmajor":
            raise ValueError(f"flash_plan: unknown layout {layout!r}")
        sb, sr = strides[name]
        base = 0 if bases is None else bases[name]
        if sr < h * HEAD_DIM or (sr * 2) % 16 or (b > 1 and (sb * 2) % 16) or base % 16:
            raise ValueError(
                f"{name}: TMA needs 16-byte aligned rows at least {h * HEAD_DIM} wide "
                f"(row stride {sr}, batch stride {sb} elements, base {base % 16} bytes "
                f"past alignment)")
        row = sr * 2
        maps[name] = TmaMap((h * HEAD_DIM, s, b), (row, sb * 2 if b > 1 else s * row), box)
    return FlashPlan(layout, b, h, s_q, s_kv, maps)


SMEM_LIMIT = 232448  # shared memory one block can have on the H100


@dataclasses.dataclass(frozen=True)
class Int8FlashPlan:
    """How the int8 body tiles one call: blocks of ``block_q`` q rows of
    one (batch, head), ``threads`` threads (a producer warpgroup and two
    consumer warpgroups), kv tiles of ``block_kv`` rows (128 under
    ``s8_pv``, else the 64-column softmax block) through a ring of
    ``stages``; under ``s8_pv`` every quantization block's tiles come twice
    (``steps``), the first pass for the block's row max, and each thread's
    f32 output waits in shared memory between the blocks' folds.
    ``maps``: q bf16 over (128, Sq, B*H); k int8 over (128, Skv_p, B*H)
    under ``s8``, else bf16 over (128, Skv, B*H); v int8 transposed over
    (Skv_p, 128, B*H) under ``s8_pv`` (one box of 128 channels x 128 kv
    rows), else bf16. The numbers are the source's Int8Layout's, which the
    wrapper checks against the compiled body (:func:`_checked_int8_plan`)."""

    b: int
    h: int
    s_q: int
    s_kv: int
    qb: int
    s8: bool
    s8_pv: bool
    maps: Dict[str, TmaMap]
    block_q: int = 128
    threads: int = 384

    @property
    def block_kv(self) -> int:
        return 128 if self.s8_pv else BLOCK_K

    @property
    def stages(self) -> int:
        return (3 if self.s8 else 2) if self.s8_pv else 6

    @property
    def skv_p(self) -> int:
        """kv rows of the int8 operands: Skv rounded up to the block."""
        return -(-self.s_kv // self.qb) * self.qb

    @property
    def grid(self) -> Tuple[int, int]:
        """(q blocks, batch * heads)."""
        return -(-self.s_q // self.block_q), self.b * self.h

    @property
    def kv_tiles(self) -> int:
        return -(-self.s_kv // self.block_kv)

    @property
    def steps(self) -> int:
        """Ring stages a block consumes: each tile twice under ``s8_pv``."""
        return self.kv_tiles * (2 if self.s8_pv else 1)

    @property
    def smem_bytes(self) -> int:
        """The alignment slack, the bf16 q tile, the int8 q and its row
        scales (``s8``), the k and v rings, the f32 output (``s8_pv``) and
        the barriers."""
        kt = self.block_kv * HEAD_DIM * (1 if self.s8 else 2)
        vt = self.block_kv * HEAD_DIM * (1 if self.s8_pv else 2)
        qq = self.block_q * HEAD_DIM + self.block_q * 4 if self.s8 else 0
        o = self.block_q * HEAD_DIM * 4 if self.s8_pv else 0
        return (1024 + self.block_q * HEAD_DIM * 2 + qq + self.stages * (kt + vt) + o
                + (1 + 3 * self.stages) * 8)


def int8_flash_plan(b: int, h: int, s_q: int, s_kv: int, qb: int, s8: bool, s8_pv: bool, *,
                    d: int = HEAD_DIM, bases: Optional[Dict[str, int]] = None) -> Int8FlashPlan:
    """The int8 body's plan for ``b`` x ``h`` heads of ``s_q`` q rows over
    ``s_kv`` kv rows with quantization block ``qb``, for K9 (``s8``), K10
    (``s8_pv``) or both. Under ``s8_pv`` the kv tile (128) divides ``qb``,
    so a quantization block's int32 sums and row max are the same whatever
    the tile; without it the tile is the plain versions' 64-column softmax
    block. ``bases[name]``: the data pointers of q, k and v as the body reads them
    (int8 where quantized). Raises NotImplementedError for a head dim other
    than 128 and ValueError for no int8 mode, a block that is not a positive
    multiple of 128, no rows, or a base off 16-byte alignment."""
    if d != HEAD_DIM:
        raise NotImplementedError(f"flash kernel takes head_dim {HEAD_DIM}, got {d}")
    if not (s8 or s8_pv):
        raise ValueError("the int8 body needs s8 or s8_pv")
    if qb <= 0 or qb % 128:
        raise ValueError(f"the quantization block must be a multiple of 128, got {qb}")
    if s_kv <= 0 or s_q <= 0 or b <= 0 or h <= 0:
        raise ValueError(f"flash kernel needs rows and heads (B={b}, H={h}, Sq={s_q}, "
                         f"Skv={s_kv})")
    for name, base in (bases or {}).items():
        if base % 16:
            raise ValueError(f"{name}: TMA needs a 16-byte aligned base ({base % 16} bytes "
                             "past alignment)")
    skv_p = -(-s_kv // qb) * qb
    bh = b * h
    tile = 128 if s8_pv else BLOCK_K
    maps = {
        "q": TmaMap((HEAD_DIM, s_q, bh), (256, s_q * 256), (128, 64)),
        "k": (TmaMap((HEAD_DIM, skv_p, bh), (HEAD_DIM, skv_p * HEAD_DIM), (tile, HEAD_DIM))
              if s8 else TmaMap((HEAD_DIM, s_kv, bh), (256, s_kv * 256), (tile, 64))),
        "v": (TmaMap((skv_p, HEAD_DIM, bh), (skv_p, HEAD_DIM * skv_p), (HEAD_DIM, tile))
              if s8_pv else TmaMap((HEAD_DIM, s_kv, bh), (256, s_kv * 256), (tile, 64))),
    }
    plan = Int8FlashPlan(b, h, s_q, s_kv, qb, bool(s8), bool(s8_pv), maps)
    if plan.smem_bytes > SMEM_LIMIT:
        raise ValueError(f"int8 flash plan needs {plan.smem_bytes} bytes of shared memory")
    return plan


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None, out_seqmajor: bool = False,
                    s8: bool = False, s8_pv: bool = False, save_lse: bool = False):
    """q, k, v: [B, H, S, D] -> [B, H, Sq, D], or [B, Sq, H*D] with
    ``out_seqmajor`` (the layout the kernels write).

    ``s8`` runs QK^T as s8 x s8 (K9), ``s8_pv`` runs P.V as s8 x s8 (K10);
    both together take the combined entry point. A head dim below 128 is
    zero-padded to 128, as JAX does (exact: zero q/k columns add nothing to
    QK^T, the extra v columns are sliced off); the scale stays that of the
    true head dim. Raises ``NotImplementedError`` for a head dim above 128
    and for ``out_seqmajor`` with a padded head dim (callers then take the
    [B, H, S, D] path or ``sdpa_xla``).

    ``save_lse`` (``_flash_call(..., save_lse=True)``, K14) returns (o, lse,
    km): lse f32 [B, H, Sq] is the log-sum-exp of each row's scores in JAX's
    units, and km f32 [B, H, D] the k mean the s8 prepass removed, so that
    under ``s8`` the lse is that of the centred k's scores (None without
    ``s8``)."""
    b, h, sq, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if d > HEAD_DIM:
        raise NotImplementedError(f"flash kernels take head dims up to {HEAD_DIM}, got {d}")
    if d < HEAD_DIM:
        if out_seqmajor:
            raise NotImplementedError("out_seqmajor needs head_dim 128")
        q, k, v = (F.pad(t, (0, HEAD_DIM - d)) for t in (q, k, v))
    if q.device.type == "cpu":
        if s8 or s8_pv:
            o, lse, km = flash_int8_lse_plain(q, k, v, scale, s8, s8_pv)
        else:
            (o, lse), km = flash_attention_lse_plain(q, k, v, scale), None
        o = o.transpose(1, 2)
    else:
        lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if save_lse else None
        if s8 or s8_pv:
            o, km = _int8_launch(q, k, v, scale, s8, s8_pv, None, lse)
        else:
            o, km = flash_fwd(q, k, v, scale, lse), None
        o = o.view(b, sq, h, HEAD_DIM)
    # o: [B, Sq, H, 128]
    o = o.reshape(b, sq, h * d) if out_seqmajor else o[..., :d].transpose(1, 2)
    if not save_lse:
        return o
    return o, lse, None if km is None else km[..., :d]


def _check_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """What K3, K9 and K10 take: bf16 q [B, H, Sq, 128] and k/v [B, H, Skv,
    128], contiguous, 16-byte aligned, on one CUDA device, Skv > 0."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if d != HEAD_DIM:
        raise NotImplementedError(f"flash kernel takes head_dim {HEAD_DIM}, got {d}")
    for name, t, shape in (("q", q, (b, h, sq, d)), ("k", k, (b, h, skv, d)),
                           ("v", v, (b, h, skv, d))):
        _check_operand(name, t, shape, q.device)
    if skv == 0:
        raise ValueError("flash kernel needs at least one kv row")


def _check_operand(name: str, t: torch.Tensor, shape, device) -> None:
    """A contiguous bf16 tensor of ``shape`` on the CUDA ``device`` that TMA
    can read."""
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name} must be on the CUDA device of q, got {t.device}")
    if t.dtype != torch.bfloat16 or tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected bf16 {shape}, got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    check_tma_operand(name, t)


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
              lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K3 (``flash_fwd`` of ``csrc/flash_fwd.cu``): bf16 [B, H, S,
    128] -> bf16 [B, Sq, H*128]. Given ``lse`` (f32 [B, H, Sq], contiguous),
    K14's bf16 entry (``flash_fwd_lse``) also writes each q row's
    log-sum-exp there."""
    _check_bhsd(q, k, v)
    b, h, sq, d = q.shape
    flash_plan(b, h, sq, k.shape[2], "bhsd")
    out = torch.empty((b, sq, h * d), dtype=torch.bfloat16, device=q.device)
    if lse is None:
        _cuda.launch("flash_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), b, h, sq, k.shape[2], float(scale), device=q.device)
    else:
        _check_lse(lse, q)
        _cuda.launch("flash_fwd_lse", q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     lse.data_ptr(), b, h, sq, k.shape[2], float(scale), device=q.device)
    return out


def _check_lse(lse: torch.Tensor, q: torch.Tensor) -> None:
    shape = tuple(q.shape[:3])
    if (lse.device != q.device or lse.dtype != torch.float32 or tuple(lse.shape) != shape
            or not lse.is_contiguous()):
        raise ValueError(f"lse: expected contiguous f32 {shape} on {q.device}, got "
                         f"{lse.dtype} {tuple(lse.shape)} on {lse.device}")


# ---------------------------------------------------------------------------
# K9 / K10: the int8 modes (s8 QK^T, s8 P.V)
# ---------------------------------------------------------------------------


def quant_block(skv: int) -> int:
    """The int8 modes' quantization block for ``skv`` kv rows
    (:data:`QUANT_BLOCK_K`)."""
    return min(QUANT_BLOCK_K, -(-skv // 128) * 128)


def _div127(t: torch.Tensor) -> torch.Tensor:
    # Divide by a tensor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which is not the IEEE quotient.
    return t / torch.full_like(t, 127.0)


def _block_quantize(xc: torch.Tensor, block: int):
    """Zero-pad centred [B, H, S, D] rows to a multiple of ``block``; one
    scale per block, max|.| / 127 (1 where the block is 0); codes rounded
    half to even. Returns int8 [B, H, S_p, D] and f32 [B, H, S_p / block]."""
    b, h, s, d = xc.shape
    s_p = -(-s // block) * block
    xt = F.pad(xc, (0, 0, 0, s_p - s)).reshape(b, h, s_p // block, block, d)
    ax = xt.abs().amax(dim=(3, 4))
    sc = torch.where(ax == 0.0, torch.ones_like(ax), _div127(ax))
    xq = torch.round(xt / sc[..., None, None]).to(torch.int8)
    return xq.reshape(b, h, s_p, d), sc


def _mean_rows(x: torch.Tensor) -> torch.Tensor:
    """f32 mean over the sequence axis of [B, H, S, D]: the sum divided by S
    (``jnp.mean``)."""
    s = x.sum(dim=2, keepdim=True)
    return s / torch.full_like(s, x.shape[2])


def quantize_k(k: torch.Tensor, block: int):
    """The s8 prepass (``_quantize_k``, flash_pallas.py:223): k centred on
    its per-(b, h) mean over the real kv rows (softmax over kv is invariant
    to that shift, but the row's log-sum-exp moves by ``scale * q . km``),
    then :func:`_block_quantize`. Returns kq int8 [B, H, Skv_p, D], sk f32
    [B, H, Skv_p / block] and the mean km f32 [B, H, D]."""
    kf = k.float()
    km = _mean_rows(kf)
    kq, sk = _block_quantize(kf - km, block)
    return kq, sk, km[:, :, 0]


def quantize_v(v: torch.Tensor, block: int):
    """The s8_pv prepass (``_quantize_v``, flash_pallas.py:244): v centred on
    its per-(b, h) channel mean (added back to the output, since the softmax
    weights sum to 1), then :func:`_block_quantize`. Returns vq int8 [B, H,
    Skv_p, D], sv f32 [B, H, Skv_p / block] and the mean vm f32 [B, H, D]."""
    vf = v.float()
    vm = _mean_rows(vf)
    vq, sv = _block_quantize(vf - vm, block)
    return vq, sv, vm[:, :, 0]


def v_kernel_layout(vq: torch.Tensor) -> torch.Tensor:
    """vq [B, H, S_p, D] in the layout K10 reads: transposed to [B, H, D,
    S_p] (kv contiguous, as the int8 MMA's B operand wants it) with the kv
    rows of each 32-row chunk permuted so that a thread's p values, which
    sit in the QK^T accumulator's layout, form its int8 A fragment without
    a shuffle: position 16a + 4t + 2j + e holds row 8(2a + j) + 2t + e. The
    P.V sum over kv is the same sum in another order of rows, exact in
    int32."""
    i = torch.arange(32, device=vq.device)
    src = 8 * (2 * (i // 16) + (i // 2) % 2) + 2 * ((i // 4) % 4) + i % 2
    rows = (torch.arange(vq.shape[2] // 32, device=vq.device)[:, None] * 32 + src).reshape(-1)
    return vq[:, :, rows].transpose(2, 3).contiguous()


def flash_int8_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                     s8: bool, s8_pv: bool, qblock: Optional[int] = None) -> torch.Tensor:
    """Plain version of K9, K10 and both: :func:`flash_int8_lse_plain`'s
    output alone."""
    return flash_int8_lse_plain(q, k, v, scale, s8, s8_pv, qblock)[0]


def flash_int8_lse_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                         s8: bool, s8_pv: bool, qblock: Optional[int] = None):
    """Plain version of K9 (``s8``), K10 (``s8_pv``) and both together, in
    the kernels' order of operations (``_flash_kernel``, flash_pallas.py:
    67-204). [B, H, Sq, D] x3 -> [B, H, Sq, D].

    ``s8``: q quantized per row (``sq = max|q| / 127``, IEEE quotient, round
    half to even), k from :func:`quantize_k`; ``s = f32(qq . kq) * (sq * (sk
    * scale))``, the integer dot exact in float64. ``s8_pv``: per
    quantization block, ``p = exp(s - (m_blk - ln 127))`` against the
    block's own row max, quantized by +0.5 and truncation; ``pv`` and ``l``
    from the int8 p (exact integer sums) times ``beta = exp(m_blk -
    m_next)``; the v mean is added back at the end. Without ``s8_pv`` the
    online softmax runs over ``BLOCK_K`` kv rows at a time, as K3's plain
    version does; with it, over whole quantization blocks, as the kernel
    does with its two passes per block.

    Returns (o [B, H, Sq, D] in q's dtype, lse f32 [B, H, Sq] = ``m +
    log(l_safe)`` in JAX's units: with ``s8_pv``, l sums the quantized p
    times each block's beta; with ``s8``, the scores are those of the
    centred k, km [B, H, D] (else None))."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    qb = qblock or quant_block(skv)
    qf = q.float()
    km = None
    if s8:
        kq, sk, km = quantize_k(k, qb)
        aq = qf.abs().amax(dim=-1, keepdim=True)
        sqs = torch.where(aq == 0.0, torch.ones_like(aq), _div127(aq))
        qq = torch.round(qf / sqs).double()

    def scores(c0: int, c1: int) -> torch.Tensor:
        if not s8:
            return (qf @ k[:, :, c0:c1].float().transpose(-1, -2)) * scale
        s_i = (qq @ kq[:, :, c0:c1].double().transpose(-1, -2)).float()
        return s_i * (sqs * (sk[:, :, c0 // qb, None, None] * scale))

    m = torch.full((b, h, sq, 1), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    if s8_pv:
        vq, sv, vm = quantize_v(v, qb)
        for c0 in range(0, skv, qb):
            c1 = min(c0 + qb, skv)
            s = scores(c0, c1)
            m_cur = s.amax(dim=-1, keepdim=True)
            m_next = torch.maximum(m, m_cur)
            alpha = torch.exp(m - m_next)
            beta = torch.exp(m_cur - m_next)
            pq = torch.trunc(torch.exp(s - (m_cur - _LOG127)) + 0.5).double()
            pv = (pq @ vq[:, :, c0:c1].double()).float()
            l_q = pq.sum(dim=-1, keepdim=True).float() * (1.0 / 127.0)
            l = l * alpha + l_q * beta
            acc = acc * alpha + pv * (beta * _div127(sv[:, :, c0 // qb, None, None]))
            m = m_next
    else:
        for c0 in range(0, skv, BLOCK_K):
            c1 = min(c0 + BLOCK_K, skv)
            s = scores(c0, c1)
            m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m - m_next)
            p = torch.exp(s - m_next)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + p.to(v.dtype).float() @ v[:, :, c0:c1].float()
            m = m_next
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = acc * (1.0 / l_safe)
    if s8_pv:
        o = o + vm[:, :, None, :]
    return o.to(q.dtype), (m + torch.log(l_safe))[..., 0], km


def quantize_kv(k: Optional[torch.Tensor], v: Optional[torch.Tensor], block: int):
    """The int8 modes' prepass: k for ``s8``, v for ``s8_pv`` (either may be
    None), [B, H, Skv, D]. Returns ``(kq, sk, km)``: int8 [B, H, Skv_p, D],
    f32 [B, H, Skv_p / block], f32 [B, H, D], and ``(vt, sv, vm)``: v's codes
    in :func:`v_kernel_layout`'s order [B, H, D, Skv_p] and likewise; a
    missing tensor gives three Nones. A CPU tensor takes the plain versions
    (:func:`quantize_k`, :func:`quantize_v`, :func:`v_kernel_layout`); a CUDA
    tensor the kernel ``flash_quant`` (``csrc/flash_quant.cu``), one launch
    for both, which sums the mean in another order (the same codes but where
    that order moves a value across a rounding boundary)."""
    x = k if k is not None else v
    if x.device.type == "cpu":
        kres = quantize_k(k, block) if k is not None else (None, None, None)
        if v is None:
            return kres, (None, None, None)
        vq, sv, vm = quantize_v(v, block)
        return kres, (v_kernel_layout(vq), sv, vm)
    b, h, skv, d = x.shape
    if d != HEAD_DIM:
        raise NotImplementedError(f"flash_quant takes head_dim {HEAD_DIM}, got {d}")
    if block <= 0 or block % 128 or skv == 0:
        raise ValueError(f"flash_quant needs kv rows and a block that is a multiple of 128 "
                         f"(Skv={skv}, block={block})")
    skv_p = -(-skv // block) * block
    outs = {}
    for name, t, codes in (("k", k, (b, h, skv_p, d)), ("v", v, (b, h, d, skv_p))):
        if t is None:
            outs[name] = (None, None, None)
            continue
        _check_operand(name, t, (b, h, skv, d), x.device)
        outs[name] = (torch.empty(codes, dtype=torch.int8, device=x.device),
                      torch.empty((b, h, skv_p // block), dtype=torch.float32, device=x.device),
                      torch.empty((b, h, d), dtype=torch.float32, device=x.device))
        check_tma_operand(f"{name} codes", outs[name][0])  # the body reads them by TMA

    def ptr(t):
        return None if t is None else t.data_ptr()

    _cuda.launch("flash_quant", ptr(k), *(ptr(t) for t in outs["k"]), ptr(v),
                 *(ptr(t) for t in outs["v"]), b, h, skv, block, device=x.device)
    return outs["k"], outs["v"]


@functools.lru_cache(maxsize=64)
def _checked_int8_plan(b: int, h: int, sq: int, skv: int, qb: int, s8: bool,
                       s8_pv: bool) -> Int8FlashPlan:
    """:func:`int8_flash_plan` for one call's shapes, once per shape, its
    kv tile, stages and shared-memory bytes checked against the compiled
    body's (``_cuda.int8_layout``). The operands' alignment is checked on
    every call (:func:`_check_bhsd`, :func:`quantize_kv`)."""
    plan = int8_flash_plan(b, h, sq, skv, qb, s8, s8_pv)
    mine = (plan.block_kv, plan.stages, plan.smem_bytes)
    if mine != _cuda.int8_layout(s8, s8_pv):
        raise RuntimeError(f"int8_flash_plan {mine} disagrees with the compiled body "
                           f"{_cuda.int8_layout(s8, s8_pv)} (s8={s8}, s8_pv={s8_pv})")
    return plan


def _int8_launch(q, k, v, scale: float, s8: bool, s8_pv: bool, qblock: Optional[int],
                 lse: Optional[torch.Tensor] = None):
    """The prepass kernel (:func:`quantize_kv`), then one launch of the
    mode's int8 entry point (its K14 form when ``lse`` is given) on its
    plan (:func:`_checked_int8_plan`); returns the bf16 [B, Sq, H*128] output
    and the k mean the prepass removed."""
    _check_bhsd(q, k, v)
    b, h, sq, d = q.shape
    skv = k.shape[2]
    qb = qblock or quant_block(skv)
    mode = (bool(s8), bool(s8_pv))
    if lse is not None:
        _check_lse(lse, q)
    entry = INT8_ENTRIES[mode] if lse is None else INT8_LSE_ENTRIES[mode]
    (kq, sk, km), (vt, sv, vm) = quantize_kv(k if s8 else None, v if s8_pv else None, qb)
    kk = kq if s8 else k
    vv = vt if s8_pv else v
    _checked_int8_plan(b, h, sq, skv, qb, *mode)
    out = torch.empty((b, sq, h * d), dtype=torch.bfloat16, device=q.device)
    ptrs = [q.data_ptr(), kk.data_ptr(), None if sk is None else sk.data_ptr(), vv.data_ptr(),
            None if sv is None else sv.data_ptr(), None if vm is None else vm.data_ptr(),
            out.data_ptr()] + ([] if lse is None else [lse.data_ptr()])
    _cuda.launch(entry, *ptrs, b, h, sq, skv, qb, float(scale), device=q.device)
    return out, km


def flash_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
               s8: bool, s8_pv: bool, qblock: Optional[int] = None,
               lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K9 (``s8``), K10 (``s8_pv``) or the combined entry point of
    ``csrc/flash_fwd.cu`` after the prepass kernel: bf16 [B, H, S, 128] -> bf16
    [B, Sq, H*128]. Given ``lse`` (f32 [B, H, Sq]), the mode's K14 entry
    (``flash_s8_lse``, ``flash_s8pv_lse``, ``flash_s8_s8pv_lse``) also
    writes each q row's log-sum-exp there."""
    return _int8_launch(q, k, v, scale, s8, s8_pv, qblock, lse)[0]


def s8pv_dropped_mass(q: torch.Tensor, k: torch.Tensor, scale: Optional[float] = None,
                      qblock: Optional[int] = None) -> torch.Tensor:
    """Diagnostic for the s8_pv mode (``s8pv_dropped_mass``, flash_pallas.py:
    268), plain PyTorch: the share of the true softmax mass that the int8 p
    truncates to zero, i.e. of the keys whose weight relative to their own
    quantization block's row max is below 0.5 / 127. [B, H, Sq]. The block
    defaults to the one the kernels use for this kv length."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) * scale
    skv = s.shape[-1]
    qb = qblock or quant_block(skv)
    skv_p = -(-skv // qb) * qb
    s = F.pad(s, (0, skv_p - skv), value=_NEG_INF)
    st = s.reshape(*s.shape[:-1], skv_p // qb, qb)
    p_rel = torch.exp(st - st.amax(dim=-1, keepdim=True))
    mass = torch.softmax(s, dim=-1).reshape(st.shape)
    return torch.where(p_rel < 0.5 / 127.0, mass, torch.zeros_like(mass)).sum(dim=(-1, -2))


# ---------------------------------------------------------------------------
# K6 / K7: seq-major attention, RoPE outside or inside the kernel
# ---------------------------------------------------------------------------


def flash_sm_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   head_dim: int, scale: float) -> torch.Tensor:
    """Plain version of K6: :func:`flash_attention_plain` on head-split
    views of [B, S, H*D] q/k/v, merged back to [B, Sq, H*D]."""
    b, sq, n = q.shape
    h = n // head_dim

    def split(t):
        return t.reshape(b, t.shape[1], h, head_dim).transpose(1, 2)

    o = flash_attention_plain(split(q), split(k), split(v), scale)
    return o.transpose(1, 2).reshape(b, sq, n)


def rope_halfsplit_seqmajor(x: torch.Tensor, ce: torch.Tensor, se: torch.Tensor,
                            head_dim: int) -> torch.Tensor:
    """Half-split RoPE of seq-major [B, S, H*D] from the expanded tables
    (cos = ce[..., :D/2], sin = se[..., D/2:]), as the JAX package's
    rope-outside path does it."""
    b, s, n = x.shape
    x4 = x.reshape(b, s, n // head_dim, head_dim)
    return apply_rope_halfsplit(x4, ce[..., : head_dim // 2], se[..., head_dim // 2:],
                                seq_axis=1).reshape(b, s, n)


def flash_rope_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     ce_q: torch.Tensor, se_q: torch.Tensor, ce_k: torch.Tensor,
                     se_k: torch.Tensor, head_dim: int, scale: float) -> torch.Tensor:
    """Plain version of K7: the plain half-split RoPE of q and k, then K6's
    plain version."""
    return flash_sm_plain(rope_halfsplit_seqmajor(q, ce_q, se_q, head_dim),
                          rope_halfsplit_seqmajor(k, ce_k, se_k, head_dim), v,
                          head_dim, scale)


def _seqmajor_args(q, k, v):
    """Shape, device and layout checks of K6/K7's q/k/v (:func:`flash_plan`
    with their strides and pointers, :func:`check_tma_operand`); returns (b,
    h, sq, skv) and the batch/row strides the kernel takes."""
    b, sq, n = q.shape
    if n % HEAD_DIM != 0:
        raise NotImplementedError(f"seq-major flash kernel takes heads of {HEAD_DIM} "
                                  f"columns, got a width of {n}")
    skv = k.shape[1]
    strides = {}
    for name, t, shape in (("q", q, (b, sq, n)), ("k", k, (b, skv, n)),
                           ("v", v, (b, skv, n))):
        if t.device != q.device or t.device.type != "cuda":
            raise ValueError(f"{name} must be on the CUDA device of q, got {t.device}")
        if t.dtype != torch.bfloat16 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected bf16 {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        check_tma_operand(name, t)
        strides[name] = t.stride()[:2]
    flash_plan(b, n // HEAD_DIM, sq, skv, "seqmajor", strides=strides,
               bases={"q": q.data_ptr(), "k": k.data_ptr(), "v": v.data_ptr()})
    return (b, n // HEAD_DIM, sq, skv), [x for name in "qkv" for x in strides[name]]


def _check_table(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected f32 {shape} on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def flash_sm(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             scale: float) -> torch.Tensor:
    """Launch K6 (``flash_sm`` of ``csrc/flash_fwd.cu``): bf16 q [B, Sq,
    H*128], k/v [B, Skv, H*128] (rows may be column slices of wider rows)
    -> bf16 [B, Sq, H*128]."""
    (b, h, sq, skv), strides = _seqmajor_args(q, k, v)
    out = torch.empty((b, sq, h * HEAD_DIM), dtype=torch.bfloat16, device=q.device)
    _cuda.launch("flash_sm", q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, h, sq, skv, *strides, float(scale), device=q.device)
    return out


def _check_tables(ce_q, se_q, ce_k, se_k, b: int, sq: int, skv: int, device) -> None:
    _check_table("ce_q", ce_q, (b, sq, HEAD_DIM), device)
    _check_table("se_q", se_q, (b, sq, HEAD_DIM), device)
    _check_table("ce_k", ce_k, (b, skv, HEAD_DIM), device)
    _check_table("se_k", se_k, (b, skv, HEAD_DIM), device)


def _rope_launch(q, k, ce_q, se_q, ce_k, se_k, b: int, h: int, sq: int, skv: int,
                 strides) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of ``rope_qk`` on checked operands (``strides``: q's and
    k's batch and row strides) into new contiguous q and k."""
    qr = torch.empty((b, sq, h * HEAD_DIM), dtype=torch.bfloat16, device=q.device)
    kr = torch.empty((b, skv, h * HEAD_DIM), dtype=torch.bfloat16, device=q.device)
    _cuda.launch("rope_qk", q.data_ptr(), k.data_ptr(), ce_q.data_ptr(), se_q.data_ptr(),
                 ce_k.data_ptr(), se_k.data_ptr(), qr.data_ptr(), kr.data_ptr(),
                 b, h, sq, skv, *strides[:4], device=q.device)
    return qr, kr


def rope_qk(q: torch.Tensor, k: torch.Tensor, ce_q: torch.Tensor, se_q: torch.Tensor,
            ce_k: torch.Tensor, se_k: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K7's rotation pass (``rope_qk`` of ``csrc/flash_fwd.cu``): the
    half-split RoPE of seq-major q [B, Sq, H*128] and k [B, Skv, H*128]
    (column slices allowed) from the expanded tables f32 [B, Sq, 128] and
    [B, Skv, 128], into new contiguous bf16 tensors, bit for bit
    :func:`rope_halfsplit_seqmajor`'s. One launch for both."""
    (b, h, sq, skv), strides = _seqmajor_args(q, k, k)
    _check_tables(ce_q, se_q, ce_k, se_k, b, sq, skv, q.device)
    return _rope_launch(q, k, ce_q, se_q, ce_k, se_k, b, h, sq, skv, strides)


def flash_rope(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               ce_q: torch.Tensor, se_q: torch.Tensor, ce_k: torch.Tensor,
               se_k: torch.Tensor, scale: float) -> torch.Tensor:
    """K7: K6's operands plus the expanded RoPE tables f32 [B, Sq, 128] (q)
    and [B, Skv, 128] (k). The rotation pass (:func:`rope_qk`) rotates q and
    k, then the ``flash_rope`` entry point of ``csrc/flash_fwd.cu`` (K6's
    kernel, counted apart) attends over them."""
    (b, h, sq, skv), strides = _seqmajor_args(q, k, v)
    _check_tables(ce_q, se_q, ce_k, se_k, b, sq, skv, q.device)
    qr, kr = _rope_launch(q, k, ce_q, se_q, ce_k, se_k, b, h, sq, skv, strides)
    n = h * HEAD_DIM
    out = torch.empty((b, sq, n), dtype=torch.bfloat16, device=q.device)
    _cuda.launch("flash_rope", qr.data_ptr(), kr.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, h, sq, skv, sq * n, n, skv * n, n, *strides[4:], float(scale),
                 device=q.device)
    return out


def flash_attention_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          ce: torch.Tensor, se: torch.Tensor, head_dim: int,
                          scale: Optional[float] = None,
                          rope_in_kernel: Optional[bool] = None) -> torch.Tensor:
    """Seq-major self-attention with half-split RoPE: q/k/v [B, S, H*D] (the
    projection's own layout), expanded tables ce/se [B, S, D]
    (ops/rope.expand_rope_tables) -> [B, S, H*D].

    ``rope_in_kernel`` (default: ``DIFFUSION_RS_TPU_ATTN_LAYOUT=inkernel``)
    rotates q/k inside the kernel (K7); otherwise they are rotated outside
    and K6 runs on them. Raises ``NotImplementedError`` unless head_dim is a
    multiple of 128; the caller then takes the [B, H, S, D] path. As in JAX
    (flash_pallas.py:669-711), these kernels have no int8 modes: the
    ATTN_S8 / ATTN_S8PV knobs act only on :func:`flash_attention`."""
    if head_dim % 128 != 0:
        raise NotImplementedError("fused-RoPE kernel needs head_dim % 128 == 0")
    if q.shape[-1] % head_dim != 0:
        raise NotImplementedError("q last dim must be a head_dim multiple")
    if scale is None:
        scale = 1.0 / (head_dim ** 0.5)
    if rope_in_kernel is None:
        rope_in_kernel = os.environ.get("DIFFUSION_RS_TPU_ATTN_LAYOUT") == "inkernel"
    cpu = q.device.type == "cpu"
    if not cpu and head_dim != HEAD_DIM:
        raise NotImplementedError(f"flash kernels take head_dim {HEAD_DIM}, got {head_dim}")
    if rope_in_kernel:
        if cpu:
            return flash_rope_plain(q, k, v, ce, se, ce, se, head_dim, scale)
        return flash_rope(q, k, v, ce, se, ce, se, scale)
    qr = rope_halfsplit_seqmajor(q, ce, se, head_dim)
    kr = rope_halfsplit_seqmajor(k, ce, se, head_dim)
    if cpu:
        return flash_sm_plain(qr, kr, v, head_dim, scale)
    return flash_sm(qr, kr, v, scale)

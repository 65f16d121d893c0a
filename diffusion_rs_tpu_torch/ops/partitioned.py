"""Sequence-parallel attention over a mesh's ``sp`` group and row-parallel
linears over its ``tp`` group (port of the flash and qmm rules of
``ops/partitioned.py``).

JAX registers GSPMD rules on its Pallas kernels; the port, which runs one
process per rank, dispatches explicitly. Each rank holds its own rows of a
self-attention's sequence. When every rank holds as many rows
(:class:`SeqShard` ``lens``), :func:`ring_attention` runs: K14 on the local
chunk, then k/v rotate one hop ``sp - 1`` times and each chunk's output is
merged by its log-sum-exp. Otherwise the k/v rows are gathered and each rank
attends its q rows over the whole sequence, with the JAX package's warning.
Under the fused-RoPE layout RoPE runs outside, on each rank's rows, and then
the same dispatch (the in-kernel RoPE kernel never runs in the ring, as in
JAX).

The int8 QK^T mode centres each chunk's k by the chunk's own mean, which
leaves the chunk's softmax unchanged but moves its log-sum-exp by ``scale *
q . mean``. JAX's ring merges the centred log-sum-exps as they are, and so
weights chunks with different means wrongly; the port adds each chunk's
shift back before the merge, which makes the ring equal the single-chip s8
attention within the int8 band, as the JAX docstring promises.

A row-parallel linear (``make_partitioned_qmm``'s K-sharded rule,
partitioned.py:286) holds a K-slice of the weight on each tp rank:
:func:`row_parallel_linear` computes the rank's partial product over its
K range in f32 (the quantized kernels' f32-output entries), sums the
partials over the group with one all-reduce and casts once. A quantized
weight is K-sharded only where each slice keeps whole split blocks and
scale groups (:func:`_local_k_ok`).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..parallel.mesh import RingShift, all_gather_rows, reduce_sum
from ..quant.qtensor import QuantizedTensor, dequantize
from ..util.tracing import warn_once
from .flash import flash_attention, rope_halfsplit_seqmajor
from .qmatmul import quantized_matmul, supports


# ring_attention's calls ("rings") and k/v hops ("hops") on this rank
RING_HOPS: collections.Counter = collections.Counter()


@dataclasses.dataclass(frozen=True)
class SeqShard:
    """A sequence split over a process group: ``lens[i]`` rows on group rank
    i (q and kv alike: self-attention)."""

    group: object
    lens: Sequence[int]

    @property
    def ring(self) -> bool:
        return all(n == self.lens[0] for n in self.lens)


def _attend(q, k, v, scale, s8, s8_pv):
    """One chunk: f32 output [B, Sq, H, D] and the log-sum-exp [B, Sq, H, 1]
    of the chunk's true scores (the s8 centring shift added back)."""
    o, lse, km = flash_attention(q, k, v, scale, s8=s8, s8_pv=s8_pv, save_lse=True)
    if km is not None:
        lse = lse + scale * torch.einsum("bhsd,bhd->bhs", q.float(), km)
    return o.transpose(1, 2).float(), lse.transpose(1, 2)[..., None]


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group,
                   scale: Optional[float] = None, s8: bool = False,
                   s8_pv: bool = False) -> torch.Tensor:
    """Ring attention over the ranks of ``group`` (``ring_attention``,
    partitioned.py:38): q/k/v are this rank's rows [B, H, S_local, D], the
    same count on every rank. k/v rotate one hop ``n - 1`` times (to group
    rank r + 1, from r - 1) while each chunk's attention runs; the merge is
    JAX's, in f32: ``lse' = logaddexp(lse, lse_i)``, ``o = o exp(lse - lse')
    + o_i exp(lse_i - lse')``. Returns [B, S_local, H*D] in q's dtype.
    Counted in :data:`RING_HOPS` (calls and hops received)."""
    b, h, s, d = q.shape
    if scale is None:
        scale = d ** -0.5
    n = dist.get_world_size(group)
    RING_HOPS["rings"] += 1
    shift = RingShift([k, v], group) if n > 1 else None
    o, lse = _attend(q, k, v, scale, s8, s8_pv)
    for hop in range(1, n):
        k, v = shift.wait()
        RING_HOPS["hops"] += 1
        if hop + 1 < n:
            shift = RingShift([k, v], group)
        o_i, lse_i = _attend(q, k, v, scale, s8, s8_pv)
        lse_new = torch.logaddexp(lse, lse_i)
        o = o * torch.exp(lse - lse_new) + o_i * torch.exp(lse_i - lse_new)
        lse = lse_new
    return o.to(q.dtype).reshape(b, s, h * d)


def partitioned_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seq: SeqShard,
                      scale: Optional[float] = None, s8: bool = False, s8_pv: bool = False,
                      what: str = "flash attention") -> torch.Tensor:
    """Attention of this rank's q rows [B, H, S_local, D] over the whole
    sharded sequence -> [B, S_local, H*D]: the ring when every rank holds
    as many rows (``make_partitioned_flash``'s rule, partitioned.py:118),
    else k/v gathered to every rank and the single-chip kernel, with JAX's
    warning."""
    if seq.ring:
        return ring_attention(q, k, v, seq.group, scale, s8, s8_pv)
    total = sum(seq.lens)
    warn_once(
        f"flash-seq-replicated-{total}x{total}-sp",
        f"{what}: sequence axis sharded over 'sp' but ring attention needs sq == "
        f"skv ({total} vs {total}) split evenly over the axis (rows per rank "
        f"{list(seq.lens)}); REPLICATING the sequence per shard — the O(S/sp) "
        "memory saving of sequence parallelism is lost for this call")
    k = all_gather_rows(k, seq.group, seq.lens, dim=2)
    v = all_gather_rows(v, seq.group, seq.lens, dim=2)
    o = flash_attention(q, k, v, scale=scale, s8=s8, s8_pv=s8_pv)
    b, h, s, d = o.shape
    return o.transpose(1, 2).reshape(b, s, h * d)


def partitioned_flash_rope(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           ce: torch.Tensor, se: torch.Tensor, head_dim: int, seq: SeqShard,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Seq-major q/k/v [B, S_local, H*D] with this rank's rows of the
    expanded RoPE tables: half-split RoPE of q and k outside, then
    :func:`partitioned_flash` on head-split views (``make_partitioned_flash_
    rope``'s sp rule, partitioned.py:218). Returns [B, S_local, H*D]."""
    b, s, n = q.shape
    h = n // head_dim

    def split(t):
        return t.reshape(b, s, h, head_dim).transpose(1, 2).contiguous()

    qr = rope_halfsplit_seqmajor(q, ce, se, head_dim)
    kr = rope_halfsplit_seqmajor(k, ce, se, head_dim)
    return partitioned_flash(split(qr), split(kr), split(v), seq, scale,
                             what="fused-rope flash attention")


def _local_k_ok(kl: int, bits: int, group: int, split: int) -> bool:
    """Whether a K-shard of length ``kl`` satisfies the kernels' tiling
    (partitioned.py:273): whole split blocks (4-bit nibble layout), whole
    scale groups, and a K-tile that divides kl (8-bit: min(256, kl))."""
    if kl <= 0 or kl % group != 0:
        return False
    if bits == 4:
        return kl % split == 0
    bk = min(256, kl)
    return kl % bk == 0 and bk % 8 == 0


def row_parallel_linear(x: torch.Tensor, lin) -> torch.Tensor:
    """``x @ w + b`` for a row-parallel ``Linear`` holding this rank's K rows
    (``x``: this rank's input features): the partial product in f32 (the
    quantized kernels' f32 output; a dense or untiled weight through an f32
    matmul), plus the LoRA term's partial ``(x @ a_rows) @ bl``, summed over
    the tp group by one all-reduce, cast once to x's dtype; the bias is
    added after the cast, as JAX adds it. Under grad mode the all-reduce
    passes the gradient back unchanged (parallel/mesh.reduce_sum)."""
    w = lin.w
    f32 = torch.float32
    if isinstance(w, QuantizedTensor) and supports(w):
        y = quantized_matmul(x, w, out_dtype=f32)
    else:
        wd = dequantize(w, x.dtype) if isinstance(w, QuantizedTensor) else w.to(x.dtype)
        y = torch.matmul(x.float(), wd.float())
    if lin.lora is not None:
        a, bl = lin.lora
        y = y + torch.matmul(torch.matmul(x, a.to(x.dtype)).float(), bl.float())
    y = reduce_sum(y, lin.tp.group).to(x.dtype)
    return y if lin.b is None else y + lin.b

"""Tensor-parallel sharding rules (port of ``parallel/sharding.py``).

Megatron-style column- and row-parallel linears over the mesh's ``tp``
axis, with the JAX package's name-based rules over the param tree's paths:

* column-parallel (:data:`COL_KEYS`: q/k/v projections, MLP up/gate
  projections) cut the output features N, so that attention runs on each
  rank's own heads and the MLP on its own columns;
* row-parallel (:data:`ROW_KEYS`: attention output projections, MLP down
  projections, ``linear2``, FLUX's ``final.proj``) cut the input features
  K; each rank's partial product is summed over the tp group by one
  all-reduce (ops/partitioned.row_parallel_linear);
* everything else (norms, modulation, embeddings, ``wi01``, LoRA factors'
  own placement, the VAE) stays whole.

The JAX package places the whole tree with ``NamedSharding`` specs and
GSPMD inserts every reshard; the port runs one process per rank, so
:func:`shard_params` returns this rank's own tree, each ``Linear`` tagged
with its cut (ops/linear.TensorParallel); a FluxPipeline given a tp mesh
cuts its FLUX and T5 trees through :func:`shard_flux_t5`. Where the port differs from a
contiguous cut of JAX's:

* fused leaves are cut segment by segment, so that each rank holds its own
  heads' columns of every part: a double block's ``qkv`` (q | k | v), a
  single block's ``qkv_mlp`` (q | k | v | mlp), T5's fused ``qkv``, and, in
  the matching order, ``linear2``'s rows (attn | mlp). GSPMD repairs a
  contiguous cut by resharding; one process per rank cannot;
* the LoRA factors (whole in JAX: their path ends in an index) are cut
  with their weight, a column leaf's ``bl`` by columns and a row leaf's
  ``a`` by rows, so that the low-rank term is counted exactly once;
* a dimension that tp does not divide raises ``ValueError`` (GSPMD pads).

QuantizedTensor planes (packed, scale, bias) are cut along the same axis.
A row-parallel quantized weight whose K-slices would break a split block
or a scale group stays whole (:func:`_qt_row_shardable`, JAX's rule, and
every segment's share holding whole groups), and then takes its input
gathered along features.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

from ..ops.linear import Linear, TensorParallel, cut_segments
from ..quant.qtensor import QuantizedTensor
from ..util.tree import tree_map

# out-feature (column) parallel linears
COL_KEYS = frozenset(
    {"q", "k", "v", "qkv", "qkv_mlp", "in", "fc1", "proj_mlp", "wi",
     "wi_0", "wi_1"}
)
# in-feature (row) parallel linears
ROW_KEYS = frozenset({"proj", "out", "o", "linear2", "fc2", "wo"})


def _role_of(names) -> Optional[str]:
    """"col", "row" or None for a leaf at path ``names``: the last name that
    is not a plane or field name decides."""
    role = None
    for n in reversed(names):
        if n in ("w", "b", "packed", "scale", "bias", "codebook"):
            continue
        if n in COL_KEYS:
            role = "col"
        elif n in ROW_KEYS:
            role = "row"
        break
    return role


def _qt_row_shardable(qt: QuantizedTensor, tp_size: int) -> bool:
    """A K-shard must keep whole split blocks, whole scale groups, and a
    K-tile the kernel can grid over (ops/partitioned._local_k_ok)."""
    from ..ops.partitioned import _local_k_ok

    k = qt.shape[-2]
    return k % tp_size == 0 and _local_k_ok(k // tp_size, qt.bits, qt.group, qt.split)


def _segments(key: str, lin: Linear, parent: dict, role: str) -> List[int]:
    """Lengths of the parts of the cut dimension, in order."""
    k, n = lin.w.shape[-2], lin.w.shape[-1]
    if key == "qkv":
        return [n // 3] * 3
    if key == "qkv_mlp":  # q | k | v | mlp, h = the block's hidden size
        h = parent["linear2"].w.shape[-1]
        return [h, h, h, n - 3 * h]
    if key == "linear2" and k > n:  # rows: attn (h) | mlp
        return [n, k - n]
    return [n if role == "col" else k]


def _row_shardable(w, segments: Sequence[int], size: int) -> bool:
    """Whether a row-parallel weight can be K-cut: a dense one always; a
    quantized one by JAX's rule on the whole K and with every segment's
    share holding whole scale groups (and split blocks for 4-bit codes)."""
    if not isinstance(w, QuantizedTensor):
        return True
    return _qt_row_shardable(w, size) and all(
        (s // size) % w.group == 0 and (w.bits != 4 or (s // size) % w.split == 0)
        for s in segments)


def _shard_linear(lin: Linear, names: List[str], parent: dict, group, size: int,
                  rank: int) -> Linear:
    role = _role_of(names + ["w"])
    if role is None:
        return lin
    key = names[-1]
    segs = _segments(key, lin, parent, role)
    if any(s % size for s in segs):
        raise ValueError(f"{'/'.join(names)}: {'output' if role == 'col' else 'input'} "
                         f"features {segs} are not divisible by tp={size}")
    w = lin.w
    if role == "col":
        def cut(t):
            return cut_segments(t, -1, segs, rank, size)

        if isinstance(w, QuantizedTensor):
            w = QuantizedTensor(
                packed=cut(w.packed), scale=cut(w.scale),
                bias=None if w.bias is None else cut(w.bias), codebook=w.codebook,
                kind=w.kind, bits=w.bits, group=w.group, split=w.split,
                shape=(w.shape[0], w.shape[1] // size), out_dtype=w.out_dtype)
        else:
            w = cut(w)
        b = None if lin.b is None else cut(lin.b)
        lora = None if lin.lora is None else (lin.lora[0], cut(lin.lora[1]))
        return Linear(w=w, b=b, lora=lora,
                      tp=TensorParallel("col", group, size, rank, tuple(segs)))
    if not _row_shardable(w, segs, size):
        return Linear(w=lin.w, b=lin.b, lora=lin.lora,
                      tp=TensorParallel("row", group, size, rank, tuple(segs), sharded=False))

    def cut_rows(t, div=1):
        return cut_segments(t, -2, segs, rank, size, div)

    if isinstance(w, QuantizedTensor):
        w = QuantizedTensor(
            packed=cut_rows(w.packed, 2 if w.bits == 4 else 1),
            scale=cut_rows(w.scale, w.group),
            bias=None if w.bias is None else cut_rows(w.bias, w.group),
            codebook=w.codebook, kind=w.kind, bits=w.bits, group=w.group, split=w.split,
            shape=(w.shape[0] // size, w.shape[1]), out_dtype=w.out_dtype)
    else:
        w = cut_rows(w)
    lora = None if lin.lora is None else (cut_rows(lin.lora[0]), lin.lora[1])
    return Linear(w=w, b=lin.b, lora=lora,
                  tp=TensorParallel("row", group, size, rank, tuple(segs)))


def shard_params(params: Any, mesh, device=None) -> Any:
    """This rank's tree of ``params`` cut over the mesh's ``tp`` axis (the
    JAX ``shard_params``'s placement, one rank's part of it): column leaves
    take their N-slice, row leaves their K-slice, everything else stays
    whole, and every cut ``Linear`` carries its ``tp`` (group, size, rank,
    segments). The sliced planes are copies; whole leaves are the input's
    own tensors. ``device``: where the rank's tree goes once cut (None:
    where ``params`` are), so that a tree built in host memory never lies
    whole on the card. A ``Linear`` already cut is kept as it is; a mesh
    without tp returns ``params`` as they are."""
    size = mesh.shape["tp"]
    if size == 1:
        return params
    group, rank = mesh.groups["tp"], mesh.coords["tp"]

    def visit(node, names, parent):
        if "vae" in names:
            return node
        if isinstance(node, Linear):
            if node.tp is not None:
                return node
            return _shard_linear(node, names, parent, group, size, rank)
        if isinstance(node, dict):
            return {k: visit(v, names + [str(k)], node) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(visit(v, names + [str(i)], parent) for i, v in enumerate(node))
        return node

    out = visit(params, [], None)
    return out if device is None else tree_map(lambda t: t.to(device), out)


def shard_flux_t5(flux_params, flux_cfg, t5_params, t5_cfg, mesh, device=None):
    """FLUX's and T5's trees of a pipeline on a mesh with tp > 1, each cut
    to this rank's part by :func:`shard_params` (CLIP and the VAE stay
    whole, as in JAX). Raises ValueError naming the head count when tp does
    not divide FLUX's or T5's heads, and naming the leaf when it does not
    divide a width (GSPMD pads such a dimension; the port's per-rank heads
    need it whole)."""
    tp = mesh.shape["tp"]
    for name, n in (("FLUX num_attention_heads", flux_cfg.num_attention_heads),
                    ("T5 num_heads", t5_cfg.num_heads)):
        if n % tp:
            raise ValueError(f"tensor parallelism: {name} = {n} is not divisible by tp={tp}")
    return shard_params(flux_params, mesh, device), shard_params(t5_params, mesh, device)


def replicate_params(params: Any, mesh) -> Any:
    """Every rank holds the whole tree (``replicate_params``): the port's
    ranks already do, so the tree is returned as it is."""
    return params

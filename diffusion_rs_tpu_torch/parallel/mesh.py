"""The device mesh over ``torch.distributed`` (port of ``parallel/mesh.py``).

Axes ``(dp, sp, tp)`` in the JAX package's order: ``dp`` splits the prompt
batch, ``sp`` the packed image (and text) tokens, whose joint attention then
runs as ring attention over the axis (ops/partitioned.py), ``tp`` the heads
and MLP width. Rank ``r`` sits at ``dp = r // (sp * tp)``, ``sp = (r // tp)
% sp``, ``tp = r % tp``. Each rank holds a :class:`Mesh` with its own
coordinates and the process groups of the axes it belongs to; the JAX
package's ``NamedSharding`` specs become :class:`Sharding`, which cuts a
rank's local rows out of a whole tensor and gathers them back.

Under ``tp`` each rank holds its own slice of the FLUX and T5 weights
(parallel/sharding.py) and the row-parallel linears sum their partial
products over the tp group with :func:`all_reduce_sum`. gloo moves only CPU
tensors, so under a gloo group the collectives here stage CUDA tensors
through pinned host memory; under NCCL they send device memory directly.

Autograd: :func:`all_reduce_sum` and :func:`all_gather_rows` are not
differentiable (one sums in place, the other returns a constant). Under grad
mode the callers take :func:`reduce_sum` (the sum; backward: identity, since
the sum is replicated over the group), :func:`copy_to_group` (identity;
backward: the gradient summed over the group, for a replicated tensor each
rank uses on its own share of the work) and :func:`gather_rows` (the
gather; backward: the gradient summed over the group, then this rank's
rows), Megatron's conjugate pairs. Each runs its plain form when grad mode
is off or its input needs no gradient, so the no-grad forward is unchanged.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from .multihost import local_device

AXES = ("dp", "sp", "tp")
# all_reduce_sum's calls and bytes (per rank), for chip_smoke.py's counts
ALL_REDUCES: collections.Counter = collections.Counter()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the (dp, sp, tp) mesh. ``shape`` maps each axis to
    its size (the JAX ``Mesh.shape`` dict); ``coords`` to this rank's index
    on it; ``groups`` to the process group of the ranks that differ from
    this one only along that axis (None for an axis of size 1)."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, Optional[object]]
    device: torch.device


def make_mesh(dp: int = 1, tp: Optional[int] = None, sp: int = 1,
              device="cuda") -> Mesh:
    """The (dp, sp, tp) mesh over the initialized process group (a world of
    one without it). ``tp=None`` takes what dp and sp leave. Raises
    ``ValueError`` unless ``dp * sp * tp`` is the world size. Every rank
    must call it, in the same order, since it creates the axes' process
    groups; ``device`` "cuda" means this rank's card
    (multihost.local_device)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if tp is None:
        tp = world // (dp * sp)
    if dp * sp * tp != world:
        raise ValueError(f"dp({dp}) * sp({sp}) * tp({tp}) != world_size({world})")
    rank = dist.get_rank() if dist.is_initialized() else 0
    shape = {"dp": dp, "sp": sp, "tp": tp}
    stride = {"dp": sp * tp, "sp": tp, "tp": 1}
    coords = {a: (rank // stride[a]) % shape[a] for a in AXES}
    groups: Dict[str, Optional[object]] = dict.fromkeys(AXES)
    # new_group is collective over the world: every rank creates every group
    # of an axis, in one order, and keeps the one it belongs to
    for axis in AXES:
        if shape[axis] == 1:
            continue
        others = [a for a in AXES if a != axis]
        for fixed in itertools.product(*(range(shape[a]) for a in others)):
            base = sum(c * stride[a] for a, c in zip(others, fixed))
            ranks = [base + i * stride[axis] for i in range(shape[axis])]
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[axis] = g
    dev = local_device() if torch.device(device).type == "cuda" else torch.device(device)
    return Mesh(shape=shape, coords=coords, groups=groups, device=dev)


def split_sizes(n: int, parts: int) -> List[int]:
    """Lengths of ``torch.tensor_split(range(n), parts)``."""
    return [n // parts + (i < n % parts) for i in range(parts)]


def _gloo_cuda(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of a CUDA tensor, complete when this returns (gloo
    reads it from another thread)."""
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return h


def all_gather_rows(t: torch.Tensor, group, sizes: Sequence[int], dim: int) -> torch.Tensor:
    """Concatenate along ``dim`` every group rank's ``t``, whose length there
    is ``sizes[group rank]`` (shorter ones are padded on the wire)."""
    if group is None:
        return t
    n = max(sizes)
    pad = list(t.shape)
    pad[dim] = n - t.shape[dim]
    wire = torch.cat([t, t.new_zeros(pad)], dim=dim).contiguous() if pad[dim] else t.contiguous()
    if _gloo_cuda(t, group):
        wire = _to_host(wire)
    parts = [torch.empty_like(wire) for _ in sizes]
    dist.all_gather(parts, wire, group=group)
    out = torch.cat([p.narrow(dim, 0, s) for p, s in zip(parts, sizes)], dim=dim)
    return out.to(t.device, non_blocking=True)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of every group rank's ``t``, on every rank, on ``t``'s
    device (``t`` itself, summed in place, under NCCL or on the CPU; a CUDA
    tensor under gloo goes through a pinned host copy). Counted in
    :data:`ALL_REDUCES` (calls and bytes)."""
    if group is None:
        return t
    ALL_REDUCES["calls"] += 1
    ALL_REDUCES["bytes"] += t.numel() * t.element_size()
    if _gloo_cuda(t, group):
        h = _to_host(t)
        dist.all_reduce(h, group=group)
        return h.to(t.device, non_blocking=True)
    t = t.contiguous()
    dist.all_reduce(t, group=group)
    return t


def _tracks_grad(t: torch.Tensor, group) -> bool:
    return group is not None and torch.is_grad_enabled() and t.requires_grad


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return all_reduce_sum(t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.clone(), ctx.group), None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, sizes, dim):
        ctx.group, ctx.sizes, ctx.dim = group, list(sizes), dim
        return all_gather_rows(t, group, sizes, dim)

    @staticmethod
    def backward(ctx, g):
        r = dist.get_rank(ctx.group)
        whole = all_reduce_sum(g.contiguous().clone(), ctx.group)
        return whole.narrow(ctx.dim, sum(ctx.sizes[:r]), ctx.sizes[r]), None, None, None


def reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """:func:`all_reduce_sum`, differentiable under grad mode: every rank
    holds the same sum, so its gradient passes back unchanged."""
    if _tracks_grad(t, group):
        return _ReduceSum.apply(t, group)
    return all_reduce_sum(t, group)


def copy_to_group(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` itself; under grad mode its gradient is summed over ``group``
    (a tensor every rank holds whole and applies to its own share: the input
    of a column-parallel linear, a norm scale of a rank's own heads)."""
    if _tracks_grad(t, group):
        return _CopyToGroup.apply(t, group)
    return t


def gather_rows(t: torch.Tensor, group, sizes: Sequence[int], dim: int) -> torch.Tensor:
    """:func:`all_gather_rows`, differentiable under grad mode for a gather
    each rank then uses on its own rows (k/v over sp): the gradient is
    summed over ``group`` and this rank's rows are kept."""
    if _tracks_grad(t, group):
        return _GatherRows.apply(t, group, sizes, dim)
    return all_gather_rows(t, group, sizes, dim)


class RingShift:
    """Send tensors one hop around a group's ring (group rank r to r + 1)
    and receive the same shapes from r - 1, asynchronously: ``wait()``
    returns the received tensors on the senders' device."""

    def __init__(self, tensors: Sequence[torch.Tensor], group):
        rank, n = dist.get_rank(group), dist.get_world_size(group)
        nxt = dist.get_global_rank(group, (rank + 1) % n)
        prv = dist.get_global_rank(group, (rank - 1) % n)
        self.device = tensors[0].device
        self.staged = _gloo_cuda(tensors[0], group)
        send = [_to_host(t) if self.staged else t.contiguous() for t in tensors]
        self.recv = [torch.empty(t.shape, dtype=t.dtype, pin_memory=self.staged)
                     if self.staged else torch.empty_like(t) for t in send]
        ops = []
        for s, r in zip(send, self.recv):
            ops += [dist.P2POp(dist.isend, s, nxt, group), dist.P2POp(dist.irecv, r, prv, group)]
        self.works = dist.batch_isend_irecv(ops)

    def wait(self) -> List[torch.Tensor]:
        for w in self.works:
            w.wait()
        if self.staged:
            return [r.to(self.device, non_blocking=True) for r in self.recv]
        return self.recv


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Which mesh axis splits each leading dim of a tensor (None: none), the
    port's ``NamedSharding(mesh, P(...))``. Splits follow
    ``torch.tensor_split``: the first ranks take one row more when an axis
    does not divide the dim."""

    mesh: Mesh
    spec: tuple

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole tensor ``x``."""
        for dim, axis in enumerate(self.spec):
            if axis is not None and self.mesh.shape[axis] > 1:
                x = torch.tensor_split(x, self.mesh.shape[axis], dim=dim)[self.mesh.coords[axis]]
        return x

    def gather(self, x: torch.Tensor, full_shape: Sequence[int]) -> torch.Tensor:
        """The whole tensor of shape ``full_shape`` from every rank's block,
        on every rank (the last axis of the spec gathered first)."""
        for dim in reversed(range(len(self.spec))):
            axis = self.spec[dim]
            if axis is not None and self.mesh.shape[axis] > 1:
                x = all_gather_rows(x, self.mesh.groups[axis],
                                    split_sizes(full_shape[dim], self.mesh.shape[axis]), dim)
        return x


def sequence_sharding(mesh: Mesh) -> Sharding:
    """[batch, seq, ...] activations: batch over dp, tokens over sp."""
    return Sharding(mesh, ("dp", "sp"))


def batch_sharding(mesh: Mesh) -> Sharding:
    """The leading batch axis over dp."""
    return Sharding(mesh, ("dp",))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())

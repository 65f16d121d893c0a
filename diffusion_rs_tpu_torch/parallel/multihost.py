"""Process-group start-up (port of ``parallel/multihost.py``).

The JAX package is single-controller: one process drives every chip of a
mesh. The port is SPMD: one process per rank, each calling
:func:`init_multihost` once before it builds a mesh (``parallel.make_mesh``)
and a ``Pipeline(mesh=...)``. Nothing on a host tells a program of a
cluster, so the rendezvous comes from the standard variables (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``) or from the arguments.

:func:`make_multislice_mesh` and :func:`local_batch_to_global` are the JAX
package's multi-host helpers: the mesh with dp inferred from the world size
and made the major axis, and each rank's own rows of the batch as its block
of the dp-sharded global batch.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

log = logging.getLogger("diffusion_rs_tpu_torch")


def local_device() -> torch.device:
    """This rank's CUDA device: ``LOCAL_RANK`` modulo the host's device
    count, so ranks that outnumber the cards share them."""
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("diffusion_rs_tpu_torch: a mesh rank needs a CUDA device; pass "
                           "device='cpu' explicitly to run the plain PyTorch paths")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")) % n)


def default_backend(local_world: int) -> str:
    """NCCL when every rank of the host has a card of its own, gloo
    otherwise (NCCL refuses two ranks on one card, and has no CPU path)."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= local_world:
        return "nccl"
    return "gloo"


def init_multihost(init_method: Optional[str] = None, world_size: Optional[int] = None,
                   rank: Optional[int] = None, backend: Optional[str] = None) -> bool:
    """Start this rank's ``torch.distributed`` process group. Arguments
    default to the environment (``WORLD_SIZE``, ``RANK``, and ``env://``,
    i.e. ``MASTER_ADDR`` / ``MASTER_PORT``); the backend to
    :func:`default_backend` of ``LOCAL_WORLD_SIZE`` (the world size when
    unset: one host). Returns False for a world of one (nothing to start),
    True once the group is up (or was already).

    On a host with CUDA, the rank's card (:func:`local_device`) becomes the
    current device first: NCCL binds the group's communicator to it, and
    PyTorch allocates ``"cuda"`` tensors and takes its default stream there."""
    if dist.is_initialized():
        return True
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1:
        return False
    if rank is None:
        rank = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    backend = backend or default_backend(local)
    if torch.cuda.is_available():
        torch.cuda.set_device(local_device())
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    log.info("multihost: rank %d/%d, backend %s", rank, world_size, backend)
    return True


def make_multislice_mesh(dp: int = 0, sp: int = 1, tp: int = 1, device="cuda"):
    """The (dp, sp, tp) mesh over the world with dp the major axis
    (``make_multislice_mesh``, multihost.py:46): ranks are numbered host by
    host, so dp spans the hosts while the sp and tp groups, whose
    collectives run every block, stay within one. ``dp`` 0 (or None)
    infers it: the world size over ``sp * tp``."""
    from .mesh import make_mesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    if dp in (0, None):
        if world % (sp * tp):
            raise ValueError(f"world size {world} is not divisible by sp*tp={sp * tp}")
        dp = world // (sp * tp)
    return make_mesh(dp=dp, sp=sp, tp=tp, device=device)


def local_batch_to_global(local_batch, mesh, spec=None) -> torch.Tensor:
    """This rank's rows of the batch as its block of the global batch
    sharded by ``spec`` (default ``("dp",)``: the leading dim over dp), on
    the mesh's device (``local_batch_to_global``, multihost.py:72). The port
    never assembles the global array: one process per rank, each holding
    its block, which is what every sharded entry point of the port takes
    (parallel.Sharding's ``local``). Ranks that differ only off the spec's
    axes (the tp ranks of one dp row) must pass the same rows."""
    spec = ("dp",) if spec is None else tuple(spec)
    if any(a is not None and a not in mesh.shape for a in spec):
        raise ValueError(f"spec {spec} names an axis outside the mesh's {tuple(mesh.shape)}")
    return torch.as_tensor(local_batch).to(mesh.device)

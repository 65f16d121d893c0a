"""Run a function on N ranks of one host, for tests and ``chip_smoke.py``.

:func:`spawn` starts ``world`` processes with ``torch.multiprocessing``'s
spawn method, each with its own ``RANK`` / ``LOCAL_RANK`` environment and a
``file://`` rendezvous (no port to pick, so parallel test workers never
clash), calls ``init_multihost`` in each, runs ``fn(rank, *args)`` and tears
the group down. ``fn`` must be importable by name (a module-level function):
the children import it afresh. A rank that raises makes :func:`spawn` raise.
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path
from typing import Callable, Optional

import torch.distributed as dist
import torch.multiprocessing as mp

from .multihost import init_multihost


def _rank_main(rank: int, fn: Callable, world: int, backend: Optional[str],
               init_file: str, args: tuple) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    init_multihost(init_method=f"file://{init_file}", world_size=world, rank=rank,
                   backend=backend)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, backend: Optional[str] = None, args: tuple = ()) -> None:
    """``fn(rank, *args)`` on ranks 0..world-1, each its own process, with a
    rendezvous file in a fresh temporary directory. ``backend`` None picks
    NCCL when every rank has a card, else gloo (multihost.default_backend)."""
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank_main, args=(fn, world, backend, str(Path(tmp) / "rendezvous"), args),
                 nprocs=world, join=True)

"""Parallelism over ``torch.distributed`` (port of ``parallel/``): the
(dp, sp, tp) mesh, the process-group start-up, a launcher for N ranks on
one host, and host-memory offload. Tensor parallelism is not ported yet."""

from .launch import spawn  # noqa: F401
from .mesh import (  # noqa: F401
    Mesh,
    Sharding,
    batch_sharding,
    make_mesh,
    replicated,
    sequence_sharding,
)
from .multihost import init_multihost, local_device  # noqa: F401
from .offload import HostOffload  # noqa: F401

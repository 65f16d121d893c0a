"""Parallelism over ``torch.distributed`` (port of ``parallel/``): the
(dp, sp, tp) mesh, the tensor-parallel cut of the weights, the
process-group start-up and the multi-host helpers, a launcher for N ranks
on one host, and host-memory offload."""

from .launch import spawn  # noqa: F401
from .mesh import (  # noqa: F401
    Mesh,
    Sharding,
    batch_sharding,
    make_mesh,
    replicated,
    sequence_sharding,
)
from .multihost import (  # noqa: F401
    init_multihost,
    local_batch_to_global,
    local_device,
    make_multislice_mesh,
)
from .offload import HostOffload  # noqa: F401
from .sharding import replicate_params, shard_params  # noqa: F401

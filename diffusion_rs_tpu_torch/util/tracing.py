"""Once-per-process warnings (port of ``warn_once`` in the JAX package's
``util/tracing.py``). The spans and the profiler context of that module are
not ported yet (ROADMAP Queue 1 item 4)."""

from __future__ import annotations

import logging

logger = logging.getLogger("diffusion_rs_tpu_torch")
_warned: set = set()


def warn_once(key: str, msg: str) -> None:
    """Log ``msg`` as a WARNING the first time ``key`` fires in this process:
    for paths that quietly degrade or guess (a capacity estimate over
    budget, T5 kept in its format), said once instead of never."""
    if key in _warned:
        return
    _warned.add(key)
    logger.warning(msg)

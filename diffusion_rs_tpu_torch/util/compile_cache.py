"""Persistent kernel cache for cold-start latency (port of the JAX
package's ``util/compile_cache.py``).

The port's only compiled artifacts are the ``nvcc`` libraries of its CUDA
kernels (ops/_cuda.py), built at the first launch into ``BUILD_DIR``
(DIFFUSION_RS_TORCH_BUILD, else ``build/torch_kernels/`` beside the
package) and reused by every later process whose sources and flags hash
the same. ``enable_compile_cache(dir)`` points ``BUILD_DIR`` at ``dir``, so
that a serving process's restart, or the next CLI run, loads the built
libraries from there instead of compiling them again.

Resolution order, as in JAX: the argument > DIFFUSION_RS_TPU_COMPILE_CACHE >
disabled. The build directory is process-global, so the first enable wins;
a later call with a different directory logs a warning and keeps the first.
Once a library has been loaded from another directory, the call warns and
keeps that directory.
"""

from __future__ import annotations

import logging
import os
import threading
from pathlib import Path
from typing import Optional

log = logging.getLogger("diffusion_rs_tpu_torch")

_enabled_dir: Optional[str] = None
# Pipelines may be built from several threads: the check-then-set on the
# process-global latch is atomic.
_lock = threading.Lock()


def enable_compile_cache(cache_dir: Optional[str] = None) -> Optional[str]:
    """Build and load the CUDA kernel libraries under ``cache_dir``.

    Returns the absolute directory in effect, or None when disabled (no
    argument, no DIFFUSION_RS_TPU_COMPILE_CACHE and no earlier enable).
    Builds nothing."""
    global _enabled_dir
    d = cache_dir or os.environ.get("DIFFUSION_RS_TPU_COMPILE_CACHE")
    if not d:
        return _enabled_dir
    d = os.path.abspath(os.path.expanduser(d))
    with _lock:
        if _enabled_dir is not None:
            if d != _enabled_dir:
                log.warning("compile cache already enabled at %s; ignoring %s (the kernel "
                            "build directory is process-global)", _enabled_dir, d)
            return _enabled_dir
        from ..ops import _cuda

        in_effect = str(_cuda.use_build_dir(Path(d)))
        if in_effect != d:
            log.warning("CUDA kernels already loaded from %s; ignoring %s", in_effect, d)
            return in_effect
        _enabled_dir = d
        log.info("persistent CUDA kernel cache: %s", d)
        return _enabled_dir

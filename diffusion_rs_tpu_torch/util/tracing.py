"""Tracing and profiling hooks (port of the JAX package's
``util/tracing.py``).

The pipeline's stages run inside named spans (``text-encode``,
``denoise``, ``vae-decode``, ``vae-encode``, ``vae-encode-tiled``): each
is a ``torch.profiler.record_function`` range, visible in a profiler
trace, and on a CUDA host also an NVTX range. ``maybe_profile`` wraps a
region in ``torch.profiler.profile`` (CPU and, where CUDA is available,
CUDA activities) when DIFFUSION_RS_TPU_TRACE_DIR is set, and writes a
Chrome trace (``<name>-<pid>-<ns>.json``) into that directory.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import torch

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


@contextlib.contextmanager
def trace_span(name: str):
    """A named range around the block: ``record_function`` (profiler
    traces), and an NVTX range where CUDA is available."""
    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield


@contextlib.contextmanager
def maybe_profile(step_name: str = "generate"):
    """Profile the block into DIFFUSION_RS_TPU_TRACE_DIR when it is set (a
    Chrome trace named after ``step_name``); otherwise do nothing."""
    trace_dir = os.environ.get("DIFFUSION_RS_TPU_TRACE_DIR")
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        with torch.profiler.record_function(step_name):
            yield
    prof.export_chrome_trace(
        os.path.join(trace_dir, f"{step_name}-{os.getpid()}-{time.time_ns()}.json"))

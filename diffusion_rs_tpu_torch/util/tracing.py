"""Tracing and profiling hooks (port of the JAX package's
``util/tracing.py``).

``trace_span(name)`` is the port's one span API, with two sinks:

- the profiler: a ``torch.profiler.record_function`` range, entered only
  while a profiler is recording (the process-wide flag
  ``torch.autograd.profiler._is_profiler_enabled``), plus an NVTX range
  where CUDA is available unless ``nvtx=False``. Outside a profiler a span
  with ``nvtx=False`` and no log costs the flag check. The profiler records
  ranges only on the thread that started it, so spans on other threads
  (the server's worker and decode threads) reach it only from a profiler
  built to record all threads;
- a :class:`SpanLog` (optional): a bounded ring of finished spans, each
  (name, thread name, start, end on ``time.perf_counter``, attrs), kept in
  memory whatever thread ran the span and whether or not a profiler runs.

The pipeline's stages run inside ``text-encode``, ``denoise``,
``vae-decode``, ``vae-encode`` and ``vae-encode-tiled``; the server's
forwards and decodes inside ``serve.forward`` / ``serve.decode``
(serving.py, which logs the forwards); the model step's plain-torch
families inside ``flux.norm_mod``, ``flux.qk_rope`` and ``flux.gate_act``
(models/flux.py, profiler only). ``maybe_profile`` wraps a region in
``torch.profiler.profile`` (CPU and, where CUDA is available, CUDA
activities) when DIFFUSION_RS_TPU_TRACE_DIR is set, and writes a Chrome
trace (``<name>-<pid>-<ns>.json``) into that directory.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import threading
import time
from collections import deque
from typing import List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

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


@dataclasses.dataclass
class Span:
    """One finished span: host clock (``time.perf_counter``) start and end."""

    name: str
    thread: str
    start: float
    end: float
    attrs: dict


class SpanLog:
    """A bounded ring of finished :class:`Span` entries (the oldest drop
    first), appended to from any thread."""

    def __init__(self, capacity: int):
        self._ring: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()

    def add(self, name: str, start: float, end: float, **attrs) -> None:
        span = Span(name, threading.current_thread().name, start, end, attrs)
        with self._lock:
            self._ring.append(span)

    def snapshot(self) -> List[Span]:
        with self._lock:
            return list(self._ring)


class _OpenSpan:
    """An entered :func:`trace_span`; ``attrs`` may be added to inside the
    block (they go to the log at its exit)."""

    __slots__ = ("name", "log", "attrs", "_range", "_nvtx", "_t0")

    def __init__(self, name, log, attrs, profiling, nvtx):
        self.name, self.log, self.attrs = name, log, attrs
        self._range = torch.profiler.record_function(name) if profiling else None
        self._nvtx = nvtx

    def __enter__(self):
        if self._range is not None:
            self._range.__enter__()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self.name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.log is not None:
            self.log.add(self.name, self._t0, time.perf_counter(), **self.attrs)
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


_NULL_SPAN = contextlib.nullcontext()


def trace_span(name: str, log: Optional[SpanLog] = None, attrs: Optional[dict] = None,
               nvtx: bool = True):
    """A named range around the block (``with trace_span(...) as span``):
    a ``record_function`` range while a profiler records, an NVTX range
    where CUDA is available (unless ``nvtx`` is False), and with ``log`` an
    entry appended to it at the block's exit, carrying ``attrs`` (and what
    the block adds to ``span.attrs``). With none of the three it returns a
    shared no-op context, whose ``as`` target is None."""
    profiling = _autograd_profiler._is_profiler_enabled
    nvtx = nvtx and torch.cuda.is_available()
    if log is None and not profiling and not nvtx:
        return _NULL_SPAN
    return _OpenSpan(name, log, dict(attrs or {}), profiling, nvtx)


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

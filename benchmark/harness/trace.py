"""Profiler trace of a sub-window, reduced in memory to what the per-layer
readers need: device operations (kernels, copies, fills) with their launch
times, the host ranges around them (the port's ``trace_span`` names and the
benchmark's own spans), the union of device busy intervals and the idle
gaps between them.

The trace is exported once to a temporary file under ``TMPDIR``, read back
and deleted; only the reduction stays. A caller on a schedule stops the
profiler on time and reduces the trace later (:class:`Profiler`)."""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import tempfile
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"


def short_name(name: str) -> str:
    """A kernel's qualified function name, without its return type, template
    arguments, parameters and anonymous namespaces."""
    if name.startswith(("Memcpy", "Memset")):
        return " ".join(name.split()[:2])
    n = name.replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in n:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(0, depth - 1)
        elif depth == 0:
            if ch == "(":
                break
            out.append(ch)
    words = "".join(out).split()
    return words[-1] if words else name[:64]


class Trace:
    """The reduction of one profiled window. Times in microseconds on the
    trace's clock."""

    def __init__(self, events: List[dict]):
        # name, ts, dur, correlation id, category
        self.ops: List[Tuple[str, float, float, Optional[int], str]] = []
        launch: Dict[int, float] = {}
        self.ranges: List[Tuple[str, float, float]] = []  # host spans: name, ts, end
        self.window = None
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            args = e.get("args") or {}
            if cat in DEVICE_CATS:
                self.ops.append((e["name"], float(e["ts"]), float(e.get("dur", 0.0)),
                                 args.get("correlation"), cat))
            elif cat == "cuda_runtime" and "correlation" in args:
                launch[args["correlation"]] = float(e["ts"])
            elif cat == "user_annotation":
                ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
                if e["name"] == WINDOW:
                    self.window = (ts, ts + dur)
                else:
                    self.ranges.append((e["name"], ts, ts + dur))
        self.launch_ts = [launch.get(op[3]) for op in self.ops]
        if self.window is None and self.ops:
            self.window = (min(o[1] for o in self.ops), max(o[1] + o[2] for o in self.ops))

    # -- the device timeline -------------------------------------------------

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """Union of device operation intervals inside the window."""
        if self.window is None:
            return []
        w0, w1 = self.window
        iv = sorted((max(ts, w0), min(ts + dur, w1)) for _, ts, dur, _, _ in self.ops
                    if ts + dur > w0 and ts < w1)
        out: List[List[float]] = []
        for a, b in iv:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def window_s(self) -> float:
        return 0.0 if self.window is None else (self.window[1] - self.window[0]) * 1e-6

    def idle_gaps(self) -> List[Tuple[float, float]]:
        if self.window is None:
            return []
        gaps, t = [], self.window[0]
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.window[1] > t:
            gaps.append((t, self.window[1]))
        return gaps

    # -- host ranges -----------------------------------------------------------

    def host_range_at(self, t: float) -> str:
        """The innermost host span covering trace time ``t``."""
        best = None
        for name, a, b in self.ranges:
            if a <= t <= b and (best is None or b - a < best[1]):
                best = (name, b - a)
        return best[0] if best else "no host span"

    def ops_launched_in(self, span: str) -> List[Tuple[str, float, float, str]]:
        """Device operations whose launch lies inside a host span named ``span``."""
        spans = sorted((a, b) for n, a, b in self.ranges if n == span)
        starts = [a for a, _ in spans]
        out = []
        for (name, ts, dur, _, cat), lt in zip(self.ops, self.launch_ts):
            if lt is None:
                continue
            i = bisect.bisect_right(starts, lt) - 1
            if i >= 0 and lt <= spans[i][1]:
                out.append((name, ts, dur, cat))
        return out

    # -- the breakdown ---------------------------------------------------------

    def breakdown(self, n: int = 10) -> dict:
        by_name: Dict[str, float] = {}
        w0, w1 = self.window or (0.0, 0.0)
        for name, ts, dur, _, _ in self.ops:
            if ts + dur > w0 and ts < w1:
                k = short_name(name)
                by_name[k] = by_name.get(k, 0.0) + dur * 1e-6
        gaps: Dict[str, float] = {}
        for a, b in self.idle_gaps():
            k = self.host_range_at((a + b) / 2)
            gaps[k] = gaps.get(k, 0.0) + (b - a) * 1e-6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in idle]}


def family_matcher(patterns: List[str]):
    rx = re.compile("|".join(f"(?:{p})" for p in patterns))
    return lambda name: rx.search(name) is not None


class Profiler:
    """The profiler (host and device activity) around a sub-window, in three
    steps, so that a caller on a schedule pays only for the first two:
    ``start``, ``stop`` (the device synchronised, collection ended) and
    ``reduce`` (the export, read back and reduced into :class:`Trace`)."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts, record_shapes=False, with_stack=False)
        self._span = None
        self.stopped = False

    def start(self) -> None:
        from torch.profiler import record_function

        self._prof.start()
        self._span = record_function(WINDOW)
        self._span.__enter__()

    def stop(self) -> None:
        import torch

        self._span.__exit__(None, None, None)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()
        self.stopped = True

    def reduce(self) -> Trace:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        self._prof = None
        return Trace(events)


@contextlib.contextmanager
def profiled():
    """Profile the block; yields a holder whose ``trace`` is set to the
    :class:`Trace` when the block ends."""
    holder = type("Profiled", (), {"trace": None})()
    prof = Profiler()
    prof.start()
    try:
        yield holder
    finally:
        prof.stop()
    holder.trace = prof.reduce()

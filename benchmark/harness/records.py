"""What the readers of the program's own records share: a serve cell's
untraced stretch, and the device time of the plain-torch ops inside a span
of the traced image.

A serve cell's program-span readers count only requests due, and forwards
and idle periods started, before the traced sub-window opens (the mix's
``trace_window_s`` before the window's close), so that the profiler's own
host cost stays out of them; an idle period counts from the window's start. The window opens at ``t0 = due - due_s`` of
any request on the host clock (``time.perf_counter``), the clock of the
server's records (``FluxServer.request_trace``, ``trace_snapshot``). Each
function returns None where the program keeps no such record (a program
without them)."""

from __future__ import annotations


def untraced(run):
    """(t0, t_open) on the host clock: the window's start and the traced
    sub-window's, or None without a served window."""
    done = run.out.get("completed") or []
    if not done or run.server is None:
        return None
    t0 = done[0]["due"] - done[0]["request"].due_s
    return t0, t0 + run.out["window_s"] - run.mix.get("trace_window_s", 0.0)


def requests(run):
    """The server's records (``request_trace``) of the completed requests
    due before the traced sub-window opens; None without them."""
    span = untraced(run)
    if span is None or not hasattr(run.server, "request_trace"):
        return None
    recs = [run.server.request_trace(d["future"]) for d in run.out["completed"]
            if d["due"] < span[1]]
    recs = [r for r in recs if r is not None and r["done"] is not None]
    return recs or None


def log(run, name: str):
    """The server's log entries named ``name`` (``trace_snapshot``) started
    before the traced sub-window opens and ended after the window's start
    (the worker's idle period at the window's start began before it), and
    that stretch; None without them."""
    span = untraced(run)
    if span is None or not hasattr(run.server, "trace_snapshot"):
        return None
    t0, t_open = span
    return [e for e in run.server.trace_snapshot()
            if e["name"] == name and e["start"] < t_open and e["end"] > t0], span


def family_ms_per_step(run, span: str):
    """Device time per denoise step of the operations outside the kernel
    families (kernels/*.json) launched inside the host spans named
    ``span`` of the traced image, ms; None where the trace has none."""
    if run.trace is None or not run.traced_steps():
        return None
    ops = [dur for name, _, dur, _ in run.trace.ops_launched_in(span)
           if run.family_of(name) is None]
    if not ops:
        return None
    return sum(ops) * 1e-3 / run.traced_steps()

"""Open loop: requests arrive on a schedule, whatever the server's state,
and go to ``FluxServer.submit``; each is timed from when it was due to its
u8 image.

The schedule is one fixed sample of Poisson arrivals at the mix's rate:
``round(rate * seconds)`` exponential gaps and resolutions (by the mix's
weights), drawn from the mix's ``schedule_seed`` and scaled so that the
mean gap is exactly 1 / rate. Every run offers that same schedule, in the
same order: at some thirty requests a window, the order alone moved the
90th percentile by a fifth from one rotation of it to another. A run's seed
draws the prompts (unique, so the encode cache gets no hits), the image
seeds and the weights.

The server's ``submit`` encodes on the calling thread, so a pool of
``submit_threads`` threads submits; the generator records how late each
submit started.
``timed``: ``"all"`` waits for every request due in the window (up to
``drain_s`` past its close: one not back by then, or failed, is missing);
``"in_window"`` counts the images completed before the close, and leaves
what is still queued or in flight untimed."""

from __future__ import annotations

import math
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from benchmark.harness.requests import Request, image_seed, prompt


def base_schedule(mix: dict, seconds: float):
    """The mix's fixed schedule: (gaps, resolution indices), n = round(rate * seconds)."""
    n = max(1, int(round(mix["rate_per_s"] * seconds)))
    rng = np.random.default_rng(int(mix["schedule_seed"]))
    gaps = rng.exponential(1.0, size=n)
    gaps *= (n / mix["rate_per_s"]) / gaps.sum()
    w = np.asarray(mix["weights"], float)
    sizes = rng.choice(len(mix["resolutions"]), size=n, p=w / w.sum())
    return gaps, sizes


def schedule(mix: dict, seed: int, seconds: float):
    gaps, sizes = base_schedule(mix, seconds)
    n = len(gaps)
    rng = np.random.default_rng([int(seed), 0x09E4])
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    lo, hi = mix["prompt_words"]
    out = []
    for i in range(n):
        h, w = mix["resolutions"][sizes[i]]
        out.append(Request(i, prompt(rng, lo, hi, tag=f"r{seed}x{i}"), image_seed(rng), h, w,
                           due_s=float(due[i])))
    return out


def warm(run, mix, requests):
    """The server, and every resolution of the mix at every batch bucket:
    a burst of ``max_batch`` requests, then one alone."""
    run.make_server(**mix["server"])
    burst = mix["server"].get("max_batch", 4)
    for h, w in sorted({tuple(r) for r in mix["resolutions"]}):
        futs = [run.submit(Request(i, f"warm {h} {w} {i}", i, h, w)) for i in range(burst)]
        [f.result() for f in futs]
        run.submit(Request(burst, f"warm {h} {w} alone", burst, h, w)).result()


def drive(run, mix, requests, seconds: float, tracer=None) -> dict:
    """Submit on schedule. ``tracer`` (trace runs only) is started
    ``trace_window_s`` before the window's close and stopped at the close:
    the profiled sub-window, the last stretch of the same traffic."""
    server = run.server
    lock = threading.Lock()
    recs = {}
    late = []
    pool = ThreadPoolExecutor(max_workers=mix["submit_threads"],
                              thread_name_prefix="bench-submit")

    def submit(r, due_abs):
        start = time.perf_counter()
        rec = {"request": r, "due": due_abs, "late_s": start - due_abs, "end": None,
               "error": None}
        with lock:
            recs[r.index] = rec
            late.append(start - due_abs)
        try:
            with run.span("bench.submit"):
                fut = run.submit(r)
        except Exception as e:  # refused (queue full) or the encode failed: missing
            rec["error"] = repr(e)
            return

        def done(f):
            rec["end"] = time.perf_counter()
            if f.cancelled():
                rec["error"] = "cancelled"
            elif f.exception() is not None:
                rec["error"] = repr(f.exception())
            else:
                rec["image"] = f.result()

        fut.add_done_callback(done)
        rec["future"] = fut

    stats0 = server.stats()
    t0 = time.perf_counter() + 0.05
    close = t0 + seconds
    start = seconds - mix.get("trace_window_s", 0.0)

    def wait_until(when):
        """Sleep until ``when``, starting the tracer on time."""
        while True:
            now = time.perf_counter()
            if tracer is not None:
                tracer.poll(now - t0, start)
                wake = min(when, tracer.next_action(t0, start))
            else:
                wake = when
            if now >= when:
                return
            time.sleep(max(0.0, wake - now))

    for r in requests:
        due_abs = t0 + r.due_s
        if due_abs >= close:
            break
        wait_until(due_abs)
        pool.submit(submit, r, due_abs)
    wait_until(close)
    stats_close = server.stats()
    if tracer is not None:
        tracer.stop()
    pool.shutdown(wait=True)
    due = [recs[i] for i in sorted(recs)]
    if mix["timed"] == "all":
        deadline = close + mix["drain_s"]
        for rec in due:
            fut = rec.get("future")
            if fut is not None and rec["end"] is None:
                try:
                    fut.result(timeout=max(0.0, deadline - time.perf_counter()))
                except Exception:  # late or failed: judged below by its record
                    pass
        time.sleep(0.01)  # done-callbacks run right after the result is set
        stats1 = server.stats()
        lat = [(rec["end"] - rec["due"]) if rec["end"] is not None and rec["error"] is None
               else math.inf for rec in due]
        completed = [rec for rec in due if rec["end"] is not None and rec["error"] is None]
        failed = len(due) - len(completed)
    else:
        stats1 = stats_close
        completed = [rec for rec in due
                     if rec["end"] is not None and rec["end"] <= close and rec["error"] is None]
        lat = [rec["end"] - rec["due"] for rec in completed]
        failed = sum(1 for rec in due if rec["error"] not in (None, "cancelled"))
    timeline = [(rec["due"] - t0, math.inf if rec["end"] is None or rec["error"] is not None
                  else rec["end"] - t0) for rec in due]
    return {"completed": completed, "attempted": len(due), "failed": failed,
            "latencies": lat, "window_s": seconds, "late_s": late, "timeline": timeline,
            "stats": {k: stats1[k] - stats0[k] for k in
                      ("forwards", "lane_steps", "padded_lane_steps", "encode_cache_hits",
                       "completed", "failed", "rejected")},
            "queue_at_close": stats1["queue_depth"]}

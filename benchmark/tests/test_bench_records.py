"""The readers of the program's own records (benchmark/harness/records.py
and the metrics that use it) on synthetic runs: stub server records, a
hand-built trace. Each returns the number reckoned by hand, or None where
its source is missing (a program without the records, a CPU run)."""

from types import SimpleNamespace

import pytest

from benchmark.harness import manifest, trace as tracing
from benchmark.harness.requests import Request

T0 = 100.0  # the window's start on the host clock


def reader(name):
    return manifest.load_module("metrics", name).read


class StubServer:
    """``request_trace`` / ``trace_snapshot`` from fixed records."""

    def __init__(self, recs, log):
        self.recs, self.log = recs, log

    def request_trace(self, fut):
        return self.recs.get(fut)

    def trace_snapshot(self):
        return list(self.log)


def rec(due_s, arrive, queued, admitted, last_step, done):
    return {"arrive": T0 + arrive, "queued": T0 + queued, "admitted": T0 + admitted,
            "first_step": T0 + admitted + 0.1, "last_step": T0 + last_step,
            "decode_start": T0 + last_step + 0.01, "done": T0 + done, "due_s": due_s}


# three requests due before the traced sub-window opens (window 10 s, the
# last 2 s traced: it opens at 8 s), one due inside it
RECS = [rec(0.0, 0.0, 0.02, 0.5, 1.0, 1.25), rec(1.0, 1.0, 1.04, 1.1, 2.0, 2.05),
        rec(3.0, 3.0, 3.06, 3.3, 4.0, 4.15), rec(8.5, 8.5, 8.9, 9.0, 9.5, 9.6)]
LOG = [
    {"name": "serve.idle", "start": T0 - 5.0, "end": T0 + 0.3},   # clipped at t0: 0.3 s
    {"name": "serve.forward", "start": T0 + 0.5, "end": T0 + 0.6, "device_end": T0 + 0.61},
    {"name": "serve.forward", "start": T0 + 0.7, "end": T0 + 0.8, "device_end": T0 + 0.83},
    {"name": "serve.forward", "start": T0 + 1.0, "end": T0 + 1.1, "device_end": T0 + 1.15},
    {"name": "serve.idle", "start": T0 + 5.0, "end": T0 + 9.0},   # clipped at 8 s: 3 s
    {"name": "serve.forward", "start": T0 + 9.0, "end": T0 + 9.1, "device_end": T0 + 9.9},
]


def serve_run(recs=RECS, log=LOG, server_cls=StubServer):
    done = []
    futs = {}
    for i, r in enumerate(recs):
        fut = object()
        futs[fut] = {k: v for k, v in r.items() if k != "due_s"}
        done.append({"request": Request(i, "p", i, 64, 64, due_s=r["due_s"]),
                     "due": T0 + r["due_s"], "future": fut})
    return SimpleNamespace(out={"completed": done, "window_s": 10.0},
                           mix={"trace_window_s": 2.0}, server=server_cls(futs, log))


def test_serve_readers_by_hand():
    run = serve_run()
    # queue waits 0.48, 0.06, 0.24 s: the nearest-rank p90 of three is the largest
    assert reader("serve_queue_wait_s.steady")(run) == pytest.approx(0.48)
    assert reader("serve_encode_ms.steady")(run) == pytest.approx(1e3 * (0.02 + 0.04 + 0.06) / 3)
    assert reader("serve_decode_ms.steady")(run) == pytest.approx(1e3 * (0.25 + 0.05 + 0.15) / 3)
    assert reader("serve_no_lanes_pct.steady")(run) == pytest.approx(100 * 3.3 / 8.0)
    # backlogs 10, 30, 50 ms before the sub-window (the 800-ms one is inside it)
    for name in ("serve_forward_backlog_ms.steady", "serve_forward_backlog_ms.overload"):
        assert reader(name)(run) == pytest.approx(30.0)


def test_serve_readers_without_their_sources():
    """A server without the records (the program before them), forwards with
    no device time (a CPU run), an empty window: None, no exception."""
    names = ["serve_queue_wait_s.steady", "serve_encode_ms.steady", "serve_decode_ms.steady",
             "serve_no_lanes_pct.steady", "serve_forward_backlog_ms.steady"]
    bare = serve_run(server_cls=lambda recs, log: SimpleNamespace(stats=dict))
    assert all(reader(n)(bare) is None for n in names)
    cpu = serve_run(log=[dict(e, device_end=None) if e["name"] == "serve.forward" else e
                         for e in LOG])
    assert reader("serve_forward_backlog_ms.steady")(cpu) is None
    empty = SimpleNamespace(out={"completed": [], "window_s": 10.0}, mix={}, server=None)
    assert all(reader(n)(empty) is None for n in names)


def image_run(timings, steps=2):
    return SimpleNamespace(out={"completed": [{"timings": t} for t in timings]},
                           steps_per_image=lambda: steps)


def test_image_readers_by_hand():
    run = image_run([{"steps_s": [0.30, 0.31], "steps_host_s": [0.10, 0.29],
                      "launch_wrapper_s": 0.004},
                     {"steps_s": [0.32, 0.30], "steps_host_s": [0.30, 0.25],
                      "launch_wrapper_s": 0.006}])
    assert reader("step_backlog_ms.image")(run) == pytest.approx(1e3 * (0.2 + 0.02 + 0.02 + 0.05)
                                                                  / 4)
    assert reader("launch_wrapper_ms_per_step.image")(run) == pytest.approx(2.5)
    old = image_run([{"steps_s": [0.3, 0.3], "denoise_s": 0.6}])  # the program before them
    assert reader("step_backlog_ms.image")(old) is None
    assert reader("launch_wrapper_ms_per_step.image")(old) is None


def x(name, ts, dur, cat, **args):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat, "args": args}


def test_family_readers_by_hand():
    """Two steps; flux.norm_mod holds an elementwise op (10 us) and the
    modulation's K1 (qmm family, left out); flux.qk_rope a RoPE op (7 us);
    flux.gate_act one GELU (4 us) in each step; a launch outside every span
    (20 us) counts in none."""
    events = [x("flux.norm_mod", 0, 10, "user_annotation"),
              x("launch", 1, 1, "cuda_runtime", correlation=1),
              x("launch", 2, 1, "cuda_runtime", correlation=2),
              x("flux.qk_rope", 12, 5, "user_annotation"),
              x("launch", 13, 1, "cuda_runtime", correlation=3),
              x("launch", 14, 1, "cuda_runtime", correlation=4),
              x("flux.gate_act", 20, 3, "user_annotation"),
              x("flux.gate_act", 30, 3, "user_annotation"),
              x("launch", 21, 1, "cuda_runtime", correlation=5),
              x("launch", 31, 1, "cuda_runtime", correlation=6),
              x("launch", 40, 1, "cuda_runtime", correlation=7),
              x("void at::native::vectorized_elementwise_kernel<4>(int)", 50, 10, "kernel",
                correlation=1),
              x("void qmm_s8_kernel<128>(Params)", 60, 30, "kernel", correlation=2),
              x("void at::native::elementwise_kernel<128, 2>(int)", 90, 3, "kernel",
                correlation=3),
              x("Memcpy DtoD (Device -> Device)", 93, 4, "gpu_memcpy", correlation=4),
              x("void at::native::vectorized_elementwise_kernel<4>(int)", 97, 4, "kernel",
                correlation=5),
              x("void at::native::vectorized_elementwise_kernel<4>(int)", 101, 4, "kernel",
                correlation=6),
              x("void at::native::reduce_kernel<512, 1>(int)", 105, 20, "kernel",
                correlation=7)]
    fams = {n: tracing.family_matcher(f["patterns"]) for n, f in
            manifest.kernel_families().items()}

    def family_of(name):
        return next((f for f, match in fams.items() if match(name)), None)

    run = SimpleNamespace(trace=tracing.Trace(events), traced_steps=lambda: 2,
                          family_of=family_of)
    assert reader("norm_mod_ms_per_step.image")(run) == pytest.approx(10e-3 / 2)
    assert reader("qk_rope_ms_per_step.image")(run) == pytest.approx(7e-3 / 2)
    assert reader("gate_act_ms_per_step.image")(run) == pytest.approx(8e-3 / 2)
    no_spans = SimpleNamespace(trace=tracing.Trace(events[-7:]), traced_steps=lambda: 2,
                               family_of=family_of)
    untraced = SimpleNamespace(trace=None, traced_steps=lambda: 0, family_of=family_of)
    for name in ("norm_mod", "qk_rope", "gate_act"):
        assert reader(f"{name}_ms_per_step.image")(no_spans) is None
        assert reader(f"{name}_ms_per_step.image")(untraced) is None

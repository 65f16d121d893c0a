"""One run of one cell: set-up (weights drawn on the device from the seed,
the pipeline, the cell's warm-up), the measured window, the traced
sub-window (``trace``), the metrics, and the check against the reference.
What is particular to the configuration's model family comes from its route
(``families/<family>.py``)."""

from __future__ import annotations

import gc
import math
import sys
import time

from . import check, manifest, trace as tracing


class Tracer:
    """The profiled sub-window of an open loop: the last ``length_s`` of the
    window. The profiler starts on the generator's thread when the sub-window
    opens and stops at the window's close, after the last submission; its
    trace is reduced once the drain is over, so that no submission waits on
    the profiler's collection or export."""

    def __init__(self):
        self.prof = None

    def poll(self, now_s: float, start_s: float) -> None:
        """Start once ``now_s`` (seconds into the window) reaches ``start_s``."""
        if self.prof is None and now_s >= start_s:
            self.prof = tracing.Profiler()
            self.prof.start()

    def next_action(self, t0: float, start_s: float) -> float:
        """The host clock time of the start (inf: started)."""
        return t0 + start_s if self.prof is None else math.inf

    def stop(self) -> None:
        if self.prof is not None and not self.prof.stopped:
            self.prof.stop()

    def trace(self):
        return None if self.prof is None else self.prof.reduce()


class Run:
    """What a generator drives and what the metric readers read."""

    def __init__(self, man: manifest.Manifest, cell: dict, seed: int, seconds: float,
                 device):
        self.man = man
        self.cell = cell
        self.cfg = man.config(cell)
        self.route = manifest.route(self.cfg)
        self.mix = man.traffic(cell)
        self.gen = manifest.generator(self.mix)
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.device = device
        self.pipe = None
        self.tap = None
        self.server = None
        self.server_tap = None
        self.out = {}
        self.trace = None
        self.traced = None
        self.setup_s = None
        self.peak_bytes = None
        self.families = {name: tracing.family_matcher(f["patterns"])
                         for name, f in manifest.kernel_families().items()}
        self.work = manifest.work_model(self.cfg)

    # -- what generators call ---------------------------------------------------

    def image(self, req, num_steps=None):
        """One request through the timed entry at batch 1: its u8 image."""
        return self.route.image(self.pipe, self.cfg, req, num_steps)

    def make_server(self, **kw):
        self.server, self.server_tap = self.route.server(self.pipe, **kw)
        return self.server

    def submit(self, req):
        """One request to the server: its Future."""
        return self.route.submit(self.server, self.cfg, req)

    @staticmethod
    def span(name: str):
        import torch

        return torch.profiler.record_function(name)

    @staticmethod
    def profiled():
        return tracing.profiled()

    # -- what readers call --------------------------------------------------------

    def steps_per_image(self) -> int:
        return int(self.cfg["generation"]["num_steps"])

    def step_work(self) -> dict:
        t = self.traced
        return self.work.step(self.cfg, t["batch"], t["height"], t["width"])

    def denoise_ops(self):
        """(name, ts, dur, cat) of the traced denoise's device operations."""
        return [] if self.trace is None else self.trace.ops_launched_in("denoise")

    def family_of(self, name: str):
        for fam, match in self.families.items():
            if match(name):
                return fam
        return None

    def traced_steps(self) -> int:
        return self.traced["steps"] * self.traced["images"] if self.traced else 0


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(root, workload: str, seed: int, seconds: float, trace: bool, t_start: float,
        device=None, man=None) -> dict:
    """The result line of one run (``device`` None: the first card; ``man``:
    a Manifest other than the checkout's)."""
    import torch

    man = man or manifest.Manifest(root)
    cell = man.cell(workload)
    device = torch.device(device or "cuda")
    r = Run(man, cell, seed, seconds, device)
    names = man.metric_names(cell, trace)
    readers = {n: manifest.load_module("metrics", n) for n in names}

    # inside set-up (the build is part of a first run's set-up), and printed apart
    build_s = r.route.build_kernels() if device.type == "cuda" else 0.0
    with torch.no_grad():
        planes = r.route.planes(r.cfg, r.seed, device)
        r.pipe, r.tap = r.route.build(r.cfg, planes, device)
        del planes
        requests = r.gen.schedule(r.mix, r.seed, r.seconds)
        r.gen.warm(r, r.mix, requests)
        if trace:  # the profiler's own start-up, outside the window
            with tracing.profiled():
                torch.ones(1, device=device).add_(1)
        _sync(device)
        r.setup_s = time.perf_counter() - t_start

        if trace and hasattr(r.gen, "traced"):
            r.out = r.gen.drive(r, r.mix, requests, r.seconds)
            r.trace, r.traced = r.gen.traced(r, r.mix, requests)
        elif trace:
            tracer = Tracer()
            r.out = r.gen.drive(r, r.mix, requests, r.seconds, tracer=tracer)
            tracer.stop()
            r.trace = tracer.trace()
        else:
            r.out = r.gen.drive(r, r.mix, requests, r.seconds)
        _sync(device)
        if r.server is not None:
            r.server.shutdown()
        r.peak_bytes = (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
                        else 0)

        metrics = {}
        for n in names:
            v = readers[n].read(r)
            if v is not None:
                metrics[n] = {"value": float(v), "unit": man.metrics[n]["unit"]}

        batches = ()
        if r.server_tap is not None:
            for rec in r.out["completed"]:
                rec["latent"] = r.server_tap.latents.get(rec.get("future"))
            batches = r.server_tap.batches
        records = check.sample(r.out["completed"], r.seed, r.cfg["check"]["samples"], batches)
        # the program's state goes before the reference runs
        r.pipe = r.server = r.tap = r.server_tap = None
        r.out["completed"] = []
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        verdict = check.compare(r.cfg, r.seed, records, device, r.cfg["check"])

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(r.peak_bytes)}
    result = {"correct": verdict["correct"], "attempted": int(r.out["attempted"]),
              "failed": int(r.out["failed"]), "metrics": metrics, "device": dev}
    if trace and r.trace is not None:
        dev["busy_s"] = r.trace.busy_s()
        dev["window_s"] = r.trace.window_s()
        result["breakdown"] = r.trace.breakdown()
    late = r.out.get("late_s")
    result["generator_late_s"] = ({"max": max(late), "mean": sum(late) / len(late)}
                                  if late else None)
    result["build_s"] = build_s
    result["reference_s"] = verdict["seconds"]
    result["check"] = {k: {"value": v, "limit": lim}
                       for k, (v, lim) in verdict["numbers"].items()}
    if "each" in verdict:
        print(f"check each {verdict['each']!r}", file=sys.stderr)
    for k, (v, lim) in verdict["numbers"].items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    return result


def percentile(values, q: float) -> float:
    """Nearest-rank percentile (a missing request is +inf)."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]

"""Closed loop: one caller, sending its next image only when the last one
is back, through the family's timed entry (for FLUX,
``FluxPipeline.forward_arrays``) at batch 1. The mix gives the resolutions
and their weights and the prompt length range; the run's seed draws each
request's prompt, image seed and resolution. The window's images are timed
whole: prompt in, u8 image on the host."""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from benchmark.harness.requests import Request, image_seed, prompt


def schedule(mix: dict, seed: int, seconds: float, count: int = 1024):
    """``count`` requests, more than a window completes."""
    rng = np.random.default_rng([int(seed), 0xC105ED])
    res = mix["resolutions"]
    w = np.asarray(mix["weights"], float)
    picks = rng.choice(len(res), size=count, p=w / w.sum())
    lo, hi = mix["prompt_words"]
    return [Request(i, prompt(rng, lo, hi), image_seed(rng), *res[picks[i]])
            for i in range(count)]


def warm(run, mix, requests):
    """One short image at each resolution of the mix."""
    for h, w in {tuple(r) for r in mix["resolutions"]}:
        run.image(dataclasses.replace(requests[0], height=h, width=w), mix["warm_steps"])


def drive(run, mix, requests, seconds: float) -> dict:
    """Images back to back while the window is open; every image started in
    the window is finished and counted."""
    done = []
    t0 = time.perf_counter()
    for r in requests:
        if time.perf_counter() - t0 >= seconds:
            break
        a = time.perf_counter()
        with run.span("bench.image"):
            img = run.image(r)
        b = time.perf_counter()
        done.append({"request": r, "start": a, "end": b, "image": img,
                     "latent": run.tap.take(), "timings": dict(run.pipe.timings)})
    return {"completed": done, "failed": 0, "window_s": time.perf_counter() - t0,
            "attempted": len(done)}


def traced(run, mix, requests):
    """The profiled sub-window: one more image of the mix, after the window."""
    r = requests[-1]
    with run.profiled() as prof:
        with run.span("bench.image"):
            run.image(r)
    return prof.trace, {"images": 1, "steps": run.cfg["generation"]["num_steps"],
                        "height": r.height, "width": r.width, "batch": 1}

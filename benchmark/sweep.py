"""The knee of a serve cell's mix: the highest offered rate at which the
server's backlog does not grow over a window.

    python3 benchmark/sweep.py --workload schnell-nf4-serve --rates 1.0,1.5,2.0 --seconds 40

Builds the cell's pipeline and server once (weights from ``--seed``), warms
them as a run does, then offers the cell's mix at each rate in turn through
the open loop (``traffic/open_loop.py``), every request due in the window
timed to its image and the backlog drained before the next rate. The
backlog (requests due and not yet done, whether queued in the server or
still waiting to be submitted) is read every 0.25 s of the window from the
requests' due and done times; it grows when a least-squares line over the
window's second half rises by more than ``max_batch`` requests over that
half. Stops at the first rate whose backlog
grows. Prints one JSON line per rate and the knee last. The cells' traffic files fix their rates from it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def grows(samples, seconds: float, limit: float) -> tuple:
    """(slope in requests/s over the window's second half, whether the rise
    over that half exceeds ``limit``)."""
    import numpy as np

    pts = [(t, b) for t, b in samples if seconds / 2 <= t <= seconds]
    if len(pts) < 3:
        return 0.0, False
    t, b = np.array(pts, float).T
    slope = float(np.polyfit(t, b, 1)[0])
    return slope, slope * seconds / 2 > limit


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True, help="comma-separated requests/s, ascending")
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--seed", type=int, default=20261018)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.harness import main as harness, manifest

    man = manifest.Manifest(ROOT)
    cell = man.cell(args.workload)
    run = harness.Run(man, cell, args.seed, args.seconds, torch.device(args.device))
    with torch.no_grad():
        run.pipe, run.tap = run.route.build(
            run.cfg, run.route.planes(run.cfg, run.seed, run.device), run.device)
        run.gen.warm(run, run.mix, [])
        knee = None
        for rate in (float(r) for r in args.rates.split(",")):
            mix = dict(run.mix, rate_per_s=rate, timed="all", drain_s=600)
            reqs = run.gen.schedule(mix, run.seed, args.seconds)
            out = run.gen.drive(run, mix, reqs, args.seconds)
            ticks = [0.25 * i for i in range(int(args.seconds / 0.25) + 1)]
            samples = [(t, sum(1 for d, e in out["timeline"] if d <= t)
                        - sum(1 for d, e in out["timeline"] if e <= t)) for t in ticks]
            slope, up = grows(samples, args.seconds, mix["server"].get("max_batch", 4))
            lat = sorted(out["latencies"])
            row = {"rate_per_s": rate, "requests": out["attempted"], "failed": out["failed"],
                   "backlog_slope_per_s": slope, "grows": up,
                   "backlog_max": max(b for _, b in samples),
                   "p50_s": lat[len(lat) // 2], "p90_s": harness.percentile(lat, 90.0),
                   "lanes_per_forward": out["stats"]["lane_steps"] / max(1, out["stats"]["forwards"]),
                   "occupancy_pct": 100.0 * out["stats"]["lane_steps"] / max(
                       1, out["stats"]["lane_steps"] + out["stats"]["padded_lane_steps"]),
                   "device": torch.cuda.get_device_name() if run.device.type == "cuda" else "cpu"}
            print(json.dumps(row), flush=True)
            if up:
                break
            knee = rate
        run.server.shutdown()
    print(json.dumps({"workload": args.workload, "knee_per_s": knee,
                      "steady_rate_per_s": None if knee is None else round(0.8 * knee, 3),
                      "overload_rate_per_s": None if knee is None else round(1.5 * knee, 3)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

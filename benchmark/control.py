"""The controls of the correctness check, read on the card at a cell's own
sizes (the benchmark's runs never run them):

    python3 benchmark/control.py --config flux1-dev-q8t --seeds 1,2,3 --res 1024x1024

For each seed and resolution: one request (prompt and image seed drawn from
the seed, as the traffic draws them) through the program's timed entry (the
configuration's family route, ``families/<family>.py``), with the latent
taken where the timed path hands it to the decode; the same with the
program's own lower-precision attention (DIFFUSION_RS_TPU_ATTN_S8=1 and ATTN_S8PV=1: int8
QK^T and P.V); then, in the program's place, the reference in each precision
of ``--controls`` (``reference/common.Precision``). Each is read by the
check's two numbers (``harness/check.judge``) against the float32
reference. One JSON line per seed and resolution, a summary line last.
"""

import argparse
import gc
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated run seeds")
    ap.add_argument("--res", default="1024x1024", help="comma-separated HxW")
    ap.add_argument("--controls", default="fp8_products,fp8_activations")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    os.environ.setdefault("DIFFUSION_RS_TORCH_BUILD", str(ROOT / "build" / "torch_kernels"))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from benchmark.harness import check, manifest
    from benchmark.harness.requests import Request, image_seed, prompt
    from benchmark.reference.common import Precision

    cfg = json.loads((ROOT / "benchmark" / "configs" / f"{args.config}.json").read_text())
    route = manifest.route(cfg)
    dev = torch.device(args.device)
    sizes = [tuple(int(v) for v in r.split("x")) for r in args.res.split(",")]
    controls = args.controls.split(",") if args.controls else []
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        rng = np.random.default_rng([seed, 0xC0])
        lo, hi = 5, min(60, cfg["generation"]["max_sequence_length"])
        reqs = [Request(i, prompt(rng, lo, hi), image_seed(rng), h, w)
                for i, (h, w) in enumerate(sizes)]
        with torch.no_grad():
            pl = route.planes(cfg, seed, dev)
            pipe, tap = route.build(cfg, pl, dev)
            prog = {"0": [], "1": []}
            for knob, out in prog.items():
                os.environ["DIFFUSION_RS_TPU_ATTN_S8"] = knob
                os.environ["DIFFUSION_RS_TPU_ATTN_S8PV"] = knob
                from diffusion_rs_tpu_torch.ops import attention

                for f in (attention._s8_default, attention._s8_pv_default):
                    f.cache_clear()
                for r in reqs:
                    img = route.image(pipe, cfg, r)
                    out.append((tap.take(), img))
            os.environ["DIFFUSION_RS_TPU_ATTN_S8"] = "0"
            os.environ["DIFFUSION_RS_TPU_ATTN_S8PV"] = "0"
            for i, r in enumerate(reqs):
                ref_lat = route.reference_latent(cfg, pl, r, dev).cpu().numpy()
                row = {"seed": seed, "res": f"{r.height}x{r.width}"}
                for name, (lat, img) in (("program", prog["0"][i]),
                                         ("program_attn_s8", prog["1"][i])):
                    row[name] = check.judge(cfg, pl, r, lat, img, ref_lat, dev)
                for c in controls:
                    lat = route.reference_latent(cfg, pl, r, dev, Precision(c))
                    img = route.decode_u8(cfg, pl, lat, r, Precision(c))
                    row[c] = check.judge(cfg, pl, r, lat.cpu().numpy(), img, ref_lat, dev)
                pimg = prog["0"][i][1]
                row["saturated"] = float(np.mean((pimg == 0) | (pimg == 255)))
                rows.append(row)
                print(json.dumps(row), flush=True)
            del pipe, tap, pl
            gc.collect()
            torch.cuda.empty_cache()
    summ = {f"{who}.{k}": {"min": min(r[who][k] for r in rows),
                           "max": max(r[who][k] for r in rows)}
            for who in ["program", "program_attn_s8"] + controls
            for k in ("latent_rel_err", "decode_rel_err")}
    print(json.dumps({"config": args.config, "summary": summ}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The benchmark of the PyTorch/CUDA port (``diffusion_rs_tpu_torch``).

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json`` on the first card: set-up (the weights
drawn on the card from the seed, the pipeline, the cell's warm-up), the
measured window of ``--seconds``, with ``--trace 1`` a profiled sub-window,
then the check of the window's images against the float32 reference. The
last line of standard output is the result (one JSON object); the numbers
checked and their limits are the last lines of standard error.

Every cache goes inside the checkout, at fixed paths under ``build/``: the
port's kernel libraries in ``build/torch_kernels/`` (built at the first run
of a checkout), Triton's and PyTorch's own under ``build/bench_cache/``.
It exits non-zero, printing no result, without enough CUDA cards, and when
``jax``, ``jaxlib``, ``flax`` or the JAX package is loaded at the end.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "diffusion_rs_tpu")


def _cache_env() -> None:
    cache = ROOT / "build" / "bench_cache"
    os.environ["DIFFUSION_RS_TORCH_BUILD"] = str(ROOT / "build" / "torch_kernels")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_env()
    sys.path.insert(0, str(ROOT))

    import torch

    from benchmark.harness import main as harness
    from benchmark.harness.manifest import Manifest

    cell = Manifest(ROOT).cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = harness.run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                         T_START)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 4
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

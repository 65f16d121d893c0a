"""Shared fixtures of the benchmark's own tests (run from the repository
root: ``python -m pytest benchmark/tests``). They import neither JAX nor the
JAX package; tests that need a card are marked ``cuda`` and skip without
one."""

import json
import sys
import tempfile
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
HERE = Path(__file__).resolve().parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def tiny_manifest():
    """A manifest of two tiny cells (``t-image``: q8t through the pipeline,
    ``t-serve``: nf4 through the server) over the real metric readers, kernel
    families and generators, with the tests' configurations and mixes."""
    from benchmark.harness import manifest

    tmp = Path(tempfile.mkdtemp(prefix="bench-tiny-"))
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    b["configs"] = [{"name": n, "source": "test", "file": str(HERE / f"{n}.json"),
                     "reduced": [], "why": "test"} for n in ("tiny-flux-q8t", "tiny-flux-nf4")]
    b["workloads"] = [
        {"name": "t-image", "config": "tiny-flux-q8t", "traffic": "tiny-image", "chips": 1,
         "why": "test"},
        {"name": "t-serve", "config": "tiny-flux-nf4", "traffic": "tiny-serve", "chips": 1,
         "why": "test"}]
    cells = {"dev-q8t-image": "t-image", "schnell-nf4-image": "t-image",
             "schnell-nf4-serve": "t-serve"}
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m:
            m["workloads"] = sorted({cells[w] for w in m["workloads"] if w in cells})
    (tmp / "BENCHMARK.json").write_text(json.dumps(b))
    return tmp, manifest.Manifest(tmp, traffic_dir=HERE)


@pytest.fixture(scope="session")
def tiny():
    import torch

    torch.set_num_threads(2)
    return tiny_manifest()

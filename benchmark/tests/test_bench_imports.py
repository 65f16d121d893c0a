"""Nothing the benchmark runs loads JAX or the JAX package (top-level module
names compared whole), and the reference imports nothing of the program."""

import ast
import subprocess
import sys

import pytest

from benchmark.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "diffusion_rs_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    files = sorted((ROOT / "benchmark" / "reference").glob("*.py"))
    assert files
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in FORBIDDEN | {"diffusion_rs_tpu_torch"}, (f, name)


def test_no_module_imports_jax():
    for f in sorted((ROOT / "benchmark").rglob("*.py")):
        for name in _imports(f):
            assert name.split(".")[0] not in FORBIDDEN, (f, name)


def test_a_harness_run_loads_no_jax():
    """A whole tiny run on the CPU in a fresh interpreter, then sys.modules."""
    code = f"""
import sys, time
sys.path.insert(0, {str(ROOT)!r})
sys.path.insert(0, {str(ROOT / 'benchmark' / 'tests')!r})
import torch
torch.set_num_threads(2)
from benchmark.tests.conftest import tiny_manifest
from benchmark.harness import main
root, man = tiny_manifest()
res = main.run(root, "t-serve", 7, 1.0, True, time.perf_counter(), device="cpu", man=man)
assert res["correct"], res
res = main.run(root, "t-image", 7, 1.0, False, time.perf_counter(), device="cpu", man=man)
assert res["correct"], res
sys.path.insert(0, {str(ROOT / 'benchmark')!r})
import run
print("LOADED", run.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout, out.stdout[-2000:]


def test_run_refuses_without_a_card():
    """With no CUDA device the command exits non-zero and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "dev-q8t-image",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_command_on_the_card(cuda_device):
    """The command itself, a short traced run of the cheapest cell: one
    result line, correct, the device busy, and no JAX loaded."""
    import json

    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "schnell-nf4-image", "--seed", str(2 ** 31 + 77), "--seconds", "3",
                          "--trace", "1"], capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["busy_s"] > 0
    assert list(res)[-1] == "check" and res["metrics"]

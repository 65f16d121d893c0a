"""The port's bench script (python -m diffusion_rs_tpu_torch.bench) at
``--small --device cpu``: each mode prints one parseable JSON line with the
root bench's keys, ``vs_baseline`` null (the root bench's baselines are TPU
numbers) and the device named; ``--mesh tp=2`` is refused in a world of
one process."""

import importlib.util
import json
from pathlib import Path

import pytest

import torch

from diffusion_rs_tpu_torch.bench import PRESETS, main


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs several workers on the host's
    cores, and the bench's bf16 CPU kernels slow down by an order of
    magnitude when their thread pools oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("argv", [
    ["--mode", "image", "--iters", "1", "--steps-image", "2"],
    ["--mode", "step", "--steps", "2"],
    ["--mode", "serve"],
    ["--mode", "serve", "--serve-workload", "lru"],
], ids=["image", "step", "serve", "serve-lru"])
def test_small_modes_print_one_json_line(argv, capsys):
    assert main(["--small", "--device", "cpu", *argv]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert set(row) == {"metric", "value", "unit", "vs_baseline", "device"}
    assert row["vs_baseline"] is None and row["device"] == "cpu"
    assert row["value"] > 0 and row["unit"] == "images/sec/chip"


def test_presets_are_the_root_benchs():
    spec = importlib.util.spec_from_file_location(
        "root_bench", Path(__file__).resolve().parents[1] / "bench.py")
    root_bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root_bench)
    assert PRESETS == root_bench.PRESETS


def test_mesh_with_tp_is_refused():
    """``--mesh tp=2`` is taken (tp is ported), but without the ranks'
    environment the world is one process, which the mesh refuses."""
    with pytest.raises(ValueError, match=r"tp\(2\) != world_size\(1\)"):
        main(["--small", "--device", "cpu", "--mesh", "tp=2"])

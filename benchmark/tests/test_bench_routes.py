"""One route per model family: the ``flux`` route draws the parent's
planes, schedules and noise bit for bit (digests pinned on the tree before
the routes) and the reference latents pinned below, a second family comes
in as files only and runs through the harness, and a family with no route
fails at once."""

import dataclasses
import hashlib
import json
import time

import pytest
import torch

from benchmark.tests.conftest import HERE, ROOT, tiny_manifest

from benchmark.harness import check, main, manifest
from benchmark.reference import pipeline as reference

CONFIGS = ("tiny-flux-q8t", "tiny-flux-nf4")
SEEDS = (7, 791221087)
FAMILY = HERE / "family"  # the test-only family flux_cond, laid out as benchmark/ is

PLANES = {
    ("tiny-flux-q8t", 7): {
        "flux": "04f3008dc864cc4fdc2f7f1367fac5b17178946b46ab0cc1e3f1a661783ab7dd",
        "t5": "b9ad5d8d0872bcf0edb1f68da422d345b24ab27363f718cacc00dd8e49a20ba3",
        "clip": "faad55682528215848baa3f2b49afc8dd9b9087a2160d361f032109000c5ce8d",
        "vae": "c1490146234c5c18f0a78d486aee741ce66e32bdce907db779f40e54877301ba",
    },
    ("tiny-flux-q8t", 791221087): {
        "flux": "bbb6862bbdb4b9ba0c2a5ff3382df93cd8e2c5893c2f6f449ad360e7c82fe402",
        "t5": "87c87a804d9984d0b718ff44686ca356b895cbada9f7cf44c341092392c3872c",
        "clip": "b3f79f7041706245b71f614ce5e5233a2428f438a4e160a81f2c165978a35d98",
        "vae": "5c7351ee3dd2a91598f0e06add660cb9d8dee147fe48bb1fe5ba68f0601ce191",
    },
    ("tiny-flux-nf4", 7): {
        "flux": "12f700bcd606aeef89e737c041d6336e808e498077a4d5796a78a03623e9d8a5",
        "t5": "b9ad5d8d0872bcf0edb1f68da422d345b24ab27363f718cacc00dd8e49a20ba3",
        "clip": "faad55682528215848baa3f2b49afc8dd9b9087a2160d361f032109000c5ce8d",
        "vae": "c1490146234c5c18f0a78d486aee741ce66e32bdce907db779f40e54877301ba",
    },
    ("tiny-flux-nf4", 791221087): {
        "flux": "bee9b685e31c53693115b6bf7d76a12cb9054f6637c28258d83558e5d24c914a",
        "t5": "87c87a804d9984d0b718ff44686ca356b895cbada9f7cf44c341092392c3872c",
        "clip": "b3f79f7041706245b71f614ce5e5233a2428f438a4e160a81f2c165978a35d98",
        "vae": "5c7351ee3dd2a91598f0e06add660cb9d8dee147fe48bb1fe5ba68f0601ce191",
    },
}
SCHEDULES = {  # the first 8 requests: closed loop (tiny-image), open loop (tiny-serve)
    7: ("48a802c0ec8798eb5fb2ce2c85b31b3b47a878db74c3a80fd4f30e7cbb9b506e",
        "771466180898ddefe9e776a2218d81b3d86c1afffd6ff432e1f1c1c89f476373"),
    791221087: ("534a408aef947d62ac2634e78f78f4dc08640f4b5d7d096b342d2aafc18bfc7d",
        "958b43e0b4417d714d5f640f6fd48dea5ab8ec1de0efa72af83d7fafde338860"),
}
NOISE = {  # the reference's initial noise of the closed loop's first request
    7: "41b867accc68363a15685db7568e6f30d9758ac61682b41baac3c698890814e8",
    791221087: "0b74250cade9265879616e908d747a9a55e29f855cac05bf97029111a6d75dab",
}
REFERENCE_LATENTS = {  # of that request, its T5 in the configuration's stated bfloat16
    ("tiny-flux-q8t", 7): "b5ecad68201f782b1986071229c687f8a41c4cc73474b5f4be024d62ee6a3fe0",
    ("tiny-flux-q8t", 791221087):
        "e364c6d0e7f32d2919bb2128ea99cd861d4f6fab0c52a0f938ff8d7362264515",
    ("tiny-flux-nf4", 7): "6644acc689bf3fdfedbf7b7fc441a93b17f0c71546c41cdbba51952632bf37dc",
    ("tiny-flux-nf4", 791221087):
        "f1cfb7b4bbab11cc0ae11b54d7b62879051141e0c2272f350b536fc074e203cb",
}


def leaves(node, path=""):
    """(path, tensor) of a plane tree, in its order."""
    if isinstance(node, torch.Tensor):
        yield path, node
    elif isinstance(node, dict):
        for k, v in node.items():
            yield from leaves(v, f"{path}/{k}")
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from leaves(v, f"{path}/{i}")
    elif dataclasses.is_dataclass(node):
        for f in dataclasses.fields(node):
            yield from leaves(getattr(node, f.name), f"{path}.{f.name}")
    elif node is not None and not isinstance(node, (int, float, str)):
        raise TypeError(f"{path}: {type(node)}")


def tensor_bytes(t: torch.Tensor) -> bytes:
    return t.detach().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def planes_digest(tree) -> str:
    h = hashlib.sha256()
    for path, t in leaves(tree):
        h.update(f"{path} {t.dtype} {tuple(t.shape)}\n".encode())
        h.update(tensor_bytes(t))
    return h.hexdigest()


def requests_digest(reqs) -> str:
    h = hashlib.sha256()
    for r in reqs:
        h.update(repr((r.index, r.prompt, r.seed, r.height, r.width, r.due_s)).encode())
    return h.hexdigest()


def config(name):
    return json.loads((HERE / f"{name}.json").read_text())


def mix(name):
    return json.loads((HERE / f"{name}.json").read_text())


def first_requests(name, seed, n=8):
    m = mix(name)
    return manifest.generator(m).schedule(m, seed, 1.0)[:n]


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", CONFIGS)
def test_planes_are_the_parents(name, seed):
    cfg = config(name)
    planes = manifest.route(cfg).planes(cfg, seed, "cpu")
    assert {k: planes_digest(v) for k, v in planes.items()} == PLANES[(name, seed)]


@pytest.mark.parametrize("seed", SEEDS)
def test_schedules_are_the_parents(seed):
    got = (requests_digest(first_requests("tiny-image", seed)),
           requests_digest(first_requests("tiny-serve", seed)))
    assert got == SCHEDULES[seed]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", CONFIGS)
def test_reference_latent_is_the_parents(name, seed, one_thread):
    cfg = config(name)
    route = manifest.route(cfg)
    req = first_requests("tiny-image", seed, 1)[0]
    z = reference.noise(req.seed, req.height, req.width, "cpu")
    assert hashlib.sha256(tensor_bytes(z)).hexdigest() == NOISE[seed]
    lat = route.reference_latent(cfg, route.planes(cfg, seed, "cpu"), req, "cpu")
    assert lat.dtype == torch.float32
    assert hashlib.sha256(tensor_bytes(lat)).hexdigest() == REFERENCE_LATENTS[(name, seed)]


@pytest.fixture
def second_family(monkeypatch):
    """The tiny manifest with the cell of ``family/cells.json``, and the
    family's directories searched after the benchmark's own."""
    import benchmark.families
    import benchmark.reference
    import benchmark.work

    for pkg, sub in ((benchmark.families, "families"), (benchmark.reference, "reference"),
                     (benchmark.work, "work")):
        monkeypatch.setattr(pkg, "__path__", [*pkg.__path__, str(FAMILY / sub)])
    torch.set_num_threads(2)
    root, _ = tiny_manifest()
    b = json.loads((root / "BENCHMARK.json").read_text())
    add = json.loads((FAMILY / "cells.json").read_text())
    b["configs"] += [dict(c, file=str(ROOT / c["file"])) for c in add["configs"]]
    b["workloads"] += add["workloads"]
    for m in b["end_to_end"] + b["per_layer"]:
        if "t-image" in m.get("workloads", []):
            m["workloads"].append("t-cond")
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return root, manifest.Manifest(root, traffic_dir=HERE)


def _run(fam, monkeypatch, seed):
    root, man = fam
    monkeypatch.setattr(check, "sample", lambda done, seed, n, batches=(): list(done))
    return main.run(root, "t-cond", seed, 1.0, False, time.perf_counter(), device="cpu",
                    man=man)


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 9])
def test_second_family_runs_correct(second_family, monkeypatch, seed):
    out = _run(second_family, monkeypatch, seed)
    assert out["correct"], out["check"]
    assert out["attempted"] >= 1 and "image_s" in out["metrics"]


def test_second_family_without_its_input_reads_incorrect(second_family, monkeypatch):
    """The program side leaves the conditioning out (the ``flux`` route's
    entry in the family's place); the reference keeps it."""
    from benchmark.families import flux

    cfg = json.loads((FAMILY / "tiny-flux-cond.json").read_text())
    monkeypatch.setattr(manifest.route(cfg), "image", flux.image)
    out = _run(second_family, monkeypatch, 3)
    assert not out["correct"]
    assert out["check"]["latent_rel_err"]["value"] > 3 * out["check"]["latent_rel_err"]["limit"]


def test_second_familys_reference_imports_nothing_of_the_program():
    from benchmark.tests.test_bench_imports import FORBIDDEN, _imports

    files = sorted((FAMILY / "reference").glob("*.py"))
    assert files
    for f in files:
        for name in _imports(f):
            assert name.split(".")[0] not in FORBIDDEN | {"diffusion_rs_tpu_torch"}, (f, name)


def test_a_family_with_no_route_fails_at_once(tiny, monkeypatch):
    """Before any plane is drawn or kernel built, naming the missing module."""
    root, man = tiny
    cfg = dict(config("tiny-flux-q8t"), family="no_such_family")
    monkeypatch.setattr(manifest.Manifest, "config", lambda self, cell: cfg)
    with pytest.raises(ModuleNotFoundError, match=r"benchmark/families/no_such_family\.py"):
        main.run(root, "t-image", 1, 1.0, False, time.perf_counter(), device="cpu", man=man)

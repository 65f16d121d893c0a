"""BENCHMARK.json against the contract's shape rules, and every name in it
resolving to its file."""

import json
import re

from benchmark.tests.conftest import ROOT

from benchmark.harness import manifest

B = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_keys_and_limits():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= B["run_seconds"] <= 51 and isinstance(B["run_seconds"], int)
    assert len(B["command"]) <= 32 and all(not w.startswith("/") for w in B["command"])
    assert all(re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and ".." not in p for p in B["paths"])
    cells = 24
    assert (B["run_seconds"] + 60) * (2 + 14 * cells) + cells * 180 + 1200 <= 43200


def test_names_and_units():
    names = [c["name"] for c in B["configs"]] + [w["name"] for w in B["workloads"]]
    names += [m["name"] for m in B["end_to_end"] + B["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in B["workloads"]:
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in B["end_to_end"] + B["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in B["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in B["end_to_end"])
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_cell_resolves_its_files():
    man = manifest.Manifest(ROOT)
    fams = manifest.kernel_families()
    assert {"qmm", "attn"} <= set(fams)
    for w in B["workloads"]:
        cell = man.cell(w["name"])
        cfg = man.config(cell)
        assert cfg["name"] == cell["config"]
        mix = man.traffic(cell)
        gen = manifest.generator(mix)
        assert all(hasattr(gen, f) for f in ("schedule", "warm", "drive"))
        assert manifest.work_model(cfg).step(cfg, 1, 1024, 1024)["peak_s"] > 0
        e2e = man.metric_names(cell, trace=False)
        layer = man.metric_names(cell, trace=True)
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        for n in e2e + layer:
            assert callable(manifest.load_module("metrics", n).read)
        for n in layer:  # each per-layer metric's end-to-end metric is reported there too
            assert man.metrics[n]["moves"] in e2e


def test_configs_are_their_files():
    files = [c["file"] for c in B["configs"]]
    assert len(files) == len(set(files))
    for c in B["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert cfg["num_layers"] == 19 and cfg["num_single_layers"] == 38
        assert cfg["num_attention_heads"] * cfg["attention_head_dim"] == 3072
        assert 0 < cfg["check"]["latent_rel_err"] < 1
        assert 0 < cfg["check"]["decode_rel_err"] < 1

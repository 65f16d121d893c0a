"""The work model against hand values."""

import json

import pytest

from benchmark.tests.conftest import ROOT

from benchmark.work import flux


def cfg(name):
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())


def test_k1_bound_m4096():
    w = flux.linear_work(4096, 3072, 3072, "q8t")
    assert w["bound_s"] * 1e3 == pytest.approx(0.0391, abs=5e-5)  # operations bound
    assert w["bound_s"] == pytest.approx(2 * 4096 * 3072 * 3072 / 1.979e15)


def test_dev_step():
    w = flux.step(cfg("flux1-dev-q8t"), 1, 1024, 1024)
    assert w["linears"]["ops"] / 1e12 == pytest.approx(59.5, abs=0.05)
    assert w["attn"]["ops"] / 1e12 == pytest.approx(14.9, abs=0.05)
    # int8 linears at 1979 TOP/s and bf16 attention at 989 TFLOP/s: 30 + 15 ms
    assert w["peak_s"] * 1e3 == pytest.approx(45.1, abs=0.2)


def test_schnell_step_and_fallback():
    c = cfg("flux1-schnell-nf4")
    w = flux.step(c, 1, 1024, 1024)
    assert w["attn"]["ops"] == pytest.approx(4 * 24 * 4352 ** 2 * 128 * 57)
    assert not flux.runs_in_qmm("nf4", 3072, 64)  # final.proj: N = 64, dequant + matmul
    assert w["qmm"]["ops"] < w["linears"]["ops"]
    nf4 = flux.linear_work(4608, 3072, 12288, "nf4")
    assert nf4["bound_s"] * 1e3 == pytest.approx(0.352, abs=1e-3)

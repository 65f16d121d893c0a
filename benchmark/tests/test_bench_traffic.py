"""The traffic mixes: reproducible from the seed, and an open loop's seeds
offering one schedule of arrivals and sizes."""

import json

import numpy as np
import pytest

from benchmark.tests.conftest import ROOT

from benchmark.harness import manifest

MIXES = sorted(p.stem for p in (ROOT / "benchmark" / "traffic").glob("*.json"))


@pytest.mark.parametrize("mix", MIXES)
def test_schedule_reproducible(mix):
    m = json.loads((ROOT / "benchmark" / "traffic" / f"{mix}.json").read_text())
    gen = manifest.generator(m)
    a = gen.schedule(m, 2 ** 31 + 17, 51.0)
    b = gen.schedule(m, 2 ** 31 + 17, 51.0)
    c = gen.schedule(m, 2 ** 31 + 18, 51.0)
    assert a == b and a != c
    for r in a:
        assert (r.height, r.width) in {tuple(x) for x in m["resolutions"]}
        lo, hi = m["prompt_words"]
        assert lo <= len(r.prompt.split()) <= hi


@pytest.mark.parametrize("mix", [m for m in MIXES if m.startswith("serve")])
def test_open_loop_same_work_every_seed(mix):
    m = json.loads((ROOT / "benchmark" / "traffic" / f"{mix}.json").read_text())
    gen = manifest.generator(m)
    runs = [gen.schedule(m, s, 51.0) for s in (1, 2 ** 31 + 5, 99)]
    n = round(m["rate_per_s"] * 51.0)
    for reqs in runs:
        assert len(reqs) == n and reqs[0].due_s == 0.0
        assert len({r.prompt for r in reqs}) == n  # unique: the encode cache misses
        gaps = np.diff([r.due_s for r in reqs])
        assert abs(gaps.mean() - 1 / m["rate_per_s"]) < 0.3 / m["rate_per_s"]
    work = [[(r.due_s, r.height, r.width) for r in reqs] for reqs in runs]
    assert work[0] == work[1] == work[2]
    assert [r.prompt for r in runs[0]] != [r.prompt for r in runs[1]]

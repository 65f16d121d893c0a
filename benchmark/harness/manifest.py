"""``BENCHMARK.json`` and the files it names, found by name: a cell's
configuration (``configs/<config>.json``), its family's route and work model
(``families/<family>.py``, ``work/<family>.py``), its traffic mix
(``traffic/<mix>.json``, read by the generator ``traffic/<kind>.py``), its
metrics (``metrics/<metric>.py``, one reader each) and the kernel families
(``kernels/<family>.json``)."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent  # the benchmark's folder


class Manifest:
    def __init__(self, root: Path, traffic_dir: Path = HERE / "traffic"):
        self.root = Path(root)
        self.traffic_dir = Path(traffic_dir)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())
        self.cells = {w["name"]: w for w in self.data["workloads"]}
        self.metrics = {m["name"]: dict(m, kind=kind)
                        for kind in ("end_to_end", "per_layer") for m in self.data[kind]}

    def cell(self, name: str) -> dict:
        if name not in self.cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        return self.cells[name]

    def config(self, cell: dict) -> dict:
        entry = next(c for c in self.data["configs"] if c["name"] == cell["config"])
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, cell: dict) -> dict:
        return json.loads((self.traffic_dir / f"{cell['traffic']}.json").read_text())

    def metric_names(self, cell: dict, trace: bool) -> list:
        """The cell's end-to-end metrics (``trace`` False) or per-layer ones.
        A metric with ``workloads`` is the listed cells'; an end-to-end one
        without it is every cell's; a per-layer one without it goes with its
        end-to-end metric."""
        kind = "per_layer" if trace else "end_to_end"
        e2e = {m["name"] for m in self.data["end_to_end"]
               if cell["name"] in m.get("workloads", [cell["name"]])}
        out = []
        for m in self.data[kind]:
            if "workloads" in m:
                ok = cell["name"] in m["workloads"]
            else:
                ok = kind == "end_to_end" or m["moves"] in e2e
            if ok:
                out.append(m["name"])
        return out


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py``. A name may hold dots: a metric split by
    the cells it moves (``device_idle_pct.serve``) falls back to the reader of
    the name with its last part taken off (``device_idle_pct.py``), and so on,
    where it has no file of its own."""
    stem = name
    path = HERE / kind / f"{stem}.py"
    while not path.is_file() and "." in stem:
        stem = stem.rsplit(".", 1)[0]
        path = HERE / kind / f"{stem}.py"
    if not path.is_file():
        raise FileNotFoundError(HERE / kind / f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark.{kind}.{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def generator(mix: dict):
    return importlib.import_module(f"benchmark.traffic.{mix['kind']}")


def kernel_families() -> dict:
    return {p.stem: json.loads(p.read_text()) for p in sorted((HERE / "kernels").glob("*.json"))}


def work_model(cfg: dict):
    return importlib.import_module(f"benchmark.work.{cfg['family']}")


def route(cfg: dict):
    """The route of the configuration's family (``families/<family>.py``)."""
    name = f"benchmark.families.{cfg['family']}"
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        raise ModuleNotFoundError(f"no route for the family {cfg['family']!r} of "
                                  f"{cfg.get('name')!r}: no module {name} "
                                  f"(benchmark/families/{cfg['family']}.py)", name=name) from None

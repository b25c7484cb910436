"""``BENCHMARK.json`` and the files it names, found by name: a
configuration's file (its ``file``), a traffic mix in
``traffic/<traffic>.json``, a cell's limits and settings in
``workloads/<cell>.json``, a metric's reader in ``metrics/<metric>.py``,
and a configuration's ``family`` in ``families/<family>/``. A later cell,
configuration or metric is new files and entries; no file here changes."""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FAMILY_PARTS = ("layout", "port", "reference", "work")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    spec: dict  # workloads/<name>.json: the check's limits, the traced stretch
    family: SimpleNamespace  # the family's layout, port, reference, work


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r}; BENCHMARK.json has "
                   f"{[w['name'] for w in bench['workloads']]}")


def traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def family(name: str) -> SimpleNamespace:
    return SimpleNamespace(**{
        part: importlib.import_module(f"portbench.families.{name}.{part}")
        for part in FAMILY_PARTS})


def cell(bench: dict, name: str, root: Path = ROOT) -> Cell:
    w = workload(bench, name)
    entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((root / entry["file"]).read_text())
    return Cell(name=name, chips=w["chips"], config=config,
                traffic=traffic(w["traffic"]),
                spec=json.loads((HERE / "workloads" / f"{name}.json")
                                .read_text()),
                family=family(config["family"]))


def metrics(bench: dict, name: str, trace: bool) -> list:
    """The cell's end-to-end metrics (trace off): those whose
    ``workloads`` name it, or that have none; or its per-layer metrics
    (trace on): those whose ``workloads`` name it, or, without the key,
    those that move an end-to-end metric the cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", (name,))]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]


def reader(name: str):
    """``read(rec) -> float | None`` of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read

"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""
import json
import re

import pytest

from portbench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BENCH = manifest.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
# keys of widths, which no cut may name
WIDTH = re.compile(r"(_dim$|_rank$|^hidden_size$|intermediate_size$|^head|"
                   r"expan|experts_per_tok)")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_run_seconds_fit_a_full_check():
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", METRICS + BENCH["workloads"]
                         + BENCH["configs"], ids=lambda e: e["name"])
def test_names(entry):
    assert NAME.match(entry["name"])


def test_names_unique():
    for group in (METRICS, BENCH["workloads"], BENCH["configs"]):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in SOURCES
    assert callable(manifest.reader(metric["name"]))
    for cell in metric.get("workloads", ()):
        assert cell in CELLS


@pytest.mark.parametrize("metric", BENCH["end_to_end"],
                         ids=lambda m: m["name"])
def test_end_to_end_bounds(metric):
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25
    assert set(metric) <= {"name", "unit", "better", "bound", "source",
                           "workloads"}


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_moves_a_metric_each_of_its_cells_reports(metric):
    assert set(metric) <= {"name", "unit", "better", "source", "layer",
                           "moves", "workloads"}
    moved = next(m for m in BENCH["end_to_end"]
                 if m["name"] == metric["moves"])
    for cell in metric.get("workloads", moved.get("workloads", CELLS)):
        assert cell in moved.get("workloads", CELLS)
    if metric["unit"] == "%" and "roofline" in metric["name"]:
        assert metric["name"].split(".")[0].endswith("_roofline")


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_enough(cell):
    e2e = [m["name"] for m in manifest.metrics(BENCH, cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert manifest.metrics(BENCH, cell, True)
    c = manifest.cell(BENCH, cell)
    assert c.traffic["kind"] in ("serve", "train")
    assert c.spec["check"]["limits"]
    assert c.chips in (1, 4)


def test_every_config_has_a_cell_and_its_own_file():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("portbench/")
        cfg = json.loads((manifest.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert not WIDTH.search(key), key
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_four_chip_cells_are_few():
    fours = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert fours <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("cell", CELLS)
def test_per_layer_metrics_of_a_cell(cell):
    """A cell's per-layer metrics are those that list it, or that list no
    cell and move an end-to-end metric it reports."""
    reported = {m["name"] for m in manifest.metrics(BENCH, cell, False)}
    want = {m["name"] for m in BENCH["per_layer"]
            if cell in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in reported)}
    assert {m["name"] for m in manifest.metrics(BENCH, cell, True)} == want
    assert want

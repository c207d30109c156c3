"""Every file the benchmark names loads by its name, and BENCHMARK.json
keeps to the benchmark's contract."""

import importlib
import json
import re

import pytest

from benchmark import run

BENCH = json.loads(run.BENCHMARK_JSON.read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
SERVED = "sift1m.serve"     # not in BENCHMARK.json yet
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(run.BENCHMARK_JSON.read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    spec = run.load_spec(cell)
    assert spec["config"]["name"] == spec["entry"]["config"]
    importlib.import_module(
        f"benchmark.generators.{spec['traffic']['kind']}")
    assert set(spec["cell"]["limits"]) == {"dist_gap", "id_gap", "bad_ids"}
    assert spec["cell"]["check"]["sample_calls"] > 0
    names = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert spec["per_layer"]


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_reader_loads_by_name(metric):
    assert callable(run.reader(metric))


@pytest.mark.parametrize("cell", [SERVED])
def test_queued_cell_loads_by_name(spec_of, cell):
    """The served cell, not in BENCHMARK.json yet, loads from its files
    with the entry named explicitly, and its metrics have readers."""
    spec = spec_of(cell)
    assert spec["entry"]["name"] == cell and cell not in CELLS
    assert set(spec["cell"]) == {"check", "limits"}
    importlib.import_module(
        f"benchmark.generators.{spec['traffic']['kind']}")
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(run.reader(m["name"]))


def test_cell_files_are_benchmark_cells_or_the_served_one():
    cells = {p.stem for p in (run.HERE / "workloads").glob("*.json")}
    assert cells == set(CELLS) | {SERVED}
    with pytest.raises(SystemExit):
        run.load_spec(SERVED)


@pytest.mark.parametrize("config", BENCH["configs"],
                         ids=[c["name"] for c in BENCH["configs"]])
def test_config_file(config):
    cfg = json.loads((run.HERE.parent / config["file"]).read_text())
    assert cfg["name"] == config["name"]
    assert cfg["reduced"] == config["reduced"]
    assert "guarantee" in cfg and cfg["D"] == cfg["M"] * (cfg["D"] // cfg["M"])
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


def test_names_units_and_bounds():
    entries = BENCH["configs"] + BENCH["workloads"] + METRICS
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in METRICS:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        moved = e2e[m["moves"]].get("workloads", CELLS)
        assert set(m["workloads"]) <= set(moved)
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200

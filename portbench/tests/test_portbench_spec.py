"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""

import importlib

import pytest

from portbench import readers, spec

BENCH = spec.load_benchmark()
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_benchmark_meets_the_contract():
    assert spec.problems(BENCH) == []


def test_command_runs_the_harness_module():
    assert BENCH["command"] == ["python3", "-m", "portbench.run"]
    assert BENCH["paths"] == ["portbench"]


@pytest.mark.parametrize("name", [e["name"] for e in BENCH["configs"]]
                         + [e["name"] for e in BENCH["workloads"]]
                         + [m["name"] for m in METRICS])
def test_names_use_only_allowed_characters(name):
    assert spec.NAME_RE.fullmatch(name)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_units_and_readers(metric):
    assert spec.UNIT_RE.fullmatch(metric["unit"])
    assert callable(readers.load(metric["name"]))


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_are_found_by_name(cell):
    config = spec.load_config(BENCH, cell["config"])
    traffic = spec.load_traffic(cell["traffic"])
    assert traffic["loop"] in ("closed", "open")
    system = importlib.import_module(f"portbench.systems.{config['system']}")
    assert hasattr(system, "System")
    assert set(config["limits"])


def test_a_broken_entry_is_reported():
    bad = spec.load_benchmark()
    bad["end_to_end"][0]["unit"] = "tokens per second"
    bad["workloads"][0]["name"] = "a cell"
    found = spec.problems(bad)
    assert any("unit" in p for p in found)
    assert any("name" in p for p in found)

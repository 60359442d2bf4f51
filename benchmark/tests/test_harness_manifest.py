"""BENCHMARK.json against the benchmark's contract, and every cell against
the files it names."""

import json
import re
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(MANIFEST["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p and not p.startswith("/")
               for p in MANIFEST["paths"])
    assert 1 <= len(MANIFEST["command"]) <= 32
    assert all(line(w) for w in MANIFEST["command"])
    assert isinstance(MANIFEST["run_seconds"], int)
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert 1 <= len(MANIFEST["configs"]) <= 24
    assert 1 <= len(MANIFEST["workloads"]) <= 24
    assert 1 <= len(MANIFEST["end_to_end"]) <= 16
    assert 1 <= len(MANIFEST["per_layer"]) <= 128


def test_command_names_only_files_under_paths():
    for word in MANIFEST["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in MANIFEST["paths"])
            assert (ROOT / word).exists()


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_and_units_in_allowed_characters(kind):
    names = [e["name"] for e in MANIFEST[kind]]
    assert len(set(names)) == len(names)
    for e in MANIFEST[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
        for key in ("why", "layer", "source"):
            if key in e and kind in ("configs", "workloads", "per_layer"):
                assert line(e[key]), (e["name"], key)


def test_metric_names_unique_across_groups():
    names = [m["name"] for m in METRICS]
    assert len(set(names)) == len(names)


def test_entry_keys_exactly_as_the_contract_has_them():
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    for m in MANIFEST["end_to_end"]:
        # every cell reports setup_s, so it lists no cells (the contract
        # refuses a list on it); every other end-to-end metric lists its
        # cells, and a cell added later names itself there
        keys = {"name", "unit", "better", "bound", "source"}
        if m["name"] == "setup_s":
            assert set(m) == keys
            continue
        assert set(m) == keys | {"workloads"}
        assert m["workloads"] and set(m["workloads"]) <= set(CELLS)
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert all(m["better"] in ("lower", "higher") for m in METRICS)


def test_pairs_and_configs_used():
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(set(pairs)) == len(pairs)
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(set(files)) == len(files)
    four = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert four <= max(1, len(MANIFEST["workloads"]) // 4)


def reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    c, config, traffic, limits, entry = harness.cell_files(ROOT, MANIFEST, cell)
    for p in (config, traffic, limits, entry):
        assert p.exists(), p
    conf = json.loads(config.read_text())
    listed = {x["name"]: x for x in MANIFEST["configs"]}[c["config"]]
    assert conf["source"] == listed["source"]
    assert conf["reduced"] == listed["reduced"]
    assert str(config.relative_to(ROOT)).startswith("benchmark/")
    lim = json.loads(limits.read_text())
    assert lim["limits"] and all(v > 0 for v in lim["limits"].values())
    for m in METRICS:
        if reports(m, cell):
            assert harness.reader_path(m["name"]).exists()


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_setup_another_e2e_and_a_per_layer_metric(cell):
    e2e = [m["name"] for m in MANIFEST["end_to_end"] if reports(m, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(reports(m, cell) for m in MANIFEST["per_layer"])


@pytest.mark.parametrize("metric", [m["name"] for m in MANIFEST["per_layer"]])
def test_each_metric_cell_reports_what_it_moves(metric):
    m = {x["name"]: x for x in MANIFEST["per_layer"]}[metric]
    moved = {x["name"]: x for x in MANIFEST["end_to_end"]}[m["moves"]]
    cells = m.get("workloads", CELLS)
    assert cells and set(cells) <= set(CELLS)
    for cell in cells:
        assert reports(moved, cell), (metric, cell)


def test_metrics_of_one_layer_name_it_alike():
    layers = {m["layer"] for m in MANIFEST["per_layer"]}
    assert layers == {"host build", "scheduler", "residency", "autograd",
                      "wavefront glue", "kernels", "device"}


def test_files_under_paths_are_named_from_name_characters():
    for p in (ROOT / "benchmark").rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert all(NAME.match(part) for part in rel.split("/")), rel

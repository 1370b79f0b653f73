"""BENCHMARK.json keeps to its contract, and every cell's pieces are
found by name, each from a file of its own."""

import json
import re

import pytest

from lshbench import spec

BENCH = spec.load_benchmark()
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == TOP
    assert BENCH["command"] == ["python3", "lshbench/run.py"]
    assert BENCH["paths"] == ["lshbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_and_units_use_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [w["config"] for w in BENCH["workloads"]]
    names += [w["traffic"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    for n in names:
        assert spec.NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec.UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert TEXT.match(c["why"]) and TEXT.match(c["source"])
    for w in BENCH["workloads"]:
        assert TEXT.match(w["why"]) and w["chips"] in (1, 4)
    for m in BENCH["per_layer"]:
        assert TEXT.match(m["layer"])


def test_entries_have_exactly_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_pieces_by_name(cell):
    c = spec.find_cell(cell)
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert c.config == spec.load_config(w["config"])
    assert c.traffic == spec.load_traffic(w["traffic"])
    assert c.config["name"] == w["config"]
    assert callable(spec.driver(c.traffic["kind"]))
    m, _ = spec.load_module("drivers", c.traffic["kind"]).answer_form(
        c.config)
    assert m >= c.config["m"]
    world = spec.world(c.config["world"])
    for f in ("make_inputs", "build_system", "reference", "QueryRows",
              "DeviceRows"):
        assert callable(getattr(world, f)), f
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert callable(spec.metric_reader(m["name"]))
        assert m["moves"] in e2e


def test_every_config_is_used_and_its_file_lies_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"] == f"lshbench/configs/{c['name']}.json"
        assert spec.load_config(c["name"])["source"] == c["source"]
    # two deployments from one paper name it down to the part each is
    sources = [c["source"] for c in BENCH["configs"]]
    assert len(set(sources)) == len(sources)


def test_metric_workloads_name_cells_that_report_what_it_moves():
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        for w in m.get("workloads", cells):
            assert w in cells and spec.reports(moved, w)


def test_a_bad_name_is_refused():
    with pytest.raises(ValueError):
        spec.load_traffic("../BENCHMARK")

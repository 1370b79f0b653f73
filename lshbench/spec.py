"""Finding a cell's pieces by name: `BENCHMARK.json` at the root of the
checkout, and beside this file `configs/<config>.json`,
`traffic/<mix>.json`, the world a configuration names
(`worlds/<world>.py`), the driver of a mix's kind
(`drivers/<kind>.py`) and `metrics/<metric>.py`."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def check_name(what: str, name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"{what} {name!r} is not a valid name")
    return name


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config: dict          # configs/<config>.json
    traffic: dict         # traffic/<mix>.json
    chips: int
    end_to_end: list      # the BENCHMARK.json entries this cell reports
    per_layer: list


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _load_json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{check_name(kind, name)}.json"
    with open(path) as f:
        return json.load(f)


def load_config(name: str) -> dict:
    return _load_json("configs", name)


def load_traffic(name: str) -> dict:
    return _load_json("traffic", name)


def reports(metric: dict, cell: str) -> bool:
    """Does `cell` report `metric` (every cell where it names none)?"""
    return cell in metric.get("workloads", [cell])


def find_cell(name: str, bench: dict | None = None) -> Cell:
    bench = load_benchmark() if bench is None else bench
    for w in bench["workloads"]:
        if w["name"] == name:
            e2e = [m for m in bench["end_to_end"] if reports(m, name)]
            e2e_names = {m["name"] for m in e2e}
            layer = [m for m in bench["per_layer"] if reports(m, name)
                     and m["moves"] in e2e_names]
            return Cell(name, load_config(w["config"]),
                        load_traffic(w["traffic"]), int(w["chips"]), e2e,
                        layer)
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_module(kind: str, name: str):
    """The module `<kind>/<name>.py` beside this file, by name."""
    path = HERE / kind / f"{check_name(kind, name)}.py"
    key = f"lshbench_{kind}_" + name.replace(".", "_").replace("-", "_")
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = sys.modules[key] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """`read(ctx) -> float | None` of `metrics/<name>.py`."""
    return load_module("metrics", name).read


def driver(kind: str):
    """`drive(run) -> harness.Window` of `drivers/<kind>.py` (which also
    gives `answer_form(cfg)`)."""
    return load_module("drivers", kind).drive


def world(name: str):
    """The module `worlds/<name>.py`: `make_inputs(cfg, seed, device)`,
    `build_system(cfg, inputs, device)`, `reference(cfg, inputs)` and
    `QueryRows(inputs)`."""
    return load_module("worlds", name)

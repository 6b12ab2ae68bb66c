"""BENCHMARK.json against the contract's shape, and every file a cell needs
found by its name."""

import json
import re

import pytest

from h100bench import spec
from h100bench.tests.tiny import CELLS

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["h100bench"]
    assert BENCH["command"] == ["python3", "h100bench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    cells = len(BENCH["workloads"])
    # A full check of 24 cells: 2 + 14 a cell runs of run_seconds + 60 s,
    # 2 x 90 s of compilation a cell and 1200 s spare.
    full = ((2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 2 * 90
            + 1200)
    assert full <= 43200, full
    assert 1 <= cells <= 24


def test_names_units_and_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (spec.ROOT / c["file"]).is_file()
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        names += [w["name"], w["config"], w["traffic"]]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert all(NAME.match(n) for n in names), names
    assert len({m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
               ) == len(BENCH["end_to_end"]) + len(BENCH["per_layer"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name(name):
    cell = spec.load(name)
    e2e = [m for m, _, _ in cell.end_to_end]
    layers = {m: u for m, u, _ in cell.per_layer}
    assert "setup_s" in e2e and len(e2e) >= 2 and layers
    for m in BENCH["per_layer"]:
        if m["name"] in layers:
            assert m["moves"] in e2e
    assert cell.limits, "a cell compares at least one number"
    for _, _, reader in cell.end_to_end + cell.per_layer:
        assert callable(reader.read)
    for fn in ("warm_up", "window", "unit", "answer", "control_answer",
               "judge"):
        assert callable(getattr(cell.driver, fn))
    assert callable(cell.reference.solve)


def test_every_config_is_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        body = json.loads((spec.ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]

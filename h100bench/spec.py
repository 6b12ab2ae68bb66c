"""Everything of one cell, found by name from ``BENCHMARK.json``.

``BENCHMARK.json`` names the cell's configuration, traffic mix and metrics;
each lives in a file of its own under ``h100bench/``:

- ``configs/<config>.json``: the problem's sizes and what it states (the
  likelihood, probe recovery, the scan, the start), and ``reference``, the
  module of ``reference/`` that solves it plainly;
- ``traffic/<traffic>.json``: the mix's parameters, among them ``driver``,
  the module of ``drivers/`` that runs the mix;
- ``cells/<workload>.json``: the cell's configuration and mix again, the
  limits of its correctness numbers, under ``compare`` what the driver's
  judge needs to know of the comparison, and ``device_bytes``, the device
  memory the cell is reckoned to need;
- ``metrics/<metric>.py``: the reader of each metric.

A later cell, configuration, mix or metric is new files and new entries;
no file here needs an edit.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class SpecError(Exception):
    """The cell, or a file it names, is missing or does not agree."""


def _json(path: Path) -> dict:
    if not path.is_file():
        raise SpecError(f"{path} is missing")
    return json.loads(path.read_text())


def load_module(path: Path, name: str):
    if not path.is_file():
        raise SpecError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _package_module(package: str, name: str):
    if not (HERE / package / f"{name}.py").is_file():
        raise SpecError(f"{HERE / package / name}.py is missing")
    return importlib.import_module(f"h100bench.{package}.{name}")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict  # correctness number -> limit
    compare: dict  # how the driver's judge compares, where the cell says
    device_bytes: int | None  # the device memory reckoned, where it is
    end_to_end: list  # (name, unit, reader)
    per_layer: list  # (name, unit, reader)
    driver: object  # drivers/<mix['driver']>.py
    reference: object  # reference/<config['reference']>.py


def _metrics(entries, cell: str):
    out = []
    for m in entries:
        if cell in m.get("workloads", [cell]):
            reader = load_module(HERE / "metrics" / f"{m['name']}.py",
                                 f"h100bench.metrics.{m['name']}")
            out.append((m["name"], m["unit"], reader))
    return out


def load(cell: str) -> Cell:
    """The cell ``cell`` of ``BENCHMARK.json`` at the root of the checkout,
    its files under ``h100bench/``."""
    bench = _json(ROOT / "BENCHMARK.json")
    found = [w for w in bench["workloads"] if w["name"] == cell]
    if not found:
        raise SpecError(f"no workload {cell!r} in BENCHMARK.json")
    w = found[0]
    spec = _json(HERE / "cells" / f"{cell}.json")
    if (spec["config"], spec["traffic"]) != (w["config"], w["traffic"]):
        raise SpecError(f"cells/{cell}.json names {spec['config']} / "
                        f"{spec['traffic']}, BENCHMARK.json {w['config']} / "
                        f"{w['traffic']}")
    config = _json(HERE / "configs" / f"{w['config']}.json")
    mix = _json(HERE / "traffic" / f"{w['traffic']}.json")
    return Cell(
        name=cell, chips=w["chips"], config=config, mix=mix,
        limits=spec["limits"], compare=spec.get("compare", {}),
        device_bytes=spec.get("device_bytes", {}).get("bytes"),
        end_to_end=_metrics(bench["end_to_end"], cell),
        per_layer=_metrics(bench["per_layer"], cell),
        driver=_package_module("drivers", mix["driver"]),
        reference=_package_module("reference", config["reference"]))

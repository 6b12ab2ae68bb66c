"""The benchmark's cells at a size the CPU runs in a moment.

The geometry is cut to 48^2 / 144 positions / 16^2 frames / 12^2 probe,
and the pool to two problems; everything else is the cell's own. On the
CPU the program's fused tiers run their plain versions, so the mixes name
them where the card's defaults would resolve to them (the CPU's own
default would pick the oracle tier and another line search).
"""

from __future__ import annotations

import dataclasses
import json
import time

import torch

from h100bench import harness, spec

TINY = dict(nz=48, n=48, nscan=144, ndet=16, nprb=12)
SEED = 2**31 + 12345  # past 32 signed bits
POOL = [SEED, 7]
CPU_OPTIONS = {"jobs": {"kernel": "fused_mx"},
               "deep": {"fast_kernel": "fused", "base_kernel": "fused_hp"}}
CELLS = [w["name"] for w in json.loads(
    (spec.ROOT / "BENCHMARK.json").read_text())["workloads"]]


def cell(name: str):
    c = spec.load(name)
    mix = dict(c.mix, options=CPU_OPTIONS[c.mix["driver"]])
    return dataclasses.replace(c, config=dict(c.config, **TINY,
                                              pool_seeds=POOL), mix=mix)


def execute(name: str, seed: int = SEED, traced: bool = False,
            seconds: float = 0.3) -> dict:
    torch.manual_seed(0)
    return harness.execute(cell(name), seed, seconds, traced,
                           torch.device("cpu"), harness.load_program(),
                           time.perf_counter())

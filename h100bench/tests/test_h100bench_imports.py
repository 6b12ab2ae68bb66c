"""What a run loads, by whole top-level module names: neither JAX nor the
JAX package; the reference and the generator nothing of the program."""

import json
import os
import subprocess
import sys

import pytest

from h100bench import spec
from h100bench.harness import JAX_NAMES
from h100bench.tests.tiny import CELLS

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def loaded(body: str) -> set:
    out = subprocess.run([sys.executable, "-c",
                          PROBE.format(root=str(spec.ROOT), body=body)],
                         capture_output=True, text=True, timeout=300,
                         check=True, env=dict(os.environ, OMP_NUM_THREADS="1"))
    return set(json.loads(out.stdout.splitlines()[-1]))


@pytest.mark.parametrize("name", CELLS)
def test_harness_of_a_cell_loads_no_jax(name):
    names = loaded(
        "from h100bench import harness, spec\n"
        f"cell = spec.load({name!r})\n"
        "harness.load_program()\n"
        "from h100bench.tests import tiny\n"
        f"tiny.execute({name!r})\n")
    assert "tikejax_torch" in names
    assert not names & set(JAX_NAMES)


def test_reference_and_generator_load_nothing_of_the_program():
    names = loaded("import h100bench.reference.cg, h100bench.problem, "
                   "h100bench.calibrate")
    assert "torch" in names
    assert not names & (set(JAX_NAMES) | {"tikejax_torch"})

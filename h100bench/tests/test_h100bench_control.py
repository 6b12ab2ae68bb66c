"""The control -- the reference put in the program's place, in bfloat16,
one precision below the float32 the configurations state -- comes out not
correct under each cell's limits; the program's own answer on the same
inputs comes out correct.

On the CPU at a tiny size; on the card (``-m cuda``) at the cell's own
size on three problems of its pool, as the limits were set."""

import pytest
import torch

from h100bench import harness, spec
from h100bench.tests import tiny


def verdict(cell, numbers) -> bool:
    return all(numbers[k] <= v for k, v in cell.limits.items())


def answers(cell, seeds, device):
    run = harness.Run(cell, device, harness.load_program())
    out = []
    for seed in seeds:
        run.make_problems([seed])
        cell.driver.unit(run, 0)
        program = cell.driver.judge(run, 0, cell.driver.answer(run, 0))
        control = cell.driver.judge(run, 0,
                                    cell.driver.control_answer(run, 0))
        out.append((program, control))
    return out


@pytest.mark.parametrize("name", tiny.CELLS)
def test_control_fails_program_passes_tiny(name):
    cell = tiny.cell(name)
    for program, control in answers(cell, tiny.POOL, torch.device("cpu")):
        assert verdict(cell, program), program
        assert not verdict(cell, control), control


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", tiny.CELLS)
def test_control_fails_at_cell_size(name, card):
    cell = spec.load(name)
    for _, control in answers(cell, cell.config["pool_seeds"][:3], card):
        assert not verdict(cell, control), control

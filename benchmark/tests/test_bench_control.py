"""On the card, at each cell's own size: the control (the plain reference
computed with TF32 operands, put in the program's place) and each planted
fault come out not correct, and the program itself correct.

  python -m pytest -m cuda benchmark/tests/test_bench_control.py

Skips without a card. ``benchmark/calibrate.py`` reads the same on a dozen
seeds and more.
"""

import pytest
import torch

from benchmark import faults, harness

CELLS = ["mcwilliams256.gen_b32", "sfno_mcwilliams.train_b64"]
SEED = 2_700_000_000


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run at their own sizes")


def _failed(drv, cell) -> list:
    return [name for name, value, limit in harness.checks(drv, cell) if not value <= limit]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_program_passes_and_control_fails(workload):
    _card()
    _, _, cell, config = harness.load_cell(workload)
    drv = harness.make_driver(cell, config, SEED, "cuda")
    for _ in range(2):
        drv.unit()
    drv.release()
    assert not _failed(drv, cell)
    drv.use_control()
    assert _failed(drv, cell)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_each_fault_fails_at_the_cells_size(workload):
    _card()
    _, _, cell, config = harness.load_cell(workload)
    for name, plant in faults.FAULTS[cell["driver"]].items():
        with plant():
            drv = harness.make_driver(cell, config, SEED + 1, "cuda")
            drv.unit()
            drv.release()
        assert _failed(drv, cell), name

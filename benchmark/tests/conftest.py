"""The benchmark's tests: the repository root on the path, and the small
sizes the CPU runs each cell at."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

BENCH = ROOT / "benchmark"


def _load(kind, name):
    with open(BENCH / kind / f"{name}.json") as f:
        return json.load(f)


# each cell at a size the CPU runs in a second, its widths cut (the kernels'
# plain versions run there), with limits between what the program reads at
# that size (records 3e-6; loss 8e-8, gradient 6e-6, change by the worst
# leaf 1.2e-6) and what the faults read (records 2e-2; loss 4e-4, gradient
# 2e-3, change 2e-4); the cells' own limits hold at their own sizes on the
# card (test_bench_control.py)
SMALL = {
    "mcwilliams256.gen_b32": (dict(batch=2, limits={"records_rel_l2": 1e-4}),
                              dict(grid_size=32, warmup_steps=10, recorded_steps=20,
                                   record_every=5)),
    "sfno_mcwilliams.train_b64": (dict(batch=4, slice_steps=2,
                                       limits={"loss_gap": 1e-5, "grad_gap": 5e-4,
                                               "change_gap": 1e-5}),
                                 dict(grid_size=16, width=4, modes=8, modes_t=3,
                                      num_samples=16, num_val_samples=8, frames=30)),
}


@pytest.fixture
def small():
    """``small(workload) -> (cell, config)`` at the CPU's size."""
    def make(workload):
        cell = _load("cells", workload)
        config = _load("configs", cell["config"])
        cell_over, config_over = SMALL[workload]
        return dict(cell, **cell_over), dict(config, **config_over)
    return make

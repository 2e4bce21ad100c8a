"""The readings a cell's limits are set from, in one process on the card.

  python3 benchmark/calibrate.py --workload <cell> --seeds 12 --control-seeds 3 \\
      [--units 1] [--fault-seeds 3] [--dealias-seeds 0] [--out chiprun_out/calib.jsonl]

For each seed: the cell's own set-up and ``--units`` units of its window,
then its check (the program's readings); for each control seed the same,
with the plain reference computed with TF32 operands put in the program's
place; and for each fault of ``faults.py`` and fault seed, the program with
that fault planted. With ``--dealias-seeds`` (generation cells), also the
gap between the reference's two dealiasing semantics, ``galerkin`` and
``nonlinear``, on one batch a seed at the cell's size. Prints one JSON line
a reading. The benchmark's runs do not run this.
"""

import argparse
import contextlib
import itertools
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if sys.path[0] == str(Path(__file__).resolve().parent):
    sys.path[0] = str(ROOT)


def readings(drv, units: int, control: bool) -> dict:
    for _ in range(units):
        drv.unit()
    drv.release()
    if control:
        drv.use_control()
    return drv.compare()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--fault-seeds", type=int, default=3)
    p.add_argument("--units", type=int, default=1)
    p.add_argument("--dealias-seeds", type=int, default=0)
    p.add_argument("--first-seed", type=int, default=2_500_000_000)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    from benchmark import harness

    _, _, cell, config = harness.load_cell(args.workload)
    with open(args.out, "a") if args.out else contextlib.nullcontext() as out:
        rows = calibrate(cell, config, args.seeds, args.control_seeds, args.fault_seeds,
                         args.units, args.first_seed, args.device)
        gaps = (dealias_gap(cell, config, args.first_seed + 3000 + i, args.device)
                for i in range(args.dealias_seeds))
        for row in itertools.chain(rows, gaps):
            line = json.dumps(dict(row, workload=args.workload))
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    return 0


def calibrate(cell, config, seeds, control_seeds, fault_seeds, units, first_seed, device):
    """Yields one reading a run: ``{"kind", "fault", "seed", "readings",
    "seconds"}``, kind ``program``, ``control`` or ``fault``."""
    from benchmark import faults, harness

    plan = ([("program", None, first_seed + i) for i in range(seeds)]
            + [("control", None, first_seed + 1000 + i) for i in range(control_seeds)]
            + [("fault", name, first_seed + 2000 + i)
               for name in faults.FAULTS[cell["driver"]] for i in range(fault_seeds)])
    for kind, fault, seed in plan:
        t0 = time.perf_counter()
        with faults.FAULTS[cell["driver"]][fault]() if fault else contextlib.nullcontext():
            drv = harness.make_driver(cell, config, seed, device)
            row = readings(drv, units, kind == "control")
        yield {"kind": kind, "fault": fault, "seed": seed, "readings": row,
               "seconds": time.perf_counter() - t0}


def dealias_gap(cell, config, seed, device):
    """The largest relative L2 distance, over a batch's samples, between the
    reference's records with the state on the 2/3 block (``galerkin``) and
    with every mode kept and only the nonlinear term filtered
    (``nonlinear``)."""
    import torch

    from benchmark import inputs
    from benchmark.reference import mcwilliams as ref

    t0 = time.perf_counter()
    n = config["grid_size"]
    noise = inputs.batch_noise(seed, 0, (cell["batch"], n, n), torch.float32, device)
    a, b = (ref.records(noise, dict(config, dealias=d)).double()
            for d in ("galerkin", "nonlinear"))
    rel = (a - b).flatten(1).norm(dim=1) / b.flatten(1).norm(dim=1)
    return {"kind": "dealias", "fault": None, "seed": seed,
            "readings": {"records_rel_l2": float(rel.max())},
            "seconds": time.perf_counter() - t0}


if __name__ == "__main__":
    sys.exit(main())

"""Runs one cell once: set-up, the measured window, the check, the result.

Everything that belongs to one cell, configuration, driver or metric is a
file found by name: ``cells/<workload>.json`` (its configuration, driver,
batch, precision, window unit and limits), ``configs/<config>.json``,
``drivers/<driver>.py`` (a ``Driver`` class), ``work/<config>.py`` (or the
module the configuration names under ``work``) and ``metrics/<metric>.py``. ``BENCHMARK.json`` at the root names the cells and
metrics; this file names none of them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import torch

from benchmark import trace as tracing

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "tpu_cfd")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module, or, for a metric whose
    file is not there, ``<kind>/<stem>.py`` (the name up to its first dot)."""
    path = HERE / kind / f"{name}.py"
    if not path.exists() and kind == "metrics":
        path = HERE / kind / f"{name.split('.')[0]}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(f"benchmark.{kind}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_metrics(bench: dict, workload: str, section: str) -> list:
    """The entries of ``section`` that this workload reports: those that list
    it under ``workloads``, and the end-to-end ones without the key
    (``setup_s``), which every cell reports."""
    default = [workload] if section == "end_to_end" else []
    return [m for m in bench[section] if workload in m.get("workloads", default)]


@dataclasses.dataclass
class Record:
    """What a per-layer reader reads (``metrics/<name>.py``)."""
    cell: dict
    config: dict
    work: object
    counters: dict
    ranges: tracing.Ranges
    trace: Optional[tracing.Trace]
    window_s: float
    peak_flops: float
    peak_bytes: float


def checks(drv, cell: dict) -> list:
    """``(name, value, limit)`` of each number the cell holds to a limit."""
    found = drv.compare()
    return [(name, found[name], limit) for name, limit in cell["limits"].items()]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def load_cell(workload: str, bench: dict = None, cell: dict = None, config: dict = None):
    """``(bench, entry, cell, config)`` of ``workload``; ``cell`` and
    ``config`` replace the files of those names (the tests' small sizes)."""
    bench = load_json(ROOT / "BENCHMARK.json") if bench is None else bench
    entry = next(w for w in bench["workloads"] if w["name"] == workload)
    cell = load_json(HERE / "cells" / f"{workload}.json") if cell is None else cell
    config = load_json(HERE / "configs" / f"{entry['config']}.json") if config is None else config
    return bench, entry, cell, config


def make_driver(cell: dict, config: dict, seed: int, device, ranges=None):
    """The cell's driver, set up: its program built, its inputs made, every
    shape of the window warmed up."""
    ranges = tracing.Ranges(False) if ranges is None else ranges
    return load_module("drivers", cell["driver"]).Driver(cell, config, seed, device, ranges)


def run(workload: str, seed: int, seconds: float, trace: bool, t_start: float,
        device="cuda", bench: dict = None, cell: dict = None, config: dict = None,
        log=sys.stderr) -> dict:
    """One run of ``workload``; returns the result line's object."""
    bench, entry, cell, config = load_cell(workload, bench, cell, config)
    peaks = load_json(HERE / "peaks.json")
    ranges = tracing.Ranges(trace)

    drv = make_driver(cell, config, seed, device, ranges)
    _sync(device)
    setup_s = time.perf_counter() - t_start
    ranges.reset()
    cuda = torch.device(device).type == "cuda"
    session = tracing.Session(cuda) if trace else None
    units = []
    with session if session is not None else contextlib.nullcontext():
        t0 = time.perf_counter()
        while True:
            u0 = time.perf_counter()
            drv.unit()
            units.append(time.perf_counter() - u0)
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    e2e = drv.end_to_end(window_s, peak)
    counters = dict(drv.counters)
    route = getattr(drv, "route", None)

    drv.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    c0 = time.perf_counter()
    compared = checks(drv, cell)
    check_s = time.perf_counter() - c0
    found = forbidden_modules()
    if found:
        raise SystemExit(f"benchmark: modules of the JAX stack are loaded: {found}")

    units_sorted = sorted(units)
    print(f"benchmark: {workload} seed {seed} route {route} setup_s {setup_s:.4f} "
          f"window_s {window_s:.4f} units {len(units)} unit_s first {units[0]:.4f} "
          f"median {units_sorted[len(units) // 2]:.4f} max {units_sorted[-1]:.4f} "
          f"check_s {check_s:.4f} counters {json.dumps(counters)} "
          f"setup {json.dumps(getattr(drv, 'setup_phases', {}))}", file=log)

    result = {"correct": bool(compared) and counters["failed"] == 0
              and counters["attempted"] > 0 and all(v <= lim for _, v, lim in compared),
              "attempted": counters["attempted"], "failed": counters["failed"]}
    metrics = {}
    if not trace:
        values = dict(e2e, setup_s=setup_s)
        for m in cell_metrics(bench, workload, "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": entry["chips"], "memory_peak_bytes": peak,
                   "power_limit_w": power_limit_w() if cuda else None}
    if trace:
        tr = session.read()
        work = load_module("work", config.get("work", entry["config"]))
        rec = Record(cell, config, work, counters, ranges, tr, window_s,
                     peaks["flops_per_s"][cell["precision"]], peaks["bytes_per_s"])
        for m in cell_metrics(bench, workload, "per_layer"):
            value = load_module("metrics", m["name"]).read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info["busy_s"] = tr.busy_s()
        device_info["window_s"] = window_s
        result["breakdown"] = tr.breakdown()
        print(f"benchmark: trace: {len(tr.op_start)} device operations ({tr.kernels} "
              f"kernels), {tr.matched} matched to a launch, {tr.launches} kernel launches "
              f"by the host; ranges {dict(ranges.calls)}", file=log)
    result["metrics"] = metrics
    result["device"] = device_info
    for name, value, limit in compared:
        print(f"check {name}: {value!r} limit {limit!r}", file=log)
    result["checks"] = {name: {"value": value if math.isfinite(value) else str(value),
                               "limit": limit} for name, value, limit in compared}
    return result

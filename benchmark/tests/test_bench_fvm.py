"""The Kolmogorov FVM cell, ``kolmogorov_fvm128.rollout_b512``, on the CPU at
a small size: added as files alone, its driver's units and counters,
correct, failed by each of its faults and by its control, its work counted
as worked by hand, and its reference free of the port and of JAX.

The faults are planted here, around ``harness.make_driver``:
``faults.FAULTS`` is keyed by the ``generate`` and ``train`` drivers' names,
and a fault of the FVM path patches other objects. ``FAULTS`` below is the
set the cell's limits were calibrated against on the card.
"""

import contextlib
import json
import math
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness
from benchmark.faults import patched

from conftest import BENCH
from test_bench_harness import _copy_checkout, _run_in

WORKLOAD = "kolmogorov_fvm128.rollout_b512"
# 16², 4 samples, 2 frames 3 steps apart, checked in blocks of 3: the
# program reads 1e-16 to 1e-15 (frames) and 1e-15 (divergence), the fp32
# control 1e-7 and more, the faults 1e-3 and more
# (tests/test_torch_fvm_reference.py holds each term)
SMALL_CELL = dict(batch=4, check_block=3,
                  limits={"frames_rel_l2": 1e-11, "max_divergence": 1e-11})
SMALL_CONFIG = dict(grid_size=16, inner_steps=3, frames=2)


@contextlib.contextmanager
def _rollout_edited(edit):
    """``fvm.rollout`` with ``edit(v, equation, dt, inner_steps, frames,
    rollout)`` in its place."""
    from tpu_cfd_torch.solvers import fvm

    inner = fvm.rollout
    with patched(fvm, "rollout", lambda *args: edit(*args, inner)):
        yield


def fault_no_projection():
    """The step's projections are skipped: the state stays as its stage
    left it."""
    from tpu_cfd_torch.solvers.fvm import NavierStokes2DFVMProjection

    return patched(NavierStokes2DFVMProjection, "pressure_projection", lambda self, v: v)


def fault_upwind():
    """First-order upwind advection in place of Van Leer's."""
    from tpu_cfd_torch.solvers import fvm

    return patched(fvm, "advect_van_leer_using_limiters",
                   lambda c, v, dt: fvm.advect_upwind(c, v, dt))


def fault_altered():
    """One sample's frames come out shifted by one grid cell."""
    def edit(v, equation, dt, inner_steps, frames, rollout):
        out, final = rollout(v, equation, dt, inner_steps, frames)
        out[:, 0] = torch.roll(out[:, 0], 1, dims=-1)
        return out, final
    return _rollout_edited(edit)


def fault_half_batch():
    """Only the first half of the batch is stepped; the rest keeps its
    initial velocity, and its frames are that velocity's vorticity."""
    from tpu_cfd_torch import grids
    from tpu_cfd_torch.ops import finite_differences as fdm

    def part(v, lo, hi):
        return grids.GridVariableVector(tuple(
            grids.GridVariable(grids.GridArray(u.data[lo:hi], u.offset, u.grid), u.bc)
            for u in v))

    def edit(v, equation, dt, inner_steps, frames, rollout):
        b = v[0].data.shape[0]
        half = max(1, b // 2)
        out, final = rollout(part(v, 0, half), equation, dt, inner_steps, frames)
        rest = part(v, half, b)
        still = fdm.curl_2d(rest).data.expand(frames, *rest[0].data.shape)
        out = torch.cat([out, still], dim=1)
        final = grids.GridVariableVector(tuple(
            grids.GridVariable(grids.GridArray(torch.cat([f.data, r.data]), f.offset, f.grid),
                               f.bc)
            for f, r in zip(final, rest)))
        return out, final
    return _rollout_edited(edit)


FAULTS = {"no_projection": fault_no_projection, "upwind": fault_upwind,
          "altered": fault_altered, "half_batch": fault_half_batch}


@pytest.fixture
def small():
    _, _, cell, config = harness.load_cell(WORKLOAD)
    return dict(cell, **SMALL_CELL), dict(config, **SMALL_CONFIG)


def test_the_cell_is_added_as_files_alone(tmp_path):
    """A copy of the checkout runs the cell, traced, from its cell,
    configuration, driver, work and reference files and its entries in
    BENCHMARK.json, and loads no module of the JAX stack."""
    _copy_checkout(tmp_path)
    code = (
        "import json, sys, time; from benchmark import harness\n"
        f"_, _, cell, config = harness.load_cell({WORKLOAD!r})\n"
        f"cell = dict(cell, **{SMALL_CELL!r})\n"
        f"config = dict(config, **{SMALL_CONFIG!r})\n"
        f"r = harness.run({WORKLOAD!r}, 2 ** 31 + 7, 0.5, True, time.perf_counter(),"
        " device='cpu', cell=cell, config=config)\n"
        "print(harness.forbidden_modules())\n"
        "print(json.dumps(r))\n")
    out = _run_in(tmp_path, code)
    assert out.returncode == 0, out.stderr[-3000:]
    found, line = out.stdout.strip().splitlines()[-2:]
    assert found == "[]"
    result = json.loads(line)
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"frames_rel_l2", "max_divergence"}
    # the CPU has no device trace: the host-clock metric alone
    assert set(result["metrics"]) == {"step_mfu.fvm"}
    assert f"benchmark: {WORKLOAD} seed {2 ** 31 + 7} " in out.stderr
    assert "'bench.explicit'" in out.stderr and "'bench.solver'" in out.stderr


def test_the_cell_reports_its_metrics():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    e2e = {m["name"] for m in harness.cell_metrics(bench, WORKLOAD, "end_to_end")}
    layers = {m["name"] for m in harness.cell_metrics(bench, WORKLOAD, "per_layer")}
    assert e2e == {"sample_steps_per_s", "setup_s"}
    assert layers == {f"{m}.fvm" for m in ("device_idle", "pipeline_share", "explicit_share",
                                           "rollout_roofline", "step_mfu")}
    for w in ("mcwilliams256.gen_b32", "sfno_mcwilliams.train_b64", "fno_forced256.gen_b256"):
        assert not layers & {m["name"] for m in harness.cell_metrics(bench, w, "per_layer")}


def test_the_drivers_units_and_counters(small):
    """Each unit is one batch: its frames copied to the host, 4 samples × 3
    steps × 2 frames counted; traced, each step is one ``bench.solver`` call
    carrying the batch, with four explicit evaluations. The checked batch
    keeps its frames and final velocity, the others share a buffer, and
    where the window ends before the checked batch the last one is
    checked."""
    from benchmark import trace as tracing

    cell, config = small
    ranges = tracing.Ranges(True)
    drv = harness.make_driver(cell, config, 11, "cpu", ranges)
    assert drv.checked in range(3)
    drv.checked = 1
    ranges.reset()
    for _ in range(3):
        drv.unit()
    assert drv.counters == {"units": 3, "attempted": 3, "failed": 0, "sample_steps": 72}
    assert ranges.calls == {"bench.solver": 18, "bench.explicit": 72}
    assert ranges.counts == {"bench.solver": 72}
    assert set(drv.done) == {1, 2} and drv._checked() == 1
    frames, vel = drv.done[1]
    assert frames is drv.kept and drv.done[2][0] is drv.shared
    assert frames.shape == (2, 4, 16, 16) and frames.device.type == "cpu"
    assert frames.dtype == torch.float64 and len(vel) == 2 and vel[0].shape == (4, 16, 16)
    # each batch from its own noise
    assert not torch.equal(drv.shared, frames)
    assert drv.end_to_end(2.0, 0) == {"sample_steps_per_s": 36.0}
    drv.checked = 5
    assert drv._checked() == 2


@pytest.mark.parametrize("trace", [False, True])
def test_a_small_run_is_correct(small, trace):
    cell, config = small
    result = harness.run(WORKLOAD, 2 ** 33 + 1, 0.3, trace, time.perf_counter(),
                         device="cpu", cell=cell, config=config)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    if not trace:
        assert set(result["metrics"]) == {"sample_steps_per_s", "setup_s"}


def test_compare_reads_within_the_limits(small):
    cell, config = small
    drv = harness.make_driver(cell, config, 2 ** 40 + 5, "cpu")
    drv.unit()
    drv.release()
    found = drv.compare()
    assert 0 < found["frames_rel_l2"] < 1e-13 and found["max_divergence"] < 1e-13


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_each_fault_makes_the_run_incorrect(small, fault):
    cell, config = small
    with FAULTS[fault]():
        result = harness.run(WORKLOAD, 2 ** 32 + 3, 0.2, False, time.perf_counter(),
                             device="cpu", cell=cell, config=config)
    assert not result["correct"], result["checks"]


def test_the_control_fails_the_check(small):
    cell, config = small
    drv = harness.make_driver(cell, config, 41, "cpu")
    drv.unit()
    drv.release()
    assert all(v <= cell["limits"][k] for k, v in drv.compare().items())
    drv.use_control()
    found = drv.compare()
    assert all(v > cell["limits"][k] for k, v in found.items()), found


def test_a_config_that_is_not_the_examples_is_refused(small):
    cell, config = small
    with pytest.raises(ValueError, match="drag"):
        harness.make_driver(cell, dict(config, drag=0.2), 1, "cpu")


def test_work_counts_by_hand():
    """At 8²: 64 points; a real transform 2.5 · 64 · 6 = 960 operations; a
    projection 11 · 64 + 2 · 8 · 5 + 2 · 960 = 2,704; an explicit
    evaluation 105 · 64 = 6,720; a step 4 · (6,720 + 2,704) + 28 · 64 =
    39,488. Bytes: 62 fields of 64 values of 8 B, 31,744 a sample-step."""
    work = harness.load_module("work", "kolmogorov_fvm128")
    assert work.sample_step_flops({"grid_size": 8}) == 39_488
    assert work.sample_step_bytes({"grid_size": 8}, "float64") == 31_744
    assert work.sample_step_bytes({"grid_size": 128}, "float64") == 62 * 128 * 128 * 8
    rec = SimpleNamespace(
        config={"grid_size": 8}, cell={"batch": 4, "precision": "float64"},
        counters={"sample_steps": 10}, peak_flops=1e9, peak_bytes=1e6,
        ranges=SimpleNamespace(calls={"bench.solver": 3}, counts={"bench.solver": 12}))
    assert work.window_flops(rec) == 394_880
    # operations 12 · 39,488 / 1e9 s; bytes 12 · 31,744 / 1e6 B/s: the bytes bind
    assert work.rollout_bound_s(rec) == pytest.approx(12 * 31_744 / 1e6)
    rec.peak_bytes = 1e12
    assert work.rollout_bound_s(rec) == pytest.approx(12 * 39_488 / 1e9)
    rec.ranges.calls = {}
    assert work.rollout_bound_s(rec) is None


def test_the_reference_imports_nothing_of_the_port():
    text = (BENCH / "reference" / "kolmogorov_fvm.py").read_text()
    assert "tpu_cfd" not in text and "jax" not in text
    imported = [line.split()[1] for line in text.splitlines()
                if line.startswith(("import ", "from "))]
    assert not {m.split(".")[0] for m in imported} & set(harness.FORBIDDEN)


def test_the_configuration_states_the_examples_step():
    """The reference's step at 128² is the example's dt, 0.0081812."""
    from benchmark.reference import kolmogorov_fvm as ref

    config = json.loads((BENCH / "configs" / "kolmogorov_fvm128.json").read_text())
    assert math.isclose(ref.time_step(config), 0.008181230868723419, rel_tol=1e-15)

"""The port's FNO dataset path against the benchmark's plain reference
(``benchmark/reference/fno_forced.py``), on the CPU at 32².

The port's batch is made as the benchmark's ``generate_fno`` driver makes it
(``fno_objects``, which ``main_fno`` runs: the GRF initial condition, the SinCos forcing, IMEX
order 2; ``make_batch_pipeline`` with the four fields). The reference is
held to its own equations too: its IMEX step converges at second order in
dt, and its initial condition is ``GRF2d.sample``'s from the same draws.
Neither side imports JAX.
"""

import functools
import glob
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402
from benchmark.reference import fno_forced as ref  # noqa: E402
from tpu_cfd_torch.data.grf import GRF2d  # noqa: E402
from tpu_cfd_torch.solvers import initial_conditions as ic  # noqa: E402
from tpu_cfd_torch.utils import profile_to  # noqa: E402

SEED = 2 ** 33 + 19
DTYPES = {"float32": torch.float32, "float64": torch.float64}
FIELDS = ("vorticity", "stream", "vort_t", "residual")

# the records' relative L2 distance from the reference, the residual's
# relative to the time derivative's norm (as the benchmark's check takes
# it). The port and the reference run the same arithmetic in another order:
# fp32 reads 1.2e-7 (vorticity) to 2.6e-6 (the time derivative, a
# difference of two states 5 steps apart over their 5e-3 of time, which
# keeps the states' rounding and loses digits of their size), fp64 2.3e-16
# to 3.2e-15. The TF32 control reads 1.8e-4 to 3.8e-4 in fp32, the fp32
# reference 1.7e-6 to 1.7e-4 in fp64: each tolerance sits 5x or more above
# the port's reading and 9x or more below its control's.
TOL = {
    "float32": {"vorticity": 2e-6, "stream": 2e-6, "vort_t": 2e-5, "residual": 2e-5},
    "float64": {"vorticity": 1e-13, "stream": 1e-13, "vort_t": 1e-12, "residual": 1e-12},
}


def _small(precision):
    _, _, cell, config = harness.load_cell("fno_forced256.gen_b256")
    cell = dict(cell, batch=3, precision=precision, check_block=2)
    config = dict(config, grid_size=32, subsample=2, warmup_steps=20, recorded_steps=15,
                  record_every=5)
    return cell, config


@functools.lru_cache(maxsize=None)
def _readings(precision):
    """``(program, control)``: each field's largest distance over the batch,
    the port's records and the control's against the reference."""
    torch.set_num_threads(2)
    cell, config = _small(precision)
    drv = harness.make_driver(cell, config, SEED, "cpu")
    drv.unit()
    drv.release()
    program = drv.compare()
    drv.use_control()
    return program, drv.compare()


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("precision", ["float32", "float64"])
def test_port_batch_matches_reference(precision, field):
    program, control = _readings(precision)
    tol = TOL[precision][field]
    assert program[f"{field}_rel_l2"] <= tol, program
    assert control[f"{field}_rel_l2"] > tol, control


def _ref_run(w0, force, dt, t_end):
    solver = ref.Solver(32, 1.0, 1e-3, dt, force)
    w = torch.fft.rfft2(w0)
    for _ in range(round(t_end / dt)):
        w = solver.step(w)
    return torch.fft.irfft2(w, s=(32, 32))


def test_reference_imex2_converges_at_second_order():
    """Runs to t = 1 at dt, dt/2 and dt/4 (fp64): the errors of the first
    two against the third stand at (1 - 1/16) / (1/4 - 1/16) = 5 for a
    second-order scheme (3 for first order, 9 for third)."""
    noise = ref.white_noise(5, range(3), 32, torch.float64, "cpu")
    w0 = ref.initial_vorticity(noise, 2.5, 7.0)
    force = ref.forcing(32, 1.0, 0.1, 1, torch.float64, "cpu")
    a, b, c = (_ref_run(w0, force, dt, 1.0) for dt in (0.05, 0.025, 0.0125))
    e1, e2 = (a - c).norm() / c.norm(), (b - c).norm() / c.norm()
    assert 1e-7 < e2 < e1 < 1e-3
    assert 4.8 < float(e1 / e2) < 5.2


@pytest.mark.parametrize("precision,tol", [("float32", 1e-6), ("float64", 1e-14)])
def test_reference_ic_is_the_ports_grf(precision, tol):
    """The reference's GRF from the draws of each sample's generator equals
    the port's ``GRF2d.sample`` with that generator (``main_fno``'s IC)."""
    dtype, ids = DTYPES[precision], [0, 7, 2 ** 40 + 3]
    grf = GRF2d(n=32, alpha=2.5, tau=7.0, dtype=dtype)
    port = torch.cat([grf.sample(ic.sample_generator(SEED, i, "cpu"), bsz=1, n=32)
                      for i in ids])
    want = ref.initial_vorticity(ref.white_noise(SEED, ids, 32, dtype, "cpu"), 2.5, 7.0)
    rel = (port - want).flatten(1).norm(dim=1) / want.flatten(1).norm(dim=1)
    assert float(rel.max()) < tol


@pytest.mark.parametrize("precision", ["float32", "float64"])
def test_grf_builds_its_spectrum_once(precision, monkeypatch):
    """``GRF2d.sample`` builds ``sqrt_eig`` once a (parameters, n, device)
    and samples the same bits as a sampler that builds it anew; a changed
    parameter builds it again."""
    dtype = DTYPES[precision]
    built = []
    fresh = GRF2d.sqrt_eig

    def counted(self, n=None, device=None):
        built.append((self.tau, n))
        return fresh(self, n, device)

    def draws(grf, ids, n=32):
        return torch.cat([grf.sample(ic.sample_generator(SEED, i, "cpu"), bsz=1, n=n)
                          for i in ids])

    want = {tau: draws(GRF2d(n=32, alpha=2.5, tau=tau, dtype=dtype), [3])
            for tau in (7.0, 5.0)}
    monkeypatch.setattr(GRF2d, "sqrt_eig", counted)
    grf = GRF2d(n=32, alpha=2.5, tau=7.0, dtype=dtype)
    got = draws(grf, [3, 3, 3])
    assert built == [(7.0, 32)]
    for k in range(3):
        assert torch.equal(got[k], want[7.0][0])
    grf.tau = 5.0
    assert torch.equal(draws(grf, [3])[0], want[5.0][0])
    draws(grf, [3], n=16)
    assert built == [(7.0, 32), (5.0, 32), (5.0, 16)]


def test_fno_objects_are_the_clis():
    """``fno_objects`` gives ``main_fno``'s IC, forcing and stepper at the
    CLI's arguments: the IC a GRF a sample from each sample's generator."""
    from tpu_cfd_torch.data import generate
    from tpu_cfd_torch.solvers import forcings
    from tpu_cfd_torch.solvers.equations import IMEXStepper

    args = generate.get_parser("fno").parse_args(
        ["--grid-size", "32", "--seed", str(SEED), "--alpha", "2.5", "--tau", "7"])
    make_ic, forcing, solver = generate.fno_objects(args)
    assert isinstance(solver, IMEXStepper) and solver.order == 2
    assert isinstance(forcing, forcings.SinCosForcing)
    grf = GRF2d(n=32, alpha=2.5, tau=7.0)
    ids = [0, 5]
    want = torch.cat([grf.sample(ic.sample_generator(SEED, i, "cpu"), bsz=1)
                      for i in ids])
    assert torch.equal(make_ic(np.array(ids), None, torch.float32, "cpu"), want)


def test_records_bitwise_equal_with_spans_open_and_shut(tmp_path):
    """The port's records of a batch are the same bits under a profiler,
    where ``solver.explicit``, ``solver.implicit`` and ``gen.extra_vars``
    open, as without one."""
    torch.set_num_threads(2)
    cell, config = _small("float32")

    def batch():
        drv = harness.make_driver(cell, config, SEED, "cpu")
        drv.unit()
        return drv.done[0]

    plain = batch()
    with profile_to(str(tmp_path)) as d:
        traced = batch()
    (path,) = glob.glob(f"{d}/*.json")
    with open(path) as f:
        names = [e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"]
    # the warm-up's 4 solver calls and the batch's 4, one record chunk each
    assert names.count("solver.explicit") == names.count("solver.implicit") > 0
    assert names.count("gen.extra_vars") == 2
    assert set(plain) == set(FIELDS)
    for k in FIELDS:
        np.testing.assert_array_equal(traced[k], plain[k])

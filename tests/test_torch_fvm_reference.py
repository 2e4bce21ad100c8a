"""The port's Kolmogorov FVM path against the benchmark's plain reference
(``benchmark/reference/kolmogorov_fvm.py``), on the CPU in fp64.

The port runs as the benchmark's ``fvm_rollout`` driver and the example run
it: ``ex1_kolmogorov_fvm.build`` and ``initial_velocity`` on a seeded batch
of noise, ``fvm.rollout``. Compared, at 16² and 32² with b = 3: the initial
velocity, each term alone (``convect``, ``diffuse_velocity``,
``pressure_projection``), one step, and the rollout's frames over 2 × 10
steps. A batch is an ensemble: each sample equals its run alone. The spans
of ``fvm.py`` leave every result bitwise equal under a profiler. Neither
side imports JAX.

Each tolerance is a relative L2 distance, the worst sample's. The port and
the reference run the same equations in another order of operations: fp64
reads 0 (the convection, the same arithmetic) to 7.8e-16 (the frames after
20 steps) at these sizes. The reference in fp32 reads 1.7e-7 and more
against the fp64 port (``test_the_fp32_reference_fails_each_tolerance``):
every tolerance sits over 100x above the port's reading and over 1,000x
below fp32's.
"""

import glob
import json
import math
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.reference import kolmogorov_fvm as ref  # noqa: E402
from tpu_cfd_torch.examples import ex1_kolmogorov_fvm as example  # noqa: E402
from tpu_cfd_torch.solvers import fvm  # noqa: E402
from tpu_cfd_torch.utils import profile_to  # noqa: E402

torch.set_num_threads(2)

SEED = 2 ** 33 + 23
BATCH = 3
SIZES = [16, 32]
INNER_STEPS, FRAMES = 10, 2
# the initial velocity, a term, one step: the port reads 0 to 5e-16, the
# fp32 reference 1.7e-7 and more
TOL = 1e-13
# the frames after 20 steps and the final velocity: 5.2e-16 to 7.8e-16,
# the fp32 reference 2.2e-7 and more
ROLLOUT_TOL = 1e-13
# |div| of the final velocity in 1/time: the port reads 9.2e-16 at 16²,
# 2.8e-15 at 32²; the fp32 reference 4.6e-7 and 1.5e-6
DIV_TOL = 1e-12


def _config(n: int) -> dict:
    with open(ROOT / "benchmark" / "configs" / "kolmogorov_fvm128.json") as f:
        cfg = json.load(f)
    return dict(cfg, grid_size=n, inner_steps=INNER_STEPS, frames=FRAMES)


def _noise(n: int, batch: int = BATCH) -> torch.Tensor:
    g = torch.Generator().manual_seed(SEED + n)
    return torch.randn((batch, 2, n, n), dtype=torch.float64, generator=g)


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """The worst sample's relative L2 distance; the sample axis is the one
    of size ``BATCH`` (first, or second for frames)."""
    if got.shape[0] != BATCH:
        got, want = got.transpose(0, 1), want.transpose(0, 1)
    return float(((got - want).flatten(1).norm(dim=1) / want.flatten(1).norm(dim=1)).max())


def _port(n: int, dtype=torch.float64):
    return example.build(n, dtype, "cpu", noise=_noise(n))


def _ref_ic(n: int, dtype=torch.float64):
    cfg = _config(n)
    inv = ref.inverse_laplacian(n, ref.cell_width(cfg), dtype, "cpu")
    return cfg, inv, ref.initial_velocity(_noise(n).to(dtype), cfg, inv)


def _data(v) -> tuple:
    return tuple(u.data for u in v)


@pytest.mark.parametrize("n", SIZES)
def test_initial_velocity_matches_reference(n):
    v0, _, dt = _port(n)
    cfg, _, want = _ref_ic(n)
    assert dt == ref.time_step(cfg)
    for got, w in zip(_data(v0), want):
        assert _rel(got, w) < TOL


def _term(name, v, eqn, dt, cfg, inv):
    """``(port's, reference's)`` of one term on the velocity ``v``."""
    h, vel = ref.cell_width(cfg), _data(v)
    if name == "convect":
        return (_data(fvm.convect(v, dt)),
                tuple(ref.advection(vel, d, h, dt) for d in range(2)))
    if name == "diffuse_velocity":
        nu = cfg["viscosity"] / cfg["density"]
        return (_data(fvm.diffuse_velocity(v, nu)),
                tuple(nu * ref.laplacian(c, h) for c in vel))
    return _data(eqn.pressure_projection(v)), ref.project(*vel, h, inv)


TERMS = ["convect", "diffuse_velocity", "pressure_projection"]


@pytest.mark.parametrize("term", TERMS)
@pytest.mark.parametrize("n", SIZES)
def test_each_term_matches_reference(n, term):
    """On the initial velocity, and for the projection on a velocity that
    is not divergence-free (the initial one plus its convection)."""
    v0, eqn, dt = _port(n)
    cfg, inv, _ = _ref_ic(n)
    v = v0
    if term == "pressure_projection":
        v = fvm.wrap_field_same_bcs(
            tuple(u.array + 0.1 * a for u, a in zip(v0, fvm.convect(v0, dt))), v0)
    got, want = _term(term, v, eqn, dt, cfg, inv)
    for g, w in zip(got, want):
        assert _rel(g, w) < TOL


@pytest.mark.parametrize("n", SIZES)
def test_one_step_matches_reference(n):
    v0, eqn, dt = _port(n)
    cfg, inv, vel = _ref_ic(n)
    got = _data(eqn.forward(v0, dt))
    want = ref.rk4_step(vel, cfg, ref.cell_width(cfg), dt, inv,
                        ref.forcing(cfg, n, torch.float64, "cpu"))
    for g, w in zip(got, want):
        assert _rel(g, w) < TOL


@pytest.mark.parametrize("n", SIZES)
def test_rollout_frames_match_reference(n):
    v0, eqn, dt = _port(n)
    frames, v = fvm.rollout(v0, eqn, dt, INNER_STEPS, FRAMES)
    assert frames.shape == (FRAMES, BATCH, n, n) and frames.dtype == torch.float64
    want, want_v = ref.records(_noise(n), _config(n))
    assert _rel(frames, want) < ROLLOUT_TOL
    for g, w in zip(_data(v), want_v):
        assert _rel(g, w) < ROLLOUT_TOL
    h = ref.cell_width(_config(n))
    assert float(ref.divergence(*_data(v), h).abs().max()) < DIV_TOL


@pytest.mark.parametrize("check", ["initial_velocity", "convect", "step", "frames", "divergence"])
def test_the_fp32_reference_fails_each_tolerance(check):
    """The reference one precision below the configuration's, against the
    fp64 port at 32²: each tolerance above fails it."""
    n = 32
    v0, eqn, dt = _port(n)
    cfg, inv, vel = _ref_ic(n, torch.float32)
    h = ref.cell_width(cfg)
    if check == "initial_velocity":
        assert _rel(v0[0].data, vel[0].double()) > 1000 * TOL
    elif check == "convect":
        got = fvm.convect(v0, dt)[0].data
        assert _rel(got, ref.advection(vel, 0, h, dt).double()) > 1000 * TOL
    elif check == "step":
        want = ref.rk4_step(vel, cfg, h, dt, inv, ref.forcing(cfg, n, torch.float32, "cpu"))
        assert _rel(eqn.forward(v0, dt)[0].data, want[0].double()) > 1000 * TOL
    else:
        frames, v = fvm.rollout(v0, eqn, dt, INNER_STEPS, FRAMES)
        want, want_v = ref.records(_noise(n).float(), cfg)
        if check == "frames":
            assert _rel(frames, want.double()) > 1000 * ROLLOUT_TOL
        else:
            div = ref.divergence(*(c.double() for c in want_v), h).abs().max()
            assert float(div) > 1000 * DIV_TOL


def test_each_sample_equals_its_run_alone():
    """The batch's rollout, sample by sample, against each sample's own
    rollout from its own noise (the example's single-sample shape). Not bit
    for bit: the FFTs of a batch round otherwise than one sample's (frames
    4.4e-15 apart at most at 16²); no sample sees another's data."""
    n = 16
    noise = _noise(n)
    v0, eqn, dt = example.build(n, torch.float64, "cpu", noise=noise)
    frames, _ = fvm.rollout(v0, eqn, dt, INNER_STEPS, FRAMES)
    for k in range(BATCH):
        w0, eqn_k, _ = example.build(n, torch.float64, "cpu", noise=noise[k])
        alone, _ = fvm.rollout(w0, eqn_k, dt, INNER_STEPS, FRAMES)
        assert alone.shape == (FRAMES, n, n)
        rel = (frames[:, k] - alone).norm() / alone.norm()
        assert float(rel) < TOL


def test_build_draws_one_sample_or_a_batch():
    """``build`` at ``batch=None`` draws the example's one sample from its
    seed as before; ``batch=b`` draws ``(b, 2, n, n)`` from the same seed."""
    n = 16
    one, _, _ = example.build(n, torch.float64, "cpu")
    g = torch.Generator().manual_seed(example.SEED)
    noise = torch.randn((2, n, n), dtype=torch.float64, generator=g)
    grid = one[0].grid
    for got, want in zip(_data(one), _data(example.initial_velocity(grid, noise,
                                                                     torch.float64, "cpu"))):
        assert got.shape == (n, n) and torch.equal(got, want)
    batch, _, _ = example.build(n, torch.float64, "cpu", batch=4)
    assert batch[0].data.shape == (4, n, n)
    g = torch.Generator().manual_seed(example.SEED)
    noise = torch.randn((4, 2, n, n), dtype=torch.float64, generator=g)
    assert torch.equal(batch[1].data, example.initial_velocity(grid, noise, torch.float64,
                                                               "cpu")[1].data)


def test_the_example_steps_an_ensemble(tmp_path):
    out = example.main(["--n", "16", "--frames", "2", "--inner-steps", "3", "--batch", "2",
                        "--no-cuda", "--out", str(tmp_path / "fvm.png")])
    assert out["frames"].shape == (2, 2, 16, 16)
    assert out["velocity"][0].data.shape == (2, 16, 16)
    assert out["max_div"] < 1e-12 and math.isfinite(out["ms_per_step"])


def test_spans_leave_every_result_bitwise_equal(tmp_path):
    """The rollout under a CPU profiler session, where the spans of
    ``fvm.py`` open, gives the same bits as without one; the trace holds
    ``solver.forward``, ``solver.explicit`` and ``solver.projection`` (four
    of each a step) and ``gen.record`` (one a frame)."""
    n, steps = 16, 2

    def run():
        v0, eqn, dt = _port(n)
        return fvm.rollout(v0, eqn, dt, steps, FRAMES)

    plain, plain_v = run()
    with profile_to(str(tmp_path)) as d:
        traced, traced_v = run()
    (path,) = glob.glob(f"{d}/*.json")
    with open(path) as f:
        names = [e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"]
    assert names.count("solver.forward") == steps * FRAMES
    assert names.count("solver.explicit") == 4 * steps * FRAMES
    assert names.count("solver.projection") == 4 * steps * FRAMES
    assert names.count("gen.record") == FRAMES
    assert torch.equal(traced, plain)
    for a, b in zip(_data(traced_v), _data(plain_v)):
        assert torch.equal(a, b)

"""The FVM solver's explicit-terms kernel (``ops/cuda/fvm_explicit.py``) and its route.

Imports only torch and the port. On the CPU: the route rule of
``NavierStokes2DFVMProjection._kernel_takes`` (the example's equation fits
the kernel in fp32 and fp64; CPU fields, other schemes, a patched
``advect_van_leer_using_limiters``, walls, other offsets, dtypes, a gradient
and a foreign forcing do not), the CPU ``_explicit_terms`` bit for bit as
the solver computed it before the route existed, the wrapper's checks, its
plain version against the solver's plain path, and a numpy emulation of the
kernel's blocks (halo staging with periodic wrap, the face-flux walk, the
cells each thread writes) against that plain version.

On the card (``@pytest.mark.cuda``; each skips without one:
``python -m pytest -m cuda tests/test_torch_fvm_explicit_kernel.py``): the
kernel against the solver's plain path at 16², 32² and 128², batches 1, 3
and 64, fp32 and fp64, with and without forcing and drag, ρ ≠ 1; the launch
count of one classic-RK4 step; the benchmark's planted upwind fault
(``benchmark/tests/test_bench_fvm.py::fault_upwind``) taking the plain path.

Tolerances. Plain version and kernel compute the same operations on the
same operands; they differ where the kernel's compiler fuses a multiply and
an add (one rounding fewer) and where the solver's plain path divides by h
or ρ while the others multiply by the reciprocal, so each rate differs by a
few ulp of its largest term, and a term is at most ~20× the largest rate
(a flux difference over h at 128²). fp64: within 1e-12 of the largest rate
(~4,500 ulp; the switches of upwind side and limiter read the same face
velocity and gradient ratio in both, and the limited flux is continuous in
them); on the CPU, where neither side fuses, within 8 ulp. fp32: within
1e-5 of the largest rate (~80 fp32 ulp).
"""

import functools
import math

import numpy as np
import pytest
import torch

from tpu_cfd_torch import boundaries, grids
from tpu_cfd_torch.examples import ex1_kolmogorov_fvm as ex
from tpu_cfd_torch.ops.cuda import _build
from tpu_cfd_torch.ops.cuda import fvm_explicit as fe
from tpu_cfd_torch.solvers import forcings, fvm

torch.set_num_threads(2)

ULP64 = np.finfo(np.float64).eps
CPU = torch.device("cpu")


def _rel(got, want) -> float:
    return float((got.double().cpu() - want.double().cpu()).abs().max()
                 / want.double().cpu().abs().max())


def _equation(grid, dtype, forcing=True, drag=0.1, density=1.0, method="classic_rk4"):
    """The example's equation with its forcing, drag and density as asked."""
    force = (forcings.KolmogorovForcing(grid=grid, diam=2 * math.pi, wave_number=3,
                                        offsets=grid.cell_faces) if forcing else None)
    return fvm.NavierStokes2DFVMProjection(
        viscosity=ex.VISCOSITY, grid=grid, density=density, drag=drag, forcing=force,
        solver=fvm.RKStepper.from_method(method), dtype=dtype)


def _state(n, dtype, device, batch=3, seed=0):
    """The example's initial velocity at n², ``batch`` samples (None: one)."""
    v, _, dt = ex.build(n, dtype, device, seed=seed, batch=batch)
    return v, dt


def _forcing_arrays(eqn, v):
    """The equation's forcing as the route hands it to the wrapper."""
    if eqn.forcing is None:
        return None
    return tuple(f.data for f in eqn._forcing_term(v[0].dtype, v[0].data.device))


# ---------------------------------------------------------------- route ----

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_examples_equation_fits_the_kernel(dtype):
    v, eqn, _ = ex.build(16, dtype, CPU, batch=2)
    assert eqn._kernel_fits(v)
    assert not eqn._kernel_takes(v)  # CPU fields: the plain path


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_a_fitting_evaluation_goes_through_the_wrapper(monkeypatch, dtype):
    """With the device test passed, ``_explicit_terms`` hands the fields, the
    forcing and the constants to ``explicit_rates`` once (here its plain
    version) and wraps the rates as the plain path does."""
    v, eqn, dt = ex.build(16, dtype, CPU, batch=2)
    want = eqn._explicit_terms_plain(v, dt)
    calls, rates = [], fe.explicit_rates

    def spy(*args):
        calls.append(args)
        return rates(*args)

    monkeypatch.setattr(type(eqn), "_kernel_takes", lambda self, v: True)
    monkeypatch.setattr(fe, "explicit_rates", spy)
    got = eqn._explicit_terms(v, dt)
    assert len(calls) == 1
    _, _, forcing, step, dt_, visc, rho, drag = calls[0]
    assert step == v[0].grid.step and dt_ == dt
    assert (visc, rho, drag) == (ex.VISCOSITY, ex.DENSITY, ex.DRAG)
    assert len(forcing) == 2 and forcing[0].shape == (16, 16)
    tol = 8 * ULP64 if dtype == torch.float64 else 1e-5
    for g, w in zip(got, want):
        assert isinstance(g, grids.GridVariable) and g.offset == w.offset and g.bc == w.bc
        assert g.data.dtype == dtype and _rel(g.data, w.data) < tol


def _linear_convect(v, dt):
    return grids.GridArrayVector(tuple(fvm.advect_linear(u, v, dt) for u in v))


def _walls(v):
    bc = boundaries.channel_flow_boundary_conditions(2)
    return grids.GridVariableVector(tuple(grids.GridVariable(u.array, bc) for u in v))


def _centred(v):
    return grids.GridVariableVector(tuple(
        grids.GridVariable(grids.GridArray(u.data, (0.5, 0.5), u.grid), u.bc) for u in v))


def _as(v, dtype):
    return grids.GridVariableVector(tuple(u.astype(dtype) for u in v))


def _needing_grad(v):
    return grids.GridVariableVector(tuple(
        grids.GridVariable(grids.GridArray(u.data.clone().requires_grad_(), u.offset, u.grid),
                           u.bc) for u in v))


def _scheme(convect):
    def case(eqn, v, mp):
        eqn.convect = convect
        return v
    return case


def _patched_van_leer(eqn, v, mp):
    """``benchmark/tests/test_bench_fvm.py``'s ``fault_upwind`` patch."""
    mp.setattr(fvm, "advect_van_leer_using_limiters",
               lambda c, v, dt: fvm.advect_upwind(c, v, dt))
    return v


def _forcing_in_fp32(eqn, v, mp):
    eqn._forcing_term(torch.float32, CPU)
    return v


REFUSALS = {
    "linear_scheme": _scheme(_linear_convect),
    "van_leer_direct": _scheme(lambda v, dt: grids.GridArrayVector(
        tuple(fvm.advect_van_leer(u, v, dt) for u in v))),
    "convect_wrapped": _scheme(functools.partial(fvm.convect)),
    "patched_van_leer": _patched_van_leer,
    "walls": lambda eqn, v, mp: _walls(v),
    "cell_centred": lambda eqn, v, mp: _centred(v),
    "float16": lambda eqn, v, mp: _as(v, torch.float16),
    "bfloat16": lambda eqn, v, mp: _as(v, torch.bfloat16),
    "mixed_dtypes": lambda eqn, v, mp: grids.GridVariableVector(
        (v[0], v[1].astype(torch.float32))),
    "needs_grad": lambda eqn, v, mp: _needing_grad(v),
    "forcing_in_fp32": _forcing_in_fp32,
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_what_the_kernel_does_not_take(monkeypatch, case):
    v, eqn, dt = ex.build(16, torch.float64, CPU, batch=2)
    assert eqn._kernel_fits(v)
    eqn._forcing = None  # built afresh below, in the dtype a case asks for
    v = REFUSALS[case](eqn, v, monkeypatch)
    assert not eqn._kernel_fits(v)
    assert not eqn._kernel_takes(v)


def test_the_patched_scheme_is_read_at_each_call(monkeypatch):
    """The benchmark's upwind fault patches the module's name after the
    equation is built; the route reads it at each call, and restores."""
    v, eqn, _ = ex.build(16, torch.float64, CPU, batch=2)
    with monkeypatch.context() as mp:
        _patched_van_leer(eqn, v, mp)
        assert not eqn._kernel_fits(v)
    assert eqn._kernel_fits(v)


def test_no_gradient_needed_under_no_grad():
    v, eqn, _ = ex.build(16, torch.float64, CPU, batch=2)
    v = _needing_grad(v)
    assert not eqn._kernel_fits(v)
    with torch.no_grad():
        assert eqn._kernel_fits(v)


def _explicit_terms_before(eqn, v, dt):
    """``_explicit_terms`` as the solver wrote it before the route."""
    dv_dt = eqn.convect(v, dt)
    dv_dt += fvm.diffuse_velocity(v, eqn.viscosity / eqn.density)
    if eqn.forcing is not None:
        dv_dt += eqn._forcing_term(v[0].dtype, v[0].data.device) / eqn.density
    dv_dt = fvm.wrap_field_same_bcs(dv_dt, v)
    if eqn.drag > 0.0:
        dv_dt += -eqn.drag * v
    return dv_dt


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("forcing,drag,density", [(True, 0.1, 1.0), (False, 0.0, 1.3)])
@pytest.mark.parametrize("batch", [None, 3])
def test_the_cpu_explicit_terms_are_unchanged(dtype, forcing, drag, density, batch):
    v, _ = _state(16, dtype, CPU, batch=batch)
    eqn = _equation(v[0].grid, dtype, forcing, drag, density)
    fe.reset_launch_counts()
    got = eqn.explicit_terms(v, 0.05)
    want = _explicit_terms_before(eqn, v, 0.05)
    assert fe.LAUNCHES["explicit"] == 0
    for g, w in zip(got, want):
        assert g.offset == w.offset and g.bc == w.bc and torch.equal(g.data, w.data)


# ------------------------------------------------------------- wrapper ----

def test_the_kernel_source_builds_alone():
    assert [p.name for p in _build.sources("fvm_explicit")] == ["fvm_explicit.cu"]


def _fields(shape=(2, 16, 16), dtype=torch.float64):
    gen = torch.Generator().manual_seed(1)
    return (torch.randn(shape, dtype=dtype, generator=gen),
            torch.randn(shape, dtype=dtype, generator=gen))


LAUNCH_REFUSALS = {
    "float16": lambda u, v: (u.half(), v.half(), None),
    "one_dim": lambda u, v: (u[0, 0], v[0, 0], None),
    "shapes": lambda u, v: (u, v[:, :8], None),
    "dtypes": lambda u, v: (u, v.float(), None),
    "not_contiguous": lambda u, v: (u.transpose(-1, -2), v.transpose(-1, -2), None),
    "devices": lambda u, v: (u, torch.empty(v.shape, dtype=v.dtype, device="meta"), None),
    "gradient": lambda u, v: (u.requires_grad_(), v, None),
    "forcing_shape": lambda u, v: (u, v, (u[0, :8], v[0, :8])),
    "forcing_dtype": lambda u, v: (u, v, (u[0].float(), v[0].float())),
}


@pytest.mark.parametrize("case", sorted(LAUNCH_REFUSALS))
def test_the_wrapper_refuses_what_the_kernel_does_not_take(case):
    u, v, forcing = LAUNCH_REFUSALS[case](*_fields())
    fe.reset_launch_counts()
    with pytest.raises(ValueError):
        fe._launch(u, v, forcing, (0.4, 0.4), 0.01, 1e-3, 1.0, 0.1)
    assert fe.LAUNCHES["explicit"] == 0


def test_no_kernel_for_other_devices():
    u = torch.empty((2, 8, 8), device="meta")
    with pytest.raises(ValueError, match="fvm-explicit"):
        fe.explicit_rates(u, u, None, (0.4, 0.4), 0.01, 1e-3, 1.0, 0.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,batch", [(16, None), (24, 2), (32, 3)])
@pytest.mark.parametrize("forcing,drag,density", [(True, 0.1, 1.0), (False, 0.0, 0.7),
                                                  (True, 0.0, 1.3)])
def test_the_plain_version_matches_the_solver(dtype, n, batch, forcing, drag, density):
    v, dt = _state(n, dtype, CPU, batch=batch)
    eqn = _equation(v[0].grid, dtype, forcing, drag, density)
    want = eqn._explicit_terms_plain(v, dt)
    got = fe.explicit_rates(v[0].data, v[1].data, _forcing_arrays(eqn, v), v[0].grid.step, dt,
                            eqn.viscosity, eqn.density, eqn.drag)
    scale = max(float(w.data.abs().max()) for w in want)
    tol = 8 * ULP64 if dtype == torch.float64 else 1e-5
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.data.shape
        assert float((g - w.data).double().abs().max()) < tol * scale


# ------------------------------------------- the kernel's blocks, in numpy ----

def _face_flux(cm, c0, cp, cpp, w, courant):
    pos = w > 0
    diff = cp - c0
    low = np.where(pos, c0, cp)
    cw = courant * w
    high = np.where(pos, c0 + 0.5 * (1 - cw) * diff, cp - 0.5 * (1 + cw) * diff)
    num = np.where(pos, c0 - cm, cpp - cp)
    r = num / np.where(diff != 0, diff, 1.0)
    one_r = 1 + r
    phi = np.where(r > 0, 2 * r / np.where(one_r != 0, one_r, 1.0), 0.0)
    return (low - (low - high) * phi) * w


def _emulate_kernel(u, v, forcing, step, dt, viscosity, density, drag):
    """``csrc/fvm_explicit.cu``'s blocks in numpy, index for index: each
    block stages its tile and halo with periodic wrap, walks the 2·FACES
    face tasks, then each of its 256 threads writes its cells. Returns the
    rates and how often each cell was written."""
    TR, TC = fe.TILE
    H = fe.HALO
    SR, SC = TR + 2 * H, TC + 2 * H
    F0, F1 = (TR + 1) * TC, TR * (TC + 1)
    FACES, THREADS = F0 + F1, 256
    n0, n1 = u.shape[-2:]
    ub, vb = (x.reshape(-1, n0, n1).numpy() for x in (u, v))
    out = np.full((2,) + ub.shape, np.nan)
    written = np.zeros(out.shape, dtype=int)
    h0, h1 = step
    courant = (dt / h0, dt / h1)
    inv_h = (1.0 / h0, 1.0 / h1)
    s0, s1 = 1.0 / (h0 * h0), 1.0 / (h1 * h1)
    nu, inv_rho = viscosity / density, 1.0 / density

    task = np.arange(2 * FACES)
    comp = (task >= FACES).astype(int)
    f = task - comp * FACES
    axis0 = f < F0
    g = f - F0
    si = np.where(axis0, f // TC + H - 1, g // (TC + 1) + H)
    sj = np.where(axis0, f % TC + H, g % (TC + 1) + H - 1)
    at = si * SC + sj
    stride = np.where(axis0, SC, 1)
    qsel = np.where(axis0, 0, 1)
    wstep = np.where(comp == 1, 1, SC)
    reads = np.concatenate([at - stride, at + 2 * stride, at + wstep])
    assert reads.min() >= 0 and reads.max() < SR * SC  # inside the staged tile
    t = np.arange(THREADS)
    lr = np.concatenate([t // TC + p * (THREADS // TC) for p in range(TR * TC // THREADS)])
    lc = np.concatenate([t % TC] * (TR * TC // THREADS))
    for s in range(ub.shape[0]):
        for r0 in range(0, n0, TR):
            for c0 in range(0, n1, TC):
                rows = (r0 - H + np.arange(SR)) % n0
                cols = (c0 - H + np.arange(SC)) % n1
                sc = np.stack([x[s][np.ix_(rows, cols)].ravel() for x in (ub, vb)])
                w = 0.5 * sc[qsel, at] + 0.5 * sc[qsel, at + wstep]
                flux = _face_flux(*(sc[comp, at + k * stride] for k in (-1, 0, 1, 2)), w,
                                  np.where(axis0, *courant)).reshape(2, FACES)
                i, j = r0 + lr, c0 + lc
                keep = (i < n0) & (j < n1)
                cell = (lr + H) * SC + lc + H
                for k in range(2):
                    fl, c = flux[k], sc[k]
                    d0 = (fl[(lr + 1) * TC + lc] - fl[lr * TC + lc]) * inv_h[0]
                    d1 = (fl[F0 + lr * (TC + 1) + lc + 1] - fl[F0 + lr * (TC + 1) + lc]) * inv_h[1]
                    lap = (-2 * c[cell] * (s0 + s1) + (c[cell - SC] + c[cell + SC]) * s0
                           + (c[cell - 1] + c[cell + 1]) * s1)
                    rate = -(d0 + d1) + nu * lap
                    if forcing is not None:
                        rate = rate + forcing[k].numpy()[i % n0, j % n1] * inv_rho
                    if drag > 0.0:
                        rate = rate + (-drag) * c[cell]
                    out[k, s, i[keep], j[keep]] = rate[keep]
                    np.add.at(written[k, s], (i[keep], j[keep]), 1)
    return out.reshape((2,) + tuple(u.shape)), written


@pytest.mark.parametrize("n0,n1,batch", [(16, 16, 2), (8, 8, 1), (20, 40, 2), (48, 33, 1),
                                         (32, 64, 1)])
def test_the_kernels_blocks_compute_the_plain_version(n0, n1, batch):
    grid = grids.Grid((n0, n1), domain=((0, 2 * math.pi), (0, 3.0)))
    gen = torch.Generator().manual_seed(n0 * n1)
    u, v = (torch.randn((batch, n0, n1), dtype=torch.float64, generator=gen)
            for _ in range(2))
    forcing = tuple(torch.randn((n0, n1), dtype=torch.float64, generator=gen)
                    for _ in range(2))
    args = (forcing, grid.step, 0.02, 1e-3, 1.2, 0.1)
    got, written = _emulate_kernel(u, v, *args)
    assert (written == 1).all()  # every cell of every sample written once
    want = fe._explicit_plain(u, v, *args)
    for g, w in zip(got, want):
        assert np.abs(g - w.numpy()).max() <= 4 * ULP64 * np.abs(w.numpy()).max()


# ---------------------------------------------------------- on the card ----

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "python -m pytest -m cuda tests/test_torch_fvm_explicit_kernel.py)")
    return torch.device("cuda")


VARIANTS = {"forced_drag": (True, 0.1, 1.0), "free_rho": (False, 0.0, 1.3),
            "forced_rho": (True, 0.0, 0.7)}


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("batch", [1, 3, 64])
@pytest.mark.parametrize("n", [16, 32, 128])
def test_the_kernel_matches_the_plain_path(dev, n, batch, dtype, variant):
    v, dt = _state(n, dtype, dev, batch=batch, seed=n + batch)
    eqn = _equation(v[0].grid, dtype, *VARIANTS[variant])
    assert eqn._kernel_takes(v)
    fe.reset_launch_counts()
    got = eqn.explicit_terms(v, dt)
    assert fe.LAUNCHES["explicit"] == 1
    want = eqn._explicit_terms_plain(v, dt)
    scale = max(float(w.data.abs().max()) for w in want)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for g, w in zip(got, want):
        assert g.data.device == w.data.device and g.data.dtype == dtype
        assert g.offset == w.offset and g.bc == w.bc
        assert float((g.data - w.data).double().abs().max()) < tol * scale
    mirror = fe._explicit_plain(v[0].data, v[1].data, _forcing_arrays(eqn, v), v[0].grid.step, dt,
                                eqn.viscosity, eqn.density, eqn.drag)
    for g, w in zip(got, mirror):
        assert float((g.data - w).double().abs().max()) < tol * scale


@pytest.mark.cuda
def test_one_classic_rk4_step_launches_four_times(dev):
    v, eqn, dt = ex.build(32, torch.float64, dev, batch=4)
    fe.reset_launch_counts()
    eqn(v, dt)
    assert fe.LAUNCHES["explicit"] == 4


@pytest.mark.cuda
def test_the_upwind_fault_takes_the_plain_path_on_the_card(dev, monkeypatch):
    """``benchmark/tests/test_bench_fvm.py``'s ``fault_upwind`` patch: the
    card's evaluation follows it (no launch) and moves by more than 1e-3."""
    v, eqn, dt = ex.build(128, torch.float64, dev, batch=2)
    fe.reset_launch_counts()
    clean = eqn.explicit_terms(v, dt)
    assert fe.LAUNCHES["explicit"] == 1
    monkeypatch.setattr(fvm, "advect_van_leer_using_limiters",
                        lambda c, v, dt: fvm.advect_upwind(c, v, dt))
    faulty = eqn.explicit_terms(v, dt)
    assert fe.LAUNCHES["explicit"] == 1
    scale = max(float(w.data.abs().max()) for w in clean)
    assert max(float((a.data - b.data).abs().max()) for a, b in zip(faulty, clean)) > 1e-3 * scale

"""The FVM step's projection and RK-combination kernels (``ops/cuda/fvm_projection.py``) and their route.

Imports only torch and the port. On the CPU: the route rule
(``PressureProjection._kernel_fits``, and ``fvm_projection.fits_mac_kernels``,
which ``RKStepper``'s combination asks: the example's equation fits in fp32
and fp64; walls, an odd n1, other offsets, bf16, a gradient and devices
other than the CPU and the card do not), the CPU projection and RK step,
which take the wrappers' plain versions, bit for bit as the solver computed
them before the route existed, that periodic ``impose_bc`` hands back the
values it was given (so the route may skip it), each wrapper's plain
version against the solver's plain path, the wrappers' calls a step, the
wrappers' checks and counters, and a numpy emulation of the kernels'
indexing (each cell's wrapped neighbours, the blocks over a plane and the
samples) against the plain versions.

On the card (``@pytest.mark.cuda``; each skips without one:
``python -m pytest -m cuda tests/test_torch_fvm_projection_kernel.py``):
each kernel against the solver's plain path on the card at 16², 32² and
128², batches 1, 3 and 64, fp32 and fp64; a 20-step classic-RK4 rollout on
every kernel against the CPU; the launch counts of one step.

Tolerances. Kernel and plain path compute the same IEEE operations on the
same operands in the same order: products and sums rounded one at a time
(the kernels use the ``_rn`` intrinsics, so nothing fuses into a
multiply-add), each division by h a product by the reciprocal rounded in the
fields' type, as torch divides a CUDA tensor by a Python scalar. So the
kernels match the plain path on the card exactly, and on the CPU the plain
versions match the solver exactly. The 20-step rollout, card against CPU,
holds to ``test_torch_cuda_finetune_fvm.py``'s 1e-10 of the largest entry
(cuFFT against pocketfft, and the CPU's true divisions).
"""

import math

import numpy as np
import pytest
import torch

from tpu_cfd_torch import boundaries, grids
from tpu_cfd_torch.examples import ex1_kolmogorov_fvm as ex
from tpu_cfd_torch.ops import finite_differences as fdm
from tpu_cfd_torch.ops.cuda import _build
from tpu_cfd_torch.ops.cuda import fvm_explicit as fe
from tpu_cfd_torch.ops.cuda import fvm_projection as fp
from tpu_cfd_torch.solvers import fvm, pressure

torch.set_num_threads(2)

CPU = torch.device("cpu")
GridVariable, GridArray = grids.GridVariable, grids.GridArray
GridVariableVector = grids.GridVariableVector


def _velocity(grid, batch=2, dtype=torch.float64, device=CPU, seed=0, bc=None):
    """Random components on the MAC offsets of ``grid``, periodic unless ``bc``."""
    bc = bc or boundaries.periodic_boundary_conditions(2)
    gen = torch.Generator().manual_seed(seed)
    shape = (batch, *grid.shape) if batch else grid.shape
    return GridVariableVector(tuple(
        GridVariable(GridArray(torch.randn(shape, dtype=torch.float64, generator=gen)
                               .to(dtype=dtype, device=device), off, grid), bc)
        for off in grid.cell_faces))


def _projection_for(v, dtype=None):
    grid = v[0].grid
    return pressure.PressureProjection(grid, boundaries.get_pressure_bc_from_velocity(v),
                                       dtype=dtype or v[0].dtype)


def _data(v):
    return [u.data for u in v]


def _same(got, want):
    for g, w in zip(got, want):
        assert g.offset == w.offset and g.bc == w.bc
        assert g.data.dtype == w.data.dtype and torch.equal(g.data, w.data)


# ---------------------------------------------------------------- route ----

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_examples_equation_fits_the_kernels(dtype):
    v, eqn, dt = ex.build(16, dtype, CPU, batch=2)
    k = eqn.explicit_terms(v, dt)
    assert eqn._projection._kernel_fits(v)
    assert fp.fits_mac_kernels(v, k, k)


def _walls(v):
    bc = boundaries.channel_flow_boundary_conditions(2)
    return GridVariableVector(tuple(GridVariable(u.array, bc) for u in v))


def _centred(v):
    return GridVariableVector(tuple(
        GridVariable(GridArray(u.data, (0.5, 0.5), u.grid), u.bc) for u in v))


def _as(v, dtype):
    return GridVariableVector(tuple(u.astype(dtype) for u in v))


def _needing_grad(v):
    return GridVariableVector(tuple(
        GridVariable(GridArray(u.data.clone().requires_grad_(), u.offset, u.grid), u.bc)
        for u in v))


def _on_meta(v):
    return GridVariableVector(tuple(
        GridVariable(GridArray(u.data.to("meta"), u.offset, u.grid), u.bc) for u in v))


def _odd_n1(v):
    return _velocity(grids.Grid((16, 15), domain=((0, 2 * math.pi), (0, 2 * math.pi))))


# each case: the velocity it hands the projection, built for that velocity
PROJECTION_REFUSALS = {
    "walls": _walls,
    "odd_n1": _odd_n1,
    "cell_centred": _centred,
    "bfloat16": lambda v: _as(v, torch.bfloat16),
    "float16": lambda v: _as(v, torch.float16),
    "mixed_dtypes": lambda v: GridVariableVector((v[0], v[1].astype(torch.float32))),
    "needs_grad": _needing_grad,
    "meta_device": _on_meta,
}


@pytest.mark.parametrize("case", sorted(PROJECTION_REFUSALS))
def test_what_the_projection_kernels_do_not_take(case):
    v, _, _ = ex.build(16, torch.float64, CPU, batch=2)
    v = PROJECTION_REFUSALS[case](v)
    proj = _projection_for(v, dtype=torch.float64)
    assert not proj._kernel_fits(v)
    assert case == "odd_n1" or not fp.fits_mac_kernels(v)


def test_walls_take_the_matmul_solve_and_odd_n1_the_fft():
    v, _, _ = ex.build(16, torch.float64, CPU, batch=2)
    assert _projection_for(_walls(v)).solver.implementation == "matmul"
    odd = _odd_n1(v)
    assert fp.fits_mac_kernels(odd)  # the explicit kernel takes it
    assert _projection_for(odd).solver.implementation == "fft"


def test_a_projection_in_another_dtype_does_not_fit():
    v, _, _ = ex.build(16, torch.float64, CPU, batch=2)
    assert not _projection_for(v, dtype=torch.float32)._kernel_fits(v)


def _other_bc(v):
    bc = boundaries.ConstantBoundaryConditions(
        ((boundaries.BCType.PERIODIC,) * 2,) * 2, ((None, None),) * 2)
    assert bc != v[0].bc
    return GridVariableVector(tuple(GridVariable(u.array, bc) for u in v))


# each case: the rates that RKStepper would combine with the example's state
COMBINE_REFUSALS = {
    "walls": _walls,
    "cell_centred": _centred,
    "bfloat16": lambda k: _as(k, torch.bfloat16),
    "float32_rate": lambda k: _as(k, torch.float32),
    "needs_grad": _needing_grad,
    "other_bc": _other_bc,
    "other_grid": lambda k: _velocity(grids.Grid((16, 16), domain=((0, 1), (0, 1)))),
    "other_shape": lambda k: _velocity(k[0].grid, batch=3),
}


@pytest.mark.parametrize("case", sorted(COMBINE_REFUSALS))
def test_what_the_combine_kernel_does_not_take(case):
    v, eqn, dt = ex.build(16, torch.float64, CPU, batch=2)
    k = eqn.explicit_terms(v, dt)
    assert fp.fits_mac_kernels(v, k)
    assert not fp.fits_mac_kernels(v, k, COMBINE_REFUSALS[case](k))


def test_no_gradient_needed_under_no_grad():
    v, _, _ = ex.build(16, torch.float64, CPU, batch=2)
    v = _needing_grad(v)
    proj = _projection_for(v)
    assert not proj._kernel_fits(v)
    with torch.no_grad():
        assert proj._kernel_fits(v) and fp.fits_mac_kernels(v, v)


# ------------------------------------------- the CPU path is unchanged ----

def _project_before(proj, v):
    """``PressureProjection.__call__`` as the solver wrote it before the route."""
    pressure_bc = boundaries.get_pressure_bc_from_velocity(v)
    rhs = fdm.divergence(v)
    rhs_inv = proj.solver(pressure.rhs_transform(rhs, pressure_bc))
    q = pressure_bc.impose_bc(GridArray(rhs_inv, rhs.offset, rhs.grid))
    q_grad = fdm.forward_difference(q)
    return GridVariableVector(tuple(u.bc.impose_bc(u.array - q_g)
                                    for u, q_g in zip(v, q_grad)))


def _rk_before(stepper, u0, dt, equation):
    """``RKStepper.__call__`` as the solver wrote it before the route, on
    the projection as it was (``_project_before``)."""
    a, b = stepper.tableau["a"], stepper.tableau["b"]
    k = [None] * len(b)
    k[0] = equation.explicit_terms(u0, dt)
    for i in range(1, len(b)):
        u_star = u0
        for j in range(i):
            if a[i - 1][j] != 0:
                u_star = u_star + dt * a[i - 1][j] * k[j]
        k[i] = equation.explicit_terms(_project_before(equation._projection, u_star), dt)
    u_star = u0
    for j in range(len(b)):
        if b[j] != 0:
            u_star = u_star + dt * b[j] * k[j]
    return _project_before(equation._projection, u_star)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("batch", [None, 3])
def test_the_cpu_projection_is_unchanged(dtype, batch):
    v = _velocity(grids.Grid((16, 16), domain=((0, 2 * math.pi),) * 2), batch, dtype)
    proj = _projection_for(v)
    fp.reset_launch_counts()
    _same(proj(v), _project_before(proj, v))
    _same(pressure.projection(v), _project_before(proj, v))
    assert not any(fp.LAUNCHES.values())


@pytest.mark.parametrize("method", ["forward_euler", "heun_rk2", "midpoint", "classic_rk4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("batch", [None, 3])
def test_the_cpu_rk_step_is_unchanged(method, dtype, batch):
    v, eqn, dt = ex.build(16, dtype, CPU, batch=batch)
    eqn.solver = fvm.RKStepper.from_method(method)
    fp.reset_launch_counts()
    _same(eqn(v, dt), _rk_before(eqn.solver, v, dt, eqn))
    assert not any(fp.LAUNCHES.values())


@pytest.mark.parametrize("offset", ["cell_center", "face_0", "face_1"])
def test_periodic_impose_bc_hands_back_its_values(offset):
    """The plain projection imposes the pressure's BC and each component's;
    periodic, both hand back the very tensor they were given, so the kernel
    route, which leaves them out, returns the same values."""
    grid = grids.Grid((16, 12), domain=((0, 2 * math.pi), (0, 1.0)))
    off = {"cell_center": grid.cell_center, "face_0": grid.cell_faces[0],
           "face_1": grid.cell_faces[1]}[offset]
    x = torch.randn((3, 16, 12), dtype=torch.float64)
    bc = boundaries.periodic_boundary_conditions(2)
    out = bc.impose_bc(GridArray(x, off, grid))
    assert out.data is x and out.offset == off and out.bc == bc


# --------------------------------------------------- the plain versions ----

GRIDS = {"square": ((16, 16), ((0, 2 * math.pi), (0, 2 * math.pi))),
         "oblong": ((12, 20), ((0, 2 * math.pi), (0, 3.0))),
         "odd": ((9, 7), ((0, 1.0), (0, 2.0)))}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", sorted(GRIDS))
@pytest.mark.parametrize("batch", [None, 3])
def test_the_plain_stencils_match_the_solvers(dtype, shape, batch):
    grid = grids.Grid(GRIDS[shape][0], domain=GRIDS[shape][1])
    v = _velocity(grid, batch, dtype, seed=len(shape))
    u, w = _data(v)
    assert torch.equal(fp._divergence_plain(u, w, grid.step), fdm.divergence(v).data)
    q = GridVariable(GridArray(torch.randn(u.shape, dtype=torch.float64).to(dtype),
                               grid.cell_center, grid), boundaries.periodic_boundary_conditions(2))
    want = [(c.array - g).data for c, g in zip(v, fdm.forward_difference(q))]
    got = fp._subtract_gradient_plain(u, w, q.data, grid.step)
    assert all(torch.equal(g, x) for g, x in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("terms", [1, 2, 4])
def test_the_plain_combination_matches_the_solvers(dtype, terms):
    grid = grids.Grid((16, 16), domain=((0, 2 * math.pi),) * 2)
    u0 = _velocity(grid, 3, dtype)
    ks = [_velocity(grid, 3, dtype, seed=j + 1) for j in range(terms)]
    coefs = [0.013 * (j + 1) / 3 for j in range(terms)]
    want = u0
    for c, k in zip(coefs, ks):
        want = want + c * k
    got = fp._combine_plain(tuple(_data(u0)), [(c, tuple(_data(k))) for c, k in zip(coefs, ks)])
    assert all(torch.equal(g, w.data) for g, w in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("method,per_step", [("classic_rk4", 4), ("heun_rk2", 2),
                                             ("forward_euler", 1)])
def test_the_route_through_the_wrappers_matches_the_plain_route(monkeypatch, dtype, method,
                                                                 per_step):
    """A step hands its combinations and its projections' stencils to the
    wrappers (on the CPU their plain versions), one call each a stage, and
    its result is the plain route's, bit for bit."""
    v, eqn, dt = ex.build(16, dtype, CPU, batch=2)
    eqn.solver = fvm.RKStepper.from_method(method)
    want = _rk_before(eqn.solver, v, dt, eqn)
    calls = {name: 0 for name in fp.LAUNCHES}

    def spy(name):
        wrapped = getattr(fp, name)

        def call(*args):
            calls[name] += 1
            return wrapped(*args)
        return call

    for name in calls:
        monkeypatch.setattr(fp, name, spy(name))
    fp.reset_launch_counts()
    _same(eqn(v, dt), want)
    assert calls == dict.fromkeys(calls, per_step)
    assert not any(fp.LAUNCHES.values())  # the plain versions launch nothing


def test_filtered_velocity_field_projects_through_the_route(monkeypatch):
    """The IC's three projections take the route and give the field that
    the plain projections give."""
    calls = []
    for name in ("divergence", "subtract_gradient"):
        wrapped = getattr(fp, name)
        monkeypatch.setattr(fp, name, lambda *a, f=wrapped, n=name: calls.append(n) or f(*a))
    got, _, _ = ex.build(16, torch.float64, CPU, batch=2)
    assert calls == ["divergence", "subtract_gradient"] * 3
    monkeypatch.setattr(pressure.PressureProjection, "_kernel_fits", lambda self, v: False)
    want, _, _ = ex.build(16, torch.float64, CPU, batch=2)
    assert len(calls) == 6
    _same(got, want)


# ------------------------------------------------------------- wrappers ----

def test_the_kernel_source_builds_alone():
    assert [p.name for p in _build.sources("fvm_projection")] == ["fvm_projection.cu"]


def _fields(shape=(2, 16, 16), dtype=torch.float64):
    gen = torch.Generator().manual_seed(1)
    return tuple(torch.randn(shape, dtype=dtype, generator=gen) for _ in range(3))


FIELD_REFUSALS = {
    "float16": lambda u, v, p: (u.half(), v.half(), p.half()),
    "bfloat16": lambda u, v, p: (u.bfloat16(), v.bfloat16(), p.bfloat16()),
    "one_dim": lambda u, v, p: (u[0, 0], v[0, 0], p[0, 0]),
    "shapes": lambda u, v, p: (u, v[:, :8], p),
    "dtypes": lambda u, v, p: (u, v.float(), p),
    "not_contiguous": lambda u, v, p: (u.transpose(-1, -2), v, p),
    "devices": lambda u, v, p: (u, torch.empty(v.shape, dtype=v.dtype, device="meta"), p),
    "gradient": lambda u, v, p: (u, v.requires_grad_(), p),
}


@pytest.mark.parametrize("kernel", ["combine", "divergence", "subtract_gradient"])
@pytest.mark.parametrize("case", sorted(FIELD_REFUSALS))
def test_the_wrappers_refuse_what_the_kernels_do_not_take(kernel, case):
    u, v, p = FIELD_REFUSALS[case](*_fields())
    fp.reset_launch_counts()
    with pytest.raises(ValueError):
        if kernel == "combine":
            fp._combine_launch((u, p), [(0.1, (p, v))])
        elif kernel == "divergence":
            fp._divergence_launch(u, v, (0.4, 0.4))
        else:
            fp._subtract_gradient_launch(u, v, p, (0.4, 0.4))
    assert not any(fp.LAUNCHES.values())


@pytest.mark.parametrize("terms", [0, fp.MAX_TERMS + 1])
def test_the_combine_wrapper_refuses_a_count_of_terms(terms):
    u, v, p = _fields()
    with pytest.raises(ValueError, match="terms"):
        fp._combine_launch((u, v), [(0.1, (p, p))] * terms)


def test_no_kernel_for_other_devices():
    u = torch.empty((2, 8, 8), device="meta")
    for call in (lambda: fp.combine((u, u), [(0.1, (u, u))]),
                 lambda: fp.divergence(u, u, (0.4, 0.4)),
                 lambda: fp.subtract_gradient(u, u, u, (0.4, 0.4))):
        with pytest.raises(ValueError, match="fvm-projection"):
            call()


def test_a_step_beyond_the_combine_kernels_terms_takes_the_term_loop(monkeypatch):
    """A tableau with more nonzero weights in a row than one launch takes
    sums term by term, on the route's fields too."""
    v, eqn, dt = ex.build(16, torch.float64, CPU, batch=2)
    monkeypatch.setattr(fp, "combine", lambda *a: pytest.fail("combine called"))
    k = eqn.explicit_terms(v, dt)
    terms = [(0.01 * (j + 1), k) for j in range(fp.MAX_TERMS + 1)]
    want = v
    for c, kj in terms:
        want = want + c * kj
    _same(fvm._combination(v, terms), want)
    _same(fvm._combination(v, []), v)


# ------------------------------------- the kernels' indexing, in numpy ----

THREADS, MAX_GRID_Y = 256, 65535  # csrc/fvm_projection.cu


def _cells(n0, n1):
    """``cell_at`` for every thread of every block over a plane: the flat
    offsets of (i, j) and of its wrapped neighbours, for the threads the
    kernel keeps (p < n0 n1)."""
    blocks = -(-n0 * n1 // THREADS)
    p = np.arange(blocks * THREADS)
    p = p[p < n0 * n1]
    plane = n0 * n1
    i, j = p // n1, p - (p // n1) * n1
    return dict(at=p,
                up=np.where(i > 0, p - n1, p + plane - n1),
                down=np.where(i < n0 - 1, p + n1, p - plane + n1),
                left=np.where(j > 0, p - 1, p + n1 - 1),
                right=np.where(j < n1 - 1, p + 1, p - n1 + 1))


def _samples(b, grid_y):
    """The samples each blockIdx.y takes: s = y, y + gridDim.y, ..."""
    return [list(range(y, b, grid_y)) for y in range(grid_y)]


def _emulate(kind, u, v, p, step, grid_y=None):
    n0, n1 = u.shape[-2:]
    ub, vb, pb = (x.reshape(-1, n0 * n1).numpy() for x in (u, v, p))
    b = ub.shape[0]
    grid_y = grid_y or min(b, MAX_GRID_Y)
    c = _cells(n0, n1)
    inv = [1.0 / h for h in step]
    out = np.full((2, b, n0 * n1), np.nan)
    written = np.zeros(out.shape, dtype=int)
    for ys in _samples(b, grid_y):
        for s in ys:
            if kind == "divergence":
                out[0, s, c["at"]] = ((ub[s, c["at"]] - ub[s, c["up"]]) * inv[0]
                                      + (vb[s, c["at"]] - vb[s, c["left"]]) * inv[1])
                written[0, s, c["at"]] += 1
            else:
                q = pb[s, c["at"]]
                out[0, s, c["at"]] = ub[s, c["at"]] - (pb[s, c["down"]] - q) * inv[0]
                out[1, s, c["at"]] = vb[s, c["at"]] - (pb[s, c["right"]] - q) * inv[1]
                written[:, s, c["at"]] += 1
    return out.reshape((2,) + tuple(u.shape)), written


@pytest.mark.parametrize("n0,n1,batch,grid_y", [(16, 16, 2, None), (8, 8, 1, None),
                                                (20, 40, 3, None), (9, 7, 5, 2),
                                                (1, 6, 2, None), (33, 1, 1, None)])
def test_the_kernels_indexing_computes_the_plain_versions(n0, n1, batch, grid_y):
    gen = torch.Generator().manual_seed(n0 * n1)
    u, v, p = (torch.randn((batch, n0, n1), dtype=torch.float64, generator=gen)
               for _ in range(3))
    step = (2 * math.pi / n0, 3.0 / n1)
    div, written = _emulate("divergence", u, v, p, step, grid_y)
    assert (written[0] == 1).all()
    want = fp._divergence_plain(u, v, step).numpy()
    assert np.abs(div[0] - want).max() <= 8 * np.finfo(np.float64).eps * np.abs(want).max()
    got, written = _emulate("subtract_gradient", u, v, p, step, grid_y)
    assert (written == 1).all()
    for g, w in zip(got, fp._subtract_gradient_plain(u, v, p, step)):
        assert np.abs(g - w.numpy()).max() <= 8 * np.finfo(np.float64).eps * np.abs(
            w.numpy()).max()


# ---------------------------------------------------------- on the card ----

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "python -m pytest -m cuda tests/test_torch_fvm_projection_kernel.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("batch", [1, 3, 64])
@pytest.mark.parametrize("n", [16, 32, 128])
def test_the_kernels_match_the_plain_path(dev, n, batch, dtype):
    v, eqn, dt = ex.build(n, dtype, dev, batch=batch, seed=n + batch)
    proj = eqn._projection
    k = eqn.explicit_terms(v, dt)
    assert proj._kernel_fits(v) and fp.fits_mac_kernels(v, k)
    u, w = _data(v)
    fp.reset_launch_counts()
    assert torch.equal(fp.divergence(u, w, v[0].grid.step), fdm.divergence(v).data)
    q = proj.solver(fdm.divergence(v).data)
    qv = GridVariable(GridArray(q, v[0].grid.cell_center, v[0].grid),
                      boundaries.periodic_boundary_conditions(2))
    want = [(c.array - g).data for c, g in zip(v, fdm.forward_difference(qv))]
    got = fp.subtract_gradient(u, w, q, v[0].grid.step)
    assert all(torch.equal(g, x) for g, x in zip(got, want))
    _same(proj(v), _project_before(proj, v))
    for terms in (1, 4):
        coefs = [dt * (j + 1) / 6 for j in range(terms)]
        want = v
        for c in coefs:
            want = want + c * k
        got = fp.combine(tuple(_data(v)), [(c, tuple(_data(k))) for c in coefs])
        assert all(torch.equal(g, x.data) for g, x in zip(got, want))
    assert fp.LAUNCHES == {"combine": 2, "divergence": 2, "subtract_gradient": 2}


@pytest.mark.cuda
def test_a_rollout_on_every_kernel_matches_the_cpu(dev):
    ends = {}
    for where, d in (("cpu", CPU), ("card", dev)):
        v, eqn, dt = ex.build(128, torch.float64, d, batch=3)
        for _ in range(20):
            v = eqn(v, dt)
        assert float(fdm.divergence(v).data.abs().max()) < 1e-12
        ends[where] = _data(v)
    for a, b in zip(ends["card"], ends["cpu"]):
        assert a.device.type == dev.type
        assert float((a.cpu() - b).abs().max() / b.abs().max()) < 1e-10


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_one_classic_rk4_step_launches_four_of_each(dev, dtype):
    v, eqn, dt = ex.build(32, dtype, dev, batch=4)
    eqn(v, dt)
    fe.reset_launch_counts()
    fp.reset_launch_counts()
    eqn(v, dt)
    assert fe.LAUNCHES["explicit"] == 4
    assert fp.LAUNCHES == {"combine": 4, "divergence": 4, "subtract_gradient": 4}


@pytest.mark.cuda
def test_walls_and_a_gradient_launch_nothing_on_the_card(dev):
    v, eqn, dt = ex.build(32, torch.float64, dev, batch=2)
    fp.reset_launch_counts()
    walls = _walls(v)
    _projection_for(walls)(walls)
    with torch.enable_grad():
        eqn(_needing_grad(v), dt)
    assert not any(fp.LAUNCHES.values())

"""The port's FVM solver stack against the JAX package, in fp64.

``tensor_utils``, the interpolation schemes and limiters of
``ops/interpolation.py``, every ``advect_*`` of ``solvers/fvm.py``, one step
of ``RKStepper`` for every method, and ``NavierStokes2DFVMProjection`` over
10 steps at 32² with b=4 (each JAX sample stepped alone, the port's batch
at once), on shared numpy inputs. Interpolation and advection are
elementwise arithmetic on the same operands, where XLA may round a division
as a product by a reciprocal (``tests/test_torch_fvm.py`` allows one ulp):
an interpolation within 2 ulp of the largest entry, an advection (a
divergence of such fluxes over a grid step) within 8. A step includes the
FFT pressure solve:
within 1e-12 of the largest entry (the projection's tolerance there), and
after 10 steps within 1e-11. Then the port's own versions of
``tests/test_fvm.py``'s contracts: Taylor-Green decay, the advection's
direction and conservation, and divergence below 1e-12 after a step.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_cfd import boundaries as jb, grids as jg, tensor_utils as jtu
from tpu_cfd.ops import interpolation as jinterp
from tpu_cfd.solvers import forcings as jforcings, fvm as jfvm
from tpu_cfd_torch import boundaries as tb, grids as tg, tensor_utils as ttu
from tpu_cfd_torch.ops import finite_differences as tfdm, interpolation as tinterp
from tpu_cfd_torch.solvers import forcings as tforcings, fvm as tfvm

torch.set_num_threads(2)

N = 32
DIAM = 2 * np.pi
ULP = np.finfo(np.float64).eps


def _grids(n=N):
    dom = ((0, DIAM), (0, DIAM))
    return jg.Grid((n, n), domain=dom), tg.Grid((n, n), domain=dom)


def _smooth(shape, seed, k0=3.0):
    """Band-limited random periodic field(s) over the last two dims."""
    rng = np.random.default_rng(seed)
    n = shape[-1]
    k = np.fft.fftfreq(n, d=1 / n)
    kx, ky = np.meshgrid(k, np.fft.rfftfreq(n, d=1 / n), indexing="ij")
    spec = np.fft.rfft2(rng.standard_normal(shape)) * np.exp(-(kx ** 2 + ky ** 2) / k0 ** 2)
    f = np.fft.irfft2(spec, s=(n, n))
    return f / np.abs(f).max()


def _variable(module, grid, data, offset):
    bc = module[0].periodic_boundary_conditions(2)
    return module[1].GridVariable(module[1].GridArray(data, offset, grid), bc)


JAX, TORCH = (jb, jg), (tb, tg)


def _pair(data, offset):
    """The same field as a JAX and a port GridVariable."""
    gj, gt = _grids(data.shape[-1])
    return (_variable(JAX, gj, jnp.asarray(data), offset),
            _variable(TORCH, gt, torch.from_numpy(data), offset))


def _velocity(data_pair):
    """Face-staggered velocities from numpy (u, v), in both packages."""
    (uj, ut), (vj, vt) = (_pair(d, o) for d, o in zip(data_pair, ((1.0, 0.5), (0.5, 1.0))))
    return jg.GridVariableVector((uj, vj)), tg.GridVariableVector((ut, vt))


def _close(ours, ref, tol):
    ref_data = np.asarray(ref.data if hasattr(ref, "data") else ref)
    ours_data = (ours.data if hasattr(ours, "data") else ours).numpy()
    if hasattr(ref, "offset"):
        assert ours.offset == tuple(ref.offset)
    assert ours_data.shape == ref_data.shape
    err = np.abs(ours_data - ref_data).max()
    assert err <= tol * np.abs(ref_data).max(), err / np.abs(ref_data).max()


# ----------------------------------------------------------- tensor_utils --

def test_tensor_utils_match():
    rng = np.random.default_rng(0)
    a, b, c = (rng.standard_normal((3, 4, 5)) for _ in range(3))
    tree_j = (jnp.asarray(a), [jnp.asarray(b), jnp.asarray(c)])
    tree_t = (torch.from_numpy(a), [torch.from_numpy(b), torch.from_numpy(c)])

    def same(x, y):
        assert type(x) is type(y) or isinstance(y, torch.Tensor)
        if isinstance(y, (tuple, list)):
            assert len(x) == len(y)
            for xi, yi in zip(x, y):
                same(xi, yi)
        else:
            np.testing.assert_array_equal(y.numpy(), np.asarray(x))

    for axis, idx in ((0, 1), (1, slice(1, 3)), (-1, 2), (-2, slice(None, None, 2))):
        same(jtu.slice_along_axis(tree_j, axis, idx), ttu.slice_along_axis(tree_t, axis, idx))
    for split in (1, 3):
        for got, want in zip(ttu.split_along_axis(tree_t, split, 1),
                             jtu.split_along_axis(tree_j, split, 1)):
            same(want, got)
    for keep in (False, True):
        got, want = ttu.split_axis(tree_t, 0, keep), jtu.split_axis(tree_j, 0, keep)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            same(w, g)


def test_tensor_utils_refusals():
    mixed = (torch.zeros(2, 3), torch.zeros(2))
    with pytest.raises(ValueError, match="same ndims"):
        ttu.slice_along_axis(mixed, 0, 1)
    assert ttu.slice_along_axis(mixed, 0, 1, expect_same_dims=False)[1].shape == ()
    with pytest.raises(ValueError, match="equal sized axis"):
        ttu.split_axis((torch.zeros(2, 3), torch.zeros(3, 3)), 0)
    with pytest.raises(ValueError, match="no array leaves"):
        ttu.split_axis((), 0)


# ---------------------------------------------------------- interpolation --

def _scalar_and_velocity(seed=0, batch=()):
    c = _smooth(batch + (N, N), seed)
    u = _smooth(batch + (N, N), seed + 1) * 2.0
    v = _smooth(batch + (N, N), seed + 2) * 2.0
    return _pair(c, (0.5, 0.5)), _velocity((u, v))


@pytest.mark.parametrize("scheme", ["linear", "upwind", "lax_wendroff", "tvd_lax_wendroff"])
@pytest.mark.parametrize("target", [(1.0, 0.5), (0.5, 1.0)])
def test_interpolation_schemes(scheme, target):
    (cj, ct), (vj, vt) = _scalar_and_velocity()
    fj = getattr(jinterp, scheme, None) or jinterp.apply_tvd_limiter(jinterp.lax_wendroff)
    ft = getattr(tinterp, scheme, None) or tinterp.apply_tvd_limiter(tinterp.lax_wendroff)
    got, want = ft(ct, target, vt, 1e-2), fj(cj, target, vj, 1e-2)
    _close(got, want, 2 * ULP)
    assert got.bc == tb.periodic_boundary_conditions(2)


def test_interpolation_refusals():
    (_, ct), (_, vt) = _scalar_and_velocity()
    with pytest.raises(ValueError, match="differ at most in one entry"):
        tinterp.upwind(ct, (1.0, 1.0), vt)
    tvd = tinterp.apply_tvd_limiter(tinterp.lax_wendroff)
    with pytest.raises(NotImplementedError, match="control volume faces"):
        tvd(ct, (1.5, 0.5), vt, 1e-2)
    assert tinterp.upwind(ct, (0.5, 0.5), vt) is ct


def test_limiters_and_safe_div():
    r = np.array([-2.0, -1.0, 0.0, 1e-300, 0.5, 1.0, 3.0, np.inf])
    np.testing.assert_array_equal(tinterp.van_leer_limiter(torch.from_numpy(r)).numpy(),
                                  np.asarray(jinterp.van_leer_limiter(jnp.asarray(r))))
    x, y = np.array([1.0, 2.0, -3.0]), np.array([0.0, 4.0, 0.0])
    for default in (1, 2.0):
        np.testing.assert_array_equal(
            tinterp.safe_div(torch.from_numpy(x), torch.from_numpy(y), default).numpy(),
            np.asarray(jinterp.safe_div(jnp.asarray(x), jnp.asarray(y), default)))


# -------------------------------------------------------------- advection --

ADVECT = ["advect_linear", "advect_upwind", "advect_van_leer_using_limiters",
          "advect_van_leer"]


@pytest.mark.parametrize("name", ADVECT)
def test_advect(name):
    (cj, ct), (vj, vt) = _scalar_and_velocity(seed=3)
    got, want = getattr(tfvm, name)(ct, vt, 1e-2), getattr(jfvm, name)(cj, vj, 1e-2)
    _close(got, want, 8 * ULP)


@pytest.mark.parametrize("name", ADVECT)
def test_advect_batched_is_samplewise(name):
    """A batch advects as its samples do alone."""
    (_, ct), (_, vt) = _scalar_and_velocity(seed=4, batch=(3,))
    got = getattr(tfvm, name)(ct, vt, 1e-2)
    for i in range(3):
        ci = _variable(TORCH, ct.grid, ct.data[i], ct.offset)
        vi = tg.GridVariableVector(tuple(_variable(TORCH, u.grid, u.data[i], u.offset)
                                         for u in vt))
        assert torch.equal(getattr(tfvm, name)(ci, vi, 1e-2).data, got.data[i])


def test_convect_and_diffuse():
    (_, _), (vj, vt) = _scalar_and_velocity(seed=5)
    for g, w in zip(tfvm.convect(vt, 1e-2), jfvm.convect(vj, 1e-2)):
        _close(g, w, 8 * ULP)
    for g, w in zip(tfvm.diffuse_velocity(vt, 1e-3), jfvm.diffuse_velocity(vj, 1e-3)):
        _close(g, w, 8 * ULP)


def test_advect_refuses_walls():
    gt = _grids()[1]
    c = tg.GridVariable(tg.GridArray(torch.zeros(N, N), (0.5, 0.5), gt),
                        tb.dirichlet_boundary_conditions(2))
    (_, _), (_, vt) = _scalar_and_velocity()
    with pytest.raises(NotImplementedError):
        tfvm.advect_linear(c, vt)
    with pytest.raises(NotImplementedError):
        tfvm.advect_van_leer(c, vt, 1e-2)


# ---------------------------------------------------- steppers and solver --

def _equation(module, grid, dtype, method="classic_rk4", forced=False):
    mod = jfvm if module == "jax" else tfvm
    fmod = jforcings if module == "jax" else tforcings
    kw = {}
    if forced:
        kw = dict(drag=0.1, forcing=fmod.KolmogorovForcing(
            grid=grid, diam=DIAM, wave_number=3, offsets=((1.0, 0.5), (0.5, 1.0))))
    return mod.NavierStokes2DFVMProjection(
        viscosity=1e-3, grid=grid, dtype=dtype,
        solver=mod.RKStepper.from_method(method), **kw)


def _initial_velocity(b, seed=6):
    """Divergent smooth velocities (b, N, N): the first projection fixes it."""
    return (_smooth((b, N, N), seed) * 3.0, _smooth((b, N, N), seed + 1) * 3.0)


@pytest.mark.parametrize("method", ["forward_euler", "midpoint", "heun_rk2", "classic_rk4"])
def test_rk_stepper_one_step(method):
    gj, gt = _grids()
    u, v = _initial_velocity(1)
    (vj, vt) = _velocity((u[0], v[0]))
    got = _equation("torch", gt, torch.float64, method)(vt, 1e-2)
    want = jax.jit(lambda x: _equation("jax", gj, jnp.float64, method)(x, 1e-2))(vj)
    for g, w in zip(got, want):
        _close(g, w, 1e-12)


def test_rk_stepper_tableau_checks():
    with pytest.raises(ValueError, match="Unknown RK method"):
        tfvm.RKStepper.from_method("rk45")
    with pytest.raises(ValueError, match="Inconsistent Butcher tableau"):
        tfvm.RKStepper(tableau={"a": [[1.0]], "b": [1.0]})
    assert tfvm.RKStepper().method == "forward_euler"
    assert tfvm._METHOD_MAP == jfvm._METHOD_MAP


@pytest.mark.parametrize("forced", [False, True])
def test_navier_stokes_fvm_ten_steps_batched(forced):
    """b=4 at 32² over 10 classic-RK4 steps, against JAX sample by sample."""
    gj, gt = _grids()
    u, v = _initial_velocity(4)
    _, vt = _velocity((u, v))
    eq_t = _equation("torch", gt, torch.float64, forced=forced)
    for _ in range(10):
        vt = eq_t(vt, 1e-2)
    eq_j = _equation("jax", gj, jnp.float64, forced=forced)
    step = jax.jit(lambda x: eq_j(x, 1e-2))
    for i in range(4):
        vj, _ = _velocity((u[i], v[i]))
        for _ in range(10):
            vj = step(vj)
        for g, w in zip(vt, vj):
            assert g.offset == tuple(w.offset)
            err = np.abs(g.data[i].numpy() - np.asarray(w.data)).max()
            assert err <= 1e-11 * np.abs(np.asarray(w.data)).max()
    assert float(tfdm.divergence(vt).data.abs().max()) < 1e-12


def test_taylor_green_decay():
    """TG vortex u = sin x cos y e^{-2νt} is an exact NSE solution."""
    nu, n = 1e-2, 128
    gt = tg.Grid((n, n), domain=((0, DIAM), (0, DIAM)))
    xs = gt.mesh(offset=gt.cell_faces[0], dtype=torch.float64)
    ys = gt.mesh(offset=gt.cell_faces[1], dtype=torch.float64)
    u0 = torch.sin(xs[0]) * torch.cos(xs[1])
    v0 = -torch.cos(ys[0]) * torch.sin(ys[1])
    bc = tb.periodic_boundary_conditions(2)
    v = tg.GridVariableVector(tuple(tg.GridVariable(tg.GridArray(d, o, gt), bc)
                                    for d, o in zip((u0, v0), gt.cell_faces)))
    eqn = tfvm.NavierStokes2DFVMProjection(
        viscosity=nu, grid=gt, dtype=torch.float64,
        solver=tfvm.RKStepper.from_method("classic_rk4"))
    dt, steps = 1e-3, 100
    for _ in range(steps):
        v = eqn(v, dt)
    decay = math.exp(-2 * nu * dt * steps)
    np.testing.assert_allclose(v[0].data.numpy(), (u0 * decay).numpy(), atol=2e-4)
    np.testing.assert_allclose(v[1].data.numpy(), (v0 * decay).numpy(), atol=2e-4)


def test_advection_translates_correct_direction():
    """A blob advected by u > 0 moves right: -dc/dx to rel-L2 0.1."""
    gt = tg.Grid((64, 64), domain=((0, DIAM), (0, DIAM)))
    x, y = gt.mesh(dtype=torch.float64)
    bc = tb.periodic_boundary_conditions(2)
    c = tg.GridVariable(tg.GridArray(
        torch.exp(-((x - math.pi) ** 2 + (y - math.pi) ** 2) * 4), (0.5, 0.5), gt), bc)
    v = tg.GridVariableVector(tuple(
        tg.GridVariable(tg.GridArray(d, o, gt), bc)
        for d, o in zip((torch.ones_like(x), torch.zeros_like(x)), gt.cell_faces)))
    dcdt = tfvm.advect_van_leer_using_limiters(c, v, dt=1e-3)
    kx, _ = gt.rfft_mesh(dtype=torch.float64)
    dcdx = torch.fft.irfft2(2j * math.pi * kx * torch.fft.rfft2(c.data), s=gt.shape)
    rel_l2 = float(torch.linalg.vector_norm(dcdt.data + dcdx) / torch.linalg.vector_norm(dcdx))
    assert rel_l2 < 0.1, rel_l2


@pytest.mark.parametrize("name", ADVECT)
def test_advection_conserves_mean(name):
    (_, ct), _ = _scalar_and_velocity(seed=7)
    gt = ct.grid
    bc = tb.periodic_boundary_conditions(2)
    v = tg.GridVariableVector(tuple(
        tg.GridVariable(tg.GridArray(torch.full((N, N), s, dtype=torch.float64), o, gt), bc)
        for s, o in zip((1.0, 0.5), gt.cell_faces)))
    assert abs(float(getattr(tfvm, name)(ct, v, 1e-3).data.mean())) < 1e-12

"""The port's grids, boundaries and FVM pieces against the JAX package.

Shared numpy inputs in fp64 go through both packages. Grid arithmetic,
vectors and each boundary condition's ``shift``, ``pad``, ``trim`` and
``impose_bc`` are exact; every function of ``finite_differences`` holds to
1e-12 of the largest magnitude; each ``fast_diagonalization``
implementation to 1e-10 of JAX's and ``rfft`` to 1e-8 of ``matmul``
(``tests/test_fvm.py``); the pressure projection, periodic and with walls,
to 1e-12 of JAX's, with a divergence below 1e-12.
"""

import operator

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_cfd import boundaries as jb, grids as jg
from tpu_cfd.ops import fast_diagonalization as jfd, finite_differences as jfdm
from tpu_cfd.solvers import pressure as jpressure
from tpu_cfd_torch import boundaries as tb, grids as tg
from tpu_cfd_torch.ops import fast_diagonalization as tfd, finite_differences as tfdm
from tpu_cfd_torch.solvers import pressure as tpressure

torch.set_num_threads(2)

N = 16
DOMAIN = ((0, 1.0), (0, 2.0))


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape)


def _grids(shape=(N, N), domain=DOMAIN):
    return jg.Grid(shape, domain=domain), tg.Grid(shape, domain=domain)


# each BC type in both packages: (name, JAX bc, port bc)
def _bcs(ndim=2):
    pairs = {
        "periodic": lambda m: m.periodic_boundary_conditions(ndim),
        "dirichlet": lambda m: m.dirichlet_boundary_conditions(ndim, ((1.5, -0.5), (0.25, 2.0))),
        "dirichlet0": lambda m: m.dirichlet_boundary_conditions(ndim),
        "neumann": lambda m: m.neumann_boundary_conditions(ndim, ((2.0, -1.0), (0.5, 0.75))),
        "neumann0": lambda m: m.neumann_boundary_conditions(ndim),
        "channel": lambda m: m.channel_flow_boundary_conditions(ndim, ((0.5, -0.5),)),
        "channel0": lambda m: m.channel_flow_boundary_conditions(ndim),
    }
    return {k: (f(jb), f(tb)) for k, f in pairs.items()}


BCS = _bcs()


def _equal(ours, ref, rtol=0.0):
    """Exact agreement of a port GridArray/Variable with a JAX one."""
    assert ours.offset == tuple(ref.offset)
    if rtol:
        np.testing.assert_allclose(ours.data.numpy(), np.asarray(ref.data), rtol=rtol, atol=0)
    else:
        np.testing.assert_array_equal(ours.data.numpy(), np.asarray(ref.data))


def _close(ours, ref, tol=1e-12):
    ref_data = np.asarray(ref.data if hasattr(ref, "data") else ref)
    ours_data = (ours.data if hasattr(ours, "data") else ours).numpy()
    if hasattr(ref, "offset"):
        assert ours.offset == tuple(ref.offset)
    assert ours_data.shape == ref_data.shape
    np.testing.assert_allclose(ours_data, ref_data, rtol=0,
                               atol=tol * max(np.abs(ref_data).max(), 1.0))


# ---------------------------------------------------------------- grids


@pytest.mark.parametrize("op", [operator.add, operator.sub, operator.mul,
                                operator.truediv, operator.pow])
def test_grid_array_and_variable_arithmetic_match_jax(op):
    """Exact, but for a division and a power: XLA's may round one ulp away
    from IEEE division (it computes x/c as x·(1/c), for one) and from
    ``torch.pow``."""
    g_j, g_t = _grids()
    ulp = 2.0**-52 if op in (operator.truediv, operator.pow) else 0.0
    a, b = _rand((2, N, N), 1), np.abs(_rand((2, N, N), 2)) + 0.5
    off = (0.5, 1.0)
    ja, jb_ = jg.GridArray(jnp.asarray(a), off, g_j), jg.GridArray(jnp.asarray(b), off, g_j)
    ta, tb_ = tg.GridArray(torch.from_numpy(a), off, g_t), tg.GridArray(torch.from_numpy(b), off, g_t)
    _equal(op(tb_, ta if op is not operator.pow else 2.0),
           op(jb_, ja if op is not operator.pow else 2.0), ulp)
    if op is not operator.pow:  # neither package defines __rpow__
        _equal(op(2.5, tb_), op(2.5, jb_), ulp)
    _equal(op(tb_, 3.0), op(jb_, 3.0), ulp)
    bc_j, bc_t = BCS["periodic"]
    jv, tv = jg.GridVariable(jb_, bc_j), tg.GridVariable(tb_, bc_t)
    jw, tw = jg.GridVariable(ja, bc_j), tg.GridVariable(ta, bc_t)
    out = op(tv, tw if op is not operator.pow else 2.0)
    assert isinstance(out, tg.GridVariable) and out.bc == bc_t
    _equal(out, op(jv, jw if op is not operator.pow else 2.0), ulp)
    if op is not operator.pow:
        _equal(op(1.5, tv), op(1.5, jv), ulp)


def test_grid_arithmetic_checks_and_unary_ops():
    g_j, g_t = _grids()
    a = _rand((N, N))
    ta = tg.GridArray(torch.from_numpy(a), (0.5, 0.5), g_t)
    ja = jg.GridArray(jnp.asarray(a), (0.5, 0.5), g_j)
    _equal(-ta, -ja)
    _equal(abs(ta), abs(ja))
    assert ta == tg.GridArray(torch.from_numpy(a.copy()), (0.5, 0.5), g_t)
    assert ta.astype(torch.float32).dtype == torch.float32
    assert ta.shape == (N, N) and ta.ndim == 2
    with pytest.raises(ValueError, match="offsets do not match"):
        ta + tg.GridArray(torch.from_numpy(a), (1.0, 0.5), g_t)
    with pytest.raises(ValueError, match="grids do not match"):
        ta + tg.GridArray(torch.from_numpy(a), (0.5, 0.5), tg.Grid((N, N)))
    bc_t = BCS["periodic"][1]
    tv = tg.GridVariable(ta, bc_t)
    with pytest.raises(ValueError, match="boundary conditions do not match"):
        tv + tg.GridVariable(ta, BCS["dirichlet0"][1])
    _equal(-tv, -jg.GridVariable(ja, BCS["periodic"][0]))
    with pytest.raises(ValueError):
        tg.GridVariable(ta, tb.periodic_boundary_conditions(1))


def test_grid_vectors_match_jax():
    g_j, g_t = _grids()
    data = [_rand((3, N, N), s) for s in (3, 4)]
    offs = g_t.cell_faces
    ja = jg.GridArrayVector(jg.GridArray(jnp.asarray(d), o, g_j) for d, o in zip(data, offs))
    ta = tg.GridArrayVector(tg.GridArray(torch.from_numpy(d), o, g_t) for d, o in zip(data, offs))
    for f in (lambda v: v + v, lambda v: v - 2.0 * v, lambda v: v * v, lambda v: v / 3.0,
              lambda v: -v, lambda v: 1.0 - v, lambda v: v * 2.0):
        out = f(ta)
        assert isinstance(out, tg.GridArrayVector)
        for o, r in zip(out, f(ja)):
            _equal(o, r)
    bc_j, bc_t = BCS["periodic"]
    jv = jg.GridVariableVector(jg.GridVariable(a, bc_j) for a in ja)
    tv = tg.GridVariableVector(tg.GridVariable(a, bc_t) for a in ta)
    for f in (lambda v: v + v - v, lambda v: 2.0 * v / 4.0, lambda v: -v):
        out = f(tv)
        assert isinstance(out, tg.GridVariableVector)
        for o, r in zip(out, f(jv)):
            _equal(o, r)
    assert isinstance(tv.arrays, tg.GridArrayVector) and tv.dtype == torch.float64
    with pytest.raises(TypeError):
        tg.GridArrayVector([torch.ones(4)])
    with pytest.raises(TypeError):
        tg.GridVariableVector([ta[0]])
    with pytest.raises(ValueError, match="lengths"):
        ta + tg.GridArrayVector([ta[0]])


def test_grid_helpers_match_jax():
    g_j, g_t = _grids()
    a = _rand((N, N))
    ja = jg.GridArray(jnp.asarray(a), (0.5, 0.5), g_j)
    ta = tg.GridArray(torch.from_numpy(a), (0.5, 0.5), g_t)
    _equal(tg.applied(torch.abs)(ta), jg.applied(jnp.abs)(ja))
    _equal(tg.where(ta, ta, 0.0), jg.where(ja, ja, 0.0))
    _equal(tg.where(ta.data > 0, ta, -1.0), jg.where(ja.data > 0, ja, -1.0))
    tb_ = tg.GridArray(torch.from_numpy(a), (1.0, 0.5), g_t)
    jb_ = jg.GridArray(jnp.asarray(a), (1.0, 0.5), g_j)
    assert tg.averaged_offset_arrays(ta, tb_) == jg.averaged_offset_arrays(ja, jb_)
    assert tg.control_volume_offsets(tb_) == jg.control_volume_offsets(jb_)
    assert tg.consistent_offset_arrays(ta, ta) == (0.5, 0.5)
    with pytest.raises(ValueError, match="unique offset"):
        tg.applied(torch.add)(ta, tb_)
    assert tg.consistent_grid_arrays(ta, tb_) == g_t
    assert tg.consistent_grid(g_t, ta, tb_) == (ta, tb_)
    with pytest.raises(ValueError):
        tg.consistent_grid(tg.Grid((N, N)), ta)


@pytest.mark.parametrize("bc_name", ["periodic", "dirichlet", "channel"])
@pytest.mark.parametrize("offset", [(1.0, 0.5), (0.5, 1.0), (0.0, 0.0)])
def test_interior_and_enforce_edge_bc_match_jax(bc_name, offset):
    g_j, g_t = _grids()
    bc_j, bc_t = BCS[bc_name]
    a = _rand((2, N, N), 5)
    jv = jg.GridVariable(jg.GridArray(jnp.asarray(a), offset, g_j), bc_j)
    tv = tg.GridVariable(tg.GridArray(torch.from_numpy(a), offset, g_t), bc_t)
    ours, ref = tv.interior(), jv.interior()
    _equal(ours, ref)
    assert ours.grid.shape == ref.grid.shape and ours.grid.domain == ref.grid.domain
    _equal(tv.enforce_edge_bc(torch.float64), jv.enforce_edge_bc(jnp.float64))
    np.testing.assert_array_equal(tv.data.numpy(), a)  # not written in place


# ---------------------------------------------------------------- boundaries


@pytest.mark.parametrize("bc_name", sorted(BCS))
@pytest.mark.parametrize("offset", [(0.5, 0.5), (1.0, 0.5), (0.5, 1.0), (0.0, 0.5)])
def test_shift_pad_trim_impose_match_jax(bc_name, offset):
    g_j, g_t = _grids()
    bc_j, bc_t = BCS[bc_name]
    a = _rand((3, N, N), 6)
    ja = jg.GridArray(jnp.asarray(a), offset, g_j)
    ta = tg.GridArray(torch.from_numpy(a), offset, g_t)
    for dim in (0, 1):
        periodic = bc_t.types[dim][0] == "periodic"
        neumann_edge = "neumann" in bc_t.types[dim] and offset[dim] % 1 == 0
        widths = (-2, -1, 1, 2) if periodic else (-1, 1)
        for w in widths:
            if neumann_edge:
                continue
            _equal(bc_t.shift(ta, w, dim), bc_j.shift(ja, w, dim))
            _equal(tg.GridVariable(ta, bc_t).shift(w, dim),
                   jg.GridVariable(ja, bc_j).shift(w, dim))
            padded_t, padded_j = bc_t.pad(ta, w, dim), bc_j.pad(ja, w, dim)
            _equal(padded_t, padded_j)
            _equal(bc_t.trim(padded_t, -w, dim), bc_j.trim(padded_j, -w, dim))
        if not periodic and not neumann_edge:
            with pytest.raises(ValueError, match="Padding past 1 ghost cell"):
                bc_t.pad(ta, 2, dim)
            for mode in (tb.Padding.MIRROR, tb.Padding.EXTEND):
                _equal(bc_t.pad(ta, -1, dim, mode=mode), bc_j.pad(ja, -1, dim, mode=mode))
    if any("neumann" in t for t in bc_t.types) and any(o % 1 == 0 for o in offset):
        with pytest.raises(NotImplementedError):
            bc_t.impose_bc(ta)
        return
    ours, ref = bc_t.impose_bc(ta), bc_j.impose_bc(ja)
    assert isinstance(ours, tg.GridVariable) and ours.bc == bc_t
    _equal(ours, ref)
    _equal(bc_t.trim_boundary(ta), bc_j.trim_boundary(ja))


def test_bc_values_and_records_match_jax():
    g_j, g_t = _grids()
    for name, (bc_j, bc_t) in BCS.items():
        assert bc_t.types == bc_j.types and bc_t.bc_values == bc_j.bc_values, name
        assert isinstance(bc_t, tb.HomogeneousBoundaryConditions) == isinstance(
            bc_j, jb.HomogeneousBoundaryConditions)
        for dim in (0, 1):
            for o, r in zip(bc_t.values(dim, g_t, torch.float64),
                            bc_j.values(dim, g_j, jnp.float64)):
                assert (o is None) == (r is None)
                if o is not None:
                    np.testing.assert_array_equal(o.numpy(), np.asarray(r))
            assert (tb.is_bc_periodic_boundary_conditions(bc_t, dim)
                    == jb.is_bc_periodic_boundary_conditions(bc_j, dim))
    assert hash(BCS["periodic"][1]) == hash(tb.periodic_boundary_conditions(2))
    with pytest.raises(ValueError, match="same on both sides"):
        tb.is_bc_periodic_boundary_conditions(
            tb.ConstantBoundaryConditions((("periodic", "dirichlet"),), ((None, 0.0),)), 0)


@pytest.mark.parametrize("bc_name", ["periodic", "dirichlet0", "channel0", "neumann0"])
def test_bc_inference_matches_jax(bc_name):
    g_j, g_t = _grids()
    bc_j, bc_t = BCS[bc_name]
    z = np.zeros((N, N))
    jv = jg.GridVariableVector(jg.GridVariable(jg.GridArray(jnp.asarray(z), o, g_j), bc_j)
                               for o in g_j.cell_faces)
    tv = tg.GridVariableVector(tg.GridVariable(tg.GridArray(torch.from_numpy(z), o, g_t), bc_t)
                               for o in g_t.cell_faces)
    assert tb.consistent_boundary_conditions(*tv) == jb.consistent_boundary_conditions(*jv)
    assert tb.get_pressure_bc_from_velocity(tv).types == jb.get_pressure_bc_from_velocity(jv).types
    assert (tb.get_pressure_bc_from_velocity_bc([bc_t, bc_t]).types
            == jb.get_pressure_bc_from_velocity_bc([bc_j, bc_j]).types)
    assert tb.has_all_periodic_boundary_conditions(*tv) == jb.has_all_periodic_boundary_conditions(*jv)
    assert tb.is_periodic_boundary_conditions(tv[0], 0) == jb.is_periodic_boundary_conditions(jv[0], 0)
    c_bc_j, c_bc_t = BCS["neumann0" if bc_name == "neumann0" else "periodic"]
    if bc_name == "channel0":
        c_bc_j, c_bc_t = bc_j, bc_t
    jc = jg.GridVariable(jg.GridArray(jnp.asarray(z), (0.5, 0.5), g_j), c_bc_j)
    tc = tg.GridVariable(tg.GridArray(torch.from_numpy(z), (0.5, 0.5), g_t), c_bc_t)
    for direction in (0, 1):
        try:
            ref = jb.get_advection_flux_bc_from_velocity_and_scalar(jv[direction], jc, direction)
        except (NotImplementedError, ValueError) as e:
            with pytest.raises(type(e)):
                tb.get_advection_flux_bc_from_velocity_and_scalar(tv[direction], tc, direction)
            continue
        ours = tb.get_advection_flux_bc_from_velocity_and_scalar(tv[direction], tc, direction)
        assert (ours.types, ours.bc_values) == (ref.types, ref.bc_values)
    with pytest.raises(NotImplementedError):
        tb.get_pressure_bc_from_velocity_bc([BCS["dirichlet"][1]])


# ---------------------------------------------------------------- finite differences


def _variables(bc_name, offset, seed=7, batch=(2,)):
    g_j, g_t = _grids()
    bc_j, bc_t = BCS[bc_name]
    a = _rand((*batch, N, N), seed)
    return (jg.GridVariable(jg.GridArray(jnp.asarray(a), offset, g_j), bc_j),
            tg.GridVariable(tg.GridArray(torch.from_numpy(a), offset, g_t), bc_t))


@pytest.mark.parametrize("bc_name", ["periodic", "dirichlet", "channel"])
@pytest.mark.parametrize("fn", ["forward_difference", "central_difference",
                                "backward_difference", "laplacian", "gradient_tensor"])
def test_stencils_match_jax(bc_name, fn):
    for offset in ((0.5, 0.5), (1.0, 0.5), (0.5, 1.0)):
        jv, tv = _variables(bc_name, offset)
        ref, ours = getattr(jfdm, fn)(jv), getattr(tfdm, fn)(tv)
        if fn == "laplacian":
            _close(ours, ref)
            continue
        ref, ours = np.ravel(np.asarray(ref, dtype=object)), np.ravel(np.asarray(ours, dtype=object))
        assert len(ours) == len(ref)
        for o, r in zip(ours, ref):
            _close(o, r)
        if fn != "gradient_tensor":
            for axis in (0, 1):
                _close(getattr(tfdm, fn)(tv, axis), getattr(jfdm, fn)(jv, axis))


@pytest.mark.parametrize("bc_name", ["periodic", "dirichlet", "channel0"])
def test_divergence_curl_and_stencil_sum_match_jax(bc_name):
    pairs = [_variables(bc_name, o, seed=s) for o, s in zip(((1.0, 0.5), (0.5, 1.0)), (8, 9))]
    jv = jg.GridVariableVector(p[0] for p in pairs)
    tv = tg.GridVariableVector(p[1] for p in pairs)
    _close(tfdm.divergence(tv), jfdm.divergence(jv))
    centred = [_variables(bc_name, (0.5, 0.5), seed=s) for s in (8, 9)]
    _close(tfdm.centered_divergence(tg.GridVariableVector(p[1] for p in centred)),
           jfdm.centered_divergence(jg.GridVariableVector(p[0] for p in centred)))
    _close(tfdm.curl_2d(tv), jfdm.curl_2d(jv))
    assert tfdm.curl_2d(tv).offset == (1.0, 1.0)
    _close(tfdm.stencil_sum(tv[0].array, tv[0].shift(1, 1)),
           jfdm.stencil_sum(jv[0].array, jv[0].shift(1, 1)))
    with pytest.raises(ValueError, match="must be equal to `grid.ndim`"):
        tfdm.divergence(tv[:1])
    with pytest.raises(ValueError, match="not 2"):
        tfdm.curl_2d(tv[:1])


@pytest.mark.parametrize("bc_name", ["periodic", "dirichlet0", "neumann0", "channel0"])
@pytest.mark.parametrize("offset", [(0.5, 0.5), (1.0, 0.5), (0.0, 0.0)])
def test_laplacian_matrices_match_jax(bc_name, offset):
    g_j, g_t = _grids((N, N + 4))
    bc_j, bc_t = BCS[bc_name]
    try:
        ref = jfdm.laplacian_matrix_w_boundaries(g_j, offset, bc_j)
    except NotImplementedError:
        with pytest.raises(NotImplementedError):
            tfdm.laplacian_matrix_w_boundaries(g_t, offset, bc_t)
        return
    ours = tfdm.laplacian_matrix_w_boundaries(g_t, offset, bc_t)
    for o, r in zip(ours, ref):
        assert o.dtype == np.float64
        np.testing.assert_allclose(o, np.asarray(r), rtol=1e-12, atol=0)
    if offset == (0.5, 0.5):
        for o, r in zip(tfdm.set_laplacian_matrix(g_t, bc_t), jfdm.set_laplacian_matrix(g_j, bc_j)):
            np.testing.assert_allclose(o, np.asarray(r), rtol=1e-12, atol=0)
    np.testing.assert_allclose(tfdm.laplacian_matrix(N, 0.3),
                               np.asarray(jfdm.laplacian_matrix(N, 0.3)), rtol=1e-12)


# ---------------------------------------------------------------- fast diagonalization


@pytest.mark.parametrize("impl", ["rfft", "fft", "matmul"])
@pytest.mark.parametrize("shape", [(N, N), (N, N + 4), (3, N, N)])
def test_fast_diagonalization_matches_jax(impl, shape):
    steps = (0.1, 0.07)
    ops = [jfdm.laplacian_matrix(n, s) for n, s in zip(shape[-2:], steps)]
    rhs = _rand(shape, 10)
    ref = jfd.pseudoinverse_transform(ops, jnp.float64, hermitian=True, circulant=True,
                                      implementation=impl)(jnp.asarray(rhs))
    ours = tfd.pseudoinverse_transform([tfdm.laplacian_matrix(n, s) for n, s in
                                        zip(shape[-2:], steps)], torch.float64,
                                       hermitian=True, circulant=True,
                                       implementation=impl)(torch.from_numpy(rhs))
    assert ours.dtype == torch.float64 and tuple(ours.shape) == shape
    _close(ours, ref, 1e-10)
    np.testing.assert_allclose(
        tfd.pseudoinverse(torch.from_numpy(rhs), [np.asarray(o) for o in ops], np.float64,
                          hermitian=True, circulant=True, implementation=impl).numpy(),
        ours.numpy(), rtol=0, atol=1e-14 * np.abs(ours.numpy()).max())
    exp = lambda e: np.exp(1e-3 * e)  # noqa: E731  a general func, not an inverse
    _close(tfd.transform(exp, [np.asarray(o) for o in ops], torch.float64, hermitian=True,
                         circulant=True, implementation=impl)(torch.from_numpy(rhs)),
           jfd.transform(exp, ops, jnp.float64, hermitian=True, circulant=True,
                         implementation=impl)(jnp.asarray(rhs)), 1e-10)


def test_fast_diagonalization_rfft_agrees_with_matmul_and_checks():
    ops = [tfdm.laplacian_matrix(32, 0.1) for _ in range(2)]
    rhs = torch.from_numpy(_rand((32, 32), 0))
    rhs = rhs - rhs.mean()
    outs = {}
    for impl in ("rfft", "matmul"):
        out = tfd.pseudoinverse_transform(ops, torch.float64, hermitian=True, circulant=True,
                                          implementation=impl)(rhs)
        outs[impl] = (out - out.mean()).numpy()
    np.testing.assert_allclose(outs["rfft"], outs["matmul"], atol=1e-8)
    # an odd last axis falls back to matmul, as in JAX
    odd = [tfdm.laplacian_matrix(9, 0.1)] * 2
    r = torch.from_numpy(_rand((9, 9), 1))
    np.testing.assert_allclose(
        tfd.pseudoinverse_transform(odd, torch.float64, hermitian=True, circulant=True)(r).numpy(),
        np.asarray(jfd.pseudoinverse_transform([jnp.asarray(o) for o in odd], jnp.float64,
                                               hermitian=True, circulant=True)(jnp.asarray(r.numpy()))),
        atol=1e-10)
    with pytest.raises(ValueError, match="square"):
        tfd.transform(np.abs, [np.ones((3, 4))], torch.float64)
    with pytest.raises(ValueError, match="non-hermitian"):
        tfd.transform(np.abs, ops, torch.float64, implementation="matmul")
    with pytest.raises(ValueError, match="non-circulant"):
        tfd.transform(np.abs, ops, torch.float64, implementation="fft")
    with pytest.raises(ValueError, match="invalid implementation"):
        tfd.transform(np.abs, ops, torch.float64, circulant=True, implementation="dct")
    out = tfd.outer_sum([np.array([1.0, 2.0]), np.array([10.0, 20.0, 30.0])])
    np.testing.assert_array_equal(out, np.asarray(jfd.outer_sum([jnp.array([1.0, 2.0]),
                                                                jnp.array([10.0, 20.0, 30.0])])))
    d = np.array([1 + 1e-14j, 2.0 + 0j])
    assert tfd._narrow_diagonals(d, torch.float32).dtype == np.float32
    assert np.asarray(jfd._narrow_diagonals(d, jnp.float32)).dtype == np.float32


# ---------------------------------------------------------------- pressure


@pytest.mark.parametrize("bc_name", ["periodic", "dirichlet0", "channel0"])
@pytest.mark.parametrize("batch", [(), (3,)])
def test_pressure_projection_matches_jax(bc_name, batch):
    g_j, g_t = _grids()
    bc_j, bc_t = BCS[bc_name]
    data = [_rand((*batch, N, N), s) for s in (11, 12)]
    jv = jg.GridVariableVector(bc_j.impose_bc(jg.GridArray(jnp.asarray(d), o, g_j))
                               for d, o in zip(data, g_j.cell_faces))
    tv = tg.GridVariableVector(bc_t.impose_bc(tg.GridArray(torch.from_numpy(d), o, g_t))
                               for d, o in zip(data, g_t.cell_faces))
    pbc_j, pbc_t = jb.get_pressure_bc_from_velocity(jv), tb.get_pressure_bc_from_velocity(tv)
    proj_j = jpressure.PressureProjection(g_j, pbc_j, dtype=jnp.float64)
    proj_t = tpressure.PressureProjection(g_t, pbc_t, dtype=torch.float64)
    assert proj_t.solver.implementation == proj_j.solver.implementation
    # the JAX package projects one sample at a time
    refs = [proj_j(jg.GridVariableVector(jg.GridVariable(jg.GridArray(u.data[i], u.offset, g_j),
                                                         u.bc) for u in jv))
            for i in range(batch[0])] if batch else [proj_j(jv)]
    ours = proj_t(tv)
    for c, o in enumerate(ours):
        ref = np.stack([np.asarray(r[c].data) for r in refs]) if batch else refs[0][c].data
        _close(o, ref)
        assert o.offset == g_t.cell_faces[c] and o.bc == bc_t
    assert float(tfdm.divergence(ours).data.abs().max()) < 1e-12
    _close(tpressure.projection(tv)[0], ours[0], 1e-14)
    div = tfdm.divergence(tv)
    rhs_ours = tpressure.rhs_transform(div, pbc_t)
    if batch:
        for i in range(batch[0]):
            one = jg.GridArray(jnp.asarray(div.data[i].numpy()), div.offset, g_j)
            _close(rhs_ours[i], jpressure.rhs_transform(one, pbc_j))
    else:
        _close(rhs_ours, jpressure.rhs_transform(
            jg.GridArray(jnp.asarray(div.data.numpy()), div.offset, g_j), pbc_j))


@pytest.mark.parametrize("n", [32, 64])
def test_pressure_projection_divergence_free_fp64(n):
    g = tg.Grid((n, n), domain=((0, 2 * np.pi), (0, 2 * np.pi)))
    bc = tb.periodic_boundary_conditions(2)
    v = tg.GridVariableVector(tg.GridVariable(tg.GridArray(torch.from_numpy(_rand((n, n), s)),
                                                           o, g), bc)
                              for s, o in zip((42, 43), g.cell_faces))
    proj = tpressure.PressureProjection(g, tb.get_pressure_bc_from_velocity(v),
                                        dtype=torch.float64)
    v1 = proj(v)
    assert float(tfdm.divergence(v1).data.abs().max()) < 1e-12
    for a, b in zip(proj(v1), v1):  # idempotent
        np.testing.assert_allclose(a.data.numpy(), b.data.numpy(), atol=1e-12)
    r = torch.from_numpy(_rand((n, n), 1))
    r = r - r.mean()  # the Poisson problem's solvable rhs
    ref = tpressure.Pseudoinverse(g, dtype=torch.float64)(r)
    for impl in ("fft", "matmul"):
        # the mean mode is the null space: its eigenvalue is cut in the FFT
        # routes, while eigh leaves it at roundoff, so compare mean-free parts
        # of the solutions of a mean-free rhs (tests/test_fvm.py does too)
        out = tpressure.Pseudoinverse(g, dtype=torch.float64, implementation=impl)(r)
        np.testing.assert_allclose((out - out.mean()).numpy(), (ref - ref.mean()).numpy(),
                                   rtol=0, atol=1e-8)

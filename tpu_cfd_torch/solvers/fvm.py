"""Finite-volume MAC-grid Navier-Stokes with explicit RK and pressure
projection (PyTorch).

Counterpart of ``tpu_cfd/solvers/fvm.py``. The steppers are plain
dataclasses over Butcher tableaus whose stages run in Python; every field is
a batch ``(b, *grid.shape)`` (or unbatched), and every shift, flux and
reduction acts on the grid dims only, so each sample of a batch steps as
it would alone. The pressure solve is ``solvers/pressure.py``'s (one
``torch.fft`` pair when periodic). ``rollout`` steps a batch and records its
vorticity frames.

Two routes for each part of a step. For two periodic components on the
MAC offsets of a 2-D grid, fp32 or fp64, needing no gradient
(``fvm_projection.fits_mac_kernels``), the step's field passes are
hand-written kernels on the card: an evaluation of
``NavierStokes2DFVMProjection``'s explicit terms with the default Van Leer
``convect`` is one launch of ``ops/cuda/fvm_explicit.py`` (``_kernel_takes``
decides; elsewhere ``_explicit_terms_plain``), each of ``RKStepper``'s stage
states and its result one launch of ``ops/cuda/fvm_projection.py``'s
``combine``, and a projection that module's divergence and gradient around
the cuFFT solve (``solvers/pressure.py``). On the CPU the combination and
the projection's stencils take the same wrappers, which run their plain
versions there, bit for bit the term loop and the stencils that every
other step runs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import torch

from tpu_cfd_torch import boundaries, grids
from tpu_cfd_torch.ops import finite_differences as fdm
from tpu_cfd_torch.ops import interpolation
from tpu_cfd_torch.ops.cuda import fvm_explicit, fvm_projection
from tpu_cfd_torch.solvers import forcings as forcings_mod
from tpu_cfd_torch.solvers import pressure
from tpu_cfd_torch.utils.profiling import trace_annotation

Grid = grids.Grid
GridArray = grids.GridArray
GridArrayVector = grids.GridArrayVector
GridVariable = grids.GridVariable
GridVariableVector = grids.GridVariableVector
InterpolationFn = interpolation.InterpolationFn
ForcingFn = forcings_mod.ForcingFn


def _advect_aligned(cs: GridVariableVector, v: GridVariableVector) -> GridArray:
    """Advection as -div(flux) for ``cs`` already on the faces of ``v``:
    flux_i = c_i·u_i under the BC inferred from the velocity and scalar."""
    if len(cs) != len(v):
        raise ValueError(
            f"one interpolated scalar per velocity face required: {len(cs)}"
            f" scalars vs {len(v)} faces"
        )
    flux_parts = []
    for axis, (c, u) in enumerate(zip(cs, v)):
        bc = boundaries.get_advection_flux_bc_from_velocity_and_scalar(u, c, axis)
        flux_parts.append(bc.impose_bc(c.array * u.array))
    return -fdm.divergence(GridVariableVector(tuple(flux_parts)))


def advect_general(
    c: GridVariable,
    v: GridVariableVector,
    u_interpolation_fn: InterpolationFn,
    c_interpolation_fn: InterpolationFn,
    dt: Optional[float] = None,
) -> GridArray:
    """Advection of the scalar ``c`` by ``v`` on the control volume of ``c``:
    each velocity component and ``c`` interpolated to the control-volume
    faces, the flux c·u with its inherited BC, and -divergence."""
    if not boundaries.has_all_periodic_boundary_conditions(c):
        raise NotImplementedError("Non-periodic boundary conditions are not implemented.")
    target_offsets = grids.control_volume_offsets(c)
    aligned_v = GridVariableVector(tuple(
        u_interpolation_fn(u, target_offset, v, dt)
        for u, target_offset in zip(v, target_offsets)))
    aligned_c = GridVariableVector(tuple(
        c_interpolation_fn(c, target_offset, aligned_v, dt)
        for target_offset in target_offsets))
    return _advect_aligned(aligned_c, aligned_v)


def advect_linear(c: GridVariable, v: GridVariableVector, dt=None) -> GridArray:
    """Advection with linear interpolation of the velocity and the scalar."""
    return advect_general(c, v, interpolation.linear, interpolation.linear, dt)


def advect_upwind(c: GridVariable, v: GridVariableVector, dt=None) -> GridArray:
    """Advection with upwind interpolation of the scalar."""
    return advect_general(c, v, interpolation.linear, interpolation.upwind, dt)


def advect_van_leer_using_limiters(c: GridVariable, v: GridVariableVector,
                                   dt: float) -> GridArray:
    """Van Leer advection: the TVD limiter applied to Lax-Wendroff."""
    c_interpolation_fn = interpolation.apply_tvd_limiter(
        interpolation.lax_wendroff, limiter=interpolation.van_leer_limiter)
    return advect_general(c, v, interpolation.linear, c_interpolation_fn, dt)


# the scheme ops/cuda/fvm_explicit.py implements (NavierStokes2DFVMProjection
# compares the module's name with it at each call)
_KERNEL_SCHEME = advect_van_leer_using_limiters


def advect_van_leer(c: GridVariable, v: GridVariableVector, dt: float) -> GridArray:
    """Direct Van Leer flux-limited advection in one flux assembly.

    Periodic BCs only: the upwind flux plus the Van Leer correction
    ``phi = num*(sign(den)+sign(num))*den/(|den|+|num|)`` on each face, then
    -div. Branchless and division-safe.
    """
    if not boundaries.has_all_periodic_boundary_conditions(c):
        raise NotImplementedError("advect_van_leer supports periodic BCs only")
    offsets = grids.control_volume_offsets(c)
    aligned_v = tuple(interpolation.linear(u, offset) for u, offset in zip(v, offsets))
    flux_bc = tuple(boundaries.get_advection_flux_bc_from_velocity_and_scalar(u, c, d)
                    for d, u in enumerate(v))
    fluxes = []
    for axis, (u, h) in enumerate(zip(aligned_v, c.grid.step)):
        c_center = c.data
        c_right = c.shift(+1, axis).data
        c_left = c.shift(-1, axis).data
        c_left_left = c.shift(-2, axis).data
        upwind = torch.where(u.data > 0, u.data * c_center, u.data * c_right)
        numerator = torch.where(u.data > 0, c_left - c_left_left, c_right - c_center)
        denominator = c_center - c_left
        safe_den = torch.where(denominator.abs() > 0,
                               denominator.abs() + numerator.abs(), 1.0)
        phi_van_leer = (numerator * (torch.sign(denominator) + torch.sign(numerator))
                        * denominator / safe_den)
        courant = (dt / h) * u.data.abs()
        flux_correction = 0.5 * (1 - courant) * u.data.abs() * phi_van_leer
        fluxes.append(GridArray(upwind + flux_correction, u.offset, c.grid))
    flux = GridVariableVector(tuple(bc.impose_bc(f) for bc, f in zip(flux_bc, fluxes)))
    return -fdm.divergence(flux)


def convect(v: GridVariableVector, dt: float) -> GridArrayVector:
    """Self-advection of each velocity component (Van Leer, limited)."""
    return GridArrayVector(tuple(advect_van_leer_using_limiters(u, v, dt) for u in v))


def diffuse(w: GridVariable, nu: float) -> GridArray:
    """Diffusion rate nu * laplacian(w)."""
    return nu * fdm.laplacian(w)


def diffuse_velocity(v: GridVariableVector, nu: float) -> GridArrayVector:
    return GridArrayVector(tuple(diffuse(u, nu) for u in v))


def wrap_field_same_bcs(v, field_ref) -> GridVariableVector:
    """The arrays of ``v`` under the BCs of ``field_ref``."""
    return GridVariableVector(tuple(GridVariable(a, w.bc) for a, w in zip(v, field_ref)))


class ProjectionExplicitODE:
    """∂u/∂t = explicit_terms(u); u ← pressure_projection(u)."""

    def explicit_terms(self, u: GridVariableVector, dt: float) -> GridVariableVector:
        raise NotImplementedError

    def pressure_projection(self, u: GridVariableVector) -> GridVariableVector:
        raise NotImplementedError


_METHOD_MAP: Dict[str, Dict[str, list]] = {
    "forward_euler": {"a": [], "b": [1.0]},
    "midpoint": {"a": [[1 / 2]], "b": [0, 1.0]},
    "heun_rk2": {"a": [[1.0]], "b": [1 / 2, 1 / 2]},
    "classic_rk4": {
        "a": [[1 / 2], [0.0, 1 / 2], [0.0, 0.0, 1.0]],
        "b": [1 / 6, 1 / 3, 1 / 3, 1 / 6],
    },
}


@dataclasses.dataclass
class RKStepper:
    """Explicit Runge-Kutta over a Butcher tableau, projecting between
    stages. Zero coefficients are skipped, so forward Euler takes one
    explicit evaluation and one projection."""

    tableau: Optional[Dict[str, list]] = None
    method: Optional[str] = None

    def __post_init__(self):
        if self.tableau is None:
            if self.method is None:
                self.method = "forward_euler"
            if self.method not in _METHOD_MAP:
                raise ValueError(f"Unknown RK method: {self.method}")
            self.tableau = _METHOD_MAP[self.method]
        a, b = self.tableau["a"], self.tableau["b"]
        if len(a) + 1 != len(b):
            raise ValueError("Inconsistent Butcher tableau: len(a) + 1 != len(b)")

    @classmethod
    def from_method(cls, method: str = "forward_euler", **kwargs) -> "RKStepper":
        return cls(method=method, **kwargs)

    def __call__(self, u0: GridVariableVector, dt: float,
                 equation: ProjectionExplicitODE) -> GridVariableVector:
        a = self.tableau["a"]
        b = self.tableau["b"]
        num_steps = len(b)
        k = [None] * num_steps
        k[0] = equation.explicit_terms(u0, dt)
        for i in range(1, num_steps):
            u_star = _combination(u0, [(dt * a[i - 1][j], k[j])
                                       for j in range(i) if a[i - 1][j] != 0])
            k[i] = equation.explicit_terms(equation.pressure_projection(u_star), dt)
        u_star = _combination(u0, [(dt * b[j], k[j]) for j in range(num_steps) if b[j] != 0])
        return equation.pressure_projection(u_star)


def _combination(u0: GridVariableVector, terms) -> GridVariableVector:
    """``u0 + c1 k1 + c2 k2 + ...`` over ``terms`` ``(c, k)``, summed in
    order: ``ops/cuda/fvm_projection.py``'s ``combine`` (one launch on the
    card) where the fields ``fits_mac_kernels``, else term by term. One
    ``solver.combine`` span covers it."""
    with trace_annotation("solver.combine"):
        ks = [kj for _, kj in terms]
        if (0 < len(terms) <= fvm_projection.MAX_TERMS
                and fvm_projection.fits_mac_kernels(u0, *ks)):
            out = fvm_projection.combine(
                tuple(c.data.contiguous() for c in u0),
                [(coef, tuple(c.data.contiguous() for c in kj)) for coef, kj in terms])
            return GridVariableVector(tuple(
                GridVariable(GridArray(d, c.offset, c.grid), c.bc) for d, c in zip(out, u0)))
        u_star = u0
        for coef, kj in terms:
            u_star = u_star + coef * kj
        return u_star


@dataclasses.dataclass
class NavierStokes2DFVMProjection(ProjectionExplicitODE):
    """Incompressible NSE, velocity-pressure MAC-grid formulation.

    Explicit terms = Van Leer convection + diffusion + forcing/ρ - drag;
    the pressure projection by fast diagonalization (Chorin; "Fast-Projection
    Methods for the Incompressible Navier-Stokes Equations", Fluids 2020, 5,
    222, eqs. 16-21). The forcing is state-independent, as every
    ``ForcingFn`` is: it is evaluated once, on first use in the field's dtype
    and device, since its mesh is built on the host.

    Spans (``utils.trace_annotation``): ``solver.forward`` around a step,
    ``solver.explicit`` around each evaluation of the explicit terms,
    ``solver.combine`` around each RK combination (``_combination``),
    ``solver.projection`` around each projection and, inside it,
    ``solver.poisson`` around its pressure solve. A classic RK4 step logs 17:
    one ``solver.forward`` holding four each of ``solver.explicit``,
    ``solver.combine`` and ``solver.projection``, and one ``solver.poisson``
    in each projection.

    Route: where ``_kernel_takes`` holds (CUDA fields and ``_kernel_fits``), an
    evaluation of the explicit terms is one launch of
    ``ops/cuda/fvm_explicit.py``, both components at once; elsewhere it is
    ``_explicit_terms_plain``. The rule reads only what it can observe: the
    fields' device, dtype and offsets, the BCs, the forcing's arrays, and
    whether ``convect`` is this module's and the module's
    ``advect_van_leer_using_limiters`` the scheme the kernel implements, both
    read at each call. A projection takes ``ops/cuda/fvm_projection.py``'s
    divergence and gradient around its solve where
    ``PressureProjection._kernel_fits`` holds (fields that
    ``fvm_projection.fits_mac_kernels``, the ``rfft`` solve in the fields'
    dtype), and the RK combination its ``combine`` where the state and the
    rates ``fits_mac_kernels``: kernels on the card, their plain versions
    on the CPU. Walls, an odd n1, other offsets or dtypes and a gradient
    take the plain stencils and the combination term by term.
    """

    viscosity: float = 1e-3
    grid: Optional[Grid] = None
    bcs: Optional[Sequence[object]] = None
    drag: float = 0.0
    density: float = 1.0
    convect: Callable = convect
    forcing: Optional[ForcingFn] = None
    solver: Optional[RKStepper] = None
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.grid is None:
            raise ValueError("grid is required")
        if self.solver is None:
            self.solver = RKStepper.from_method("heun_rk2")
        if self.bcs is None:
            self.bcs = tuple(boundaries.periodic_boundary_conditions(self.grid.ndim)
                             for _ in range(self.grid.ndim))
        self.pressure_bc = boundaries.get_pressure_bc_from_velocity_bc(self.bcs)
        self._projection = pressure.PressureProjection(
            grid=self.grid, bc=self.pressure_bc, dtype=self.dtype)
        self._forcing: Optional[GridArrayVector] = None

    def _forcing_term(self, dtype: torch.dtype, device) -> GridArrayVector:
        if self._forcing is None:
            self._forcing = GridArrayVector(tuple(
                self.forcing(self.grid, None, dtype=dtype, device=device)))
        return self._forcing

    def _kernel_fits(self, v: GridVariableVector) -> bool:
        """Whether the kernel computes what ``_explicit_terms_plain`` would, on
        whatever device: the module's Van Leer ``convect``, two periodic
        components of one 2-D grid on its MAC offsets, fp32 or fp64 fields of
        one shape, device and dtype that need no gradient, and no forcing or
        one ``(n0, n1)`` array a component on the fields' offsets, device and
        dtype."""
        if self.convect is not convect or advect_van_leer_using_limiters is not _KERNEL_SCHEME:
            return False
        if not fvm_projection.fits_mac_kernels(v):
            return False
        if self.forcing is None:
            return True
        a = v[0].data
        return all(f.offset == u.offset and tuple(f.data.shape) == v[0].grid.shape
                   and f.data.dtype == a.dtype and f.data.device == a.device
                   for f, u in zip(self._forcing_term(a.dtype, a.device), v))

    def _kernel_takes(self, v: GridVariableVector) -> bool:
        """Whether this evaluation is one launch of ``ops/cuda/fvm_explicit.py``."""
        return v[0].data.device.type == "cuda" and self._kernel_fits(v)

    def _explicit_terms(self, v: GridVariableVector, dt: float) -> GridVariableVector:
        if not self._kernel_takes(v):
            return self._explicit_terms_plain(v, dt)
        forcing = None
        if self.forcing is not None:
            forcing = tuple(f.data for f in self._forcing_term(v[0].dtype, v[0].data.device))
        rates = fvm_explicit.explicit_rates(
            v[0].data.contiguous(), v[1].data.contiguous(), forcing, v[0].grid.step, dt,
            self.viscosity, self.density, self.drag)
        return GridVariableVector(tuple(
            GridVariable(GridArray(r, u.offset, u.grid), u.bc) for r, u in zip(rates, v)))

    def _explicit_terms_plain(self, v: GridVariableVector, dt: float) -> GridVariableVector:
        dv_dt = self.convect(v, dt)
        dv_dt += diffuse_velocity(v, self.viscosity / self.density)
        if self.forcing is not None:
            # in the field's dtype, so fp64 runs get an fp64 forcing
            dv_dt += self._forcing_term(v[0].dtype, v[0].data.device) / self.density
        dv_dt = wrap_field_same_bcs(dv_dt, v)
        if self.drag > 0.0:
            dv_dt += -self.drag * v
        return dv_dt

    def explicit_terms(self, v: GridVariableVector, dt: float) -> GridVariableVector:
        with trace_annotation("solver.explicit"):
            return self._explicit_terms(v, dt)

    def pressure_projection(self, v: GridVariableVector) -> GridVariableVector:
        with trace_annotation("solver.projection"):
            return self._projection(v)

    def forward(self, u: GridVariableVector, dt: float) -> GridVariableVector:
        """One RK time step with a projection after each stage."""
        with trace_annotation("solver.forward"):
            return self.solver(u, dt, self)

    step = forward
    __call__ = forward


def rollout(v: GridVariableVector, equation: NavierStokes2DFVMProjection, dt: float,
            inner_steps: int, frames: int):
    """Steps ``v`` (a batch ``(b, *grid.shape)`` of independent samples, or
    one sample) ``frames * inner_steps`` times by ``equation.forward`` and
    records the finite-difference vorticity after every ``inner_steps``
    steps; returns ``(frames (frames, b, n, n), final velocity)``, both on
    the velocity's device. One ``gen.record`` span covers each frame's curl."""
    recorded = []
    for _ in range(frames):
        for _ in range(inner_steps):
            v = equation.forward(v, dt)
        with trace_annotation("gen.record"):
            recorded.append(fdm.curl_2d(v).data)
    return torch.stack(recorded), v

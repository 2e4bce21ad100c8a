"""Pressure solve and Chorin projection on the MAC grid (PyTorch).

Counterpart of ``tpu_cfd/solvers/pressure.py``. The solvers are plain
objects built once: the eigen-operators of ``fast_diagonalization`` are
computed at construction and applied to every rhs after. Where the JAX
package projects one sample under ``vmap``, these take a batch
``(b, *grid.shape)`` directly: every reduction runs over the grid dims only.
The solve is one ``torch.fft`` pair (periodic) or a pair of eigenvector
rotations by ``torch.matmul`` (walls).

Two routes for a projection (``PressureProjection._kernel_fits`` decides).
For two periodic components on the MAC offsets of a 2-D grid whose solve is
the ``rfft`` pair, in fp32 or fp64 and needing no gradient, the divergence
and the gradient's subtraction are ``ops/cuda/fvm_projection.py``'s, around
the unchanged solve: one kernel launch each on the card, their plain
versions, bit for bit the stencils of ``ops/finite_differences.py``, on the
CPU. Under periodic BCs imposing them leaves every value as it is, so this
route skips it. Every other projection runs those stencils and imposes the
BCs. On either route a ``solver.poisson`` span (``utils.trace_annotation``)
covers the pressure solve.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from tpu_cfd_torch import boundaries, grids
from tpu_cfd_torch.ops import fast_diagonalization, finite_differences as fdm
from tpu_cfd_torch.ops.cuda import fvm_projection
from tpu_cfd_torch.utils.profiling import trace_annotation

Tensor = torch.Tensor
Grid = grids.Grid
GridArray = grids.GridArray
GridVariable = grids.GridVariable
GridVariableVector = grids.GridVariableVector


def _default_implementation(grid: Grid, bc) -> str:
    """The fast-diagonalization implementation for ``bc``: circulant
    operators (periodic) take 'rfft' ('fft' for an odd last axis), walls the
    eigenvector products of 'matmul'."""
    periodic = all(boundaries.is_bc_periodic_boundary_conditions(bc, dim)
                   for dim in range(grid.ndim))
    if not periodic:
        return "matmul"
    return "rfft" if grid.shape[-1] % 2 == 0 else "fft"


@dataclasses.dataclass
class Pseudoinverse:
    """Pseudoinverse of the separable Laplacian on ``grid`` under ``bc``.

    Built once; ``__call__`` applies it to an rhs with any leading batch dims.
    """

    grid: Grid
    bc: Optional[object] = None
    dtype: torch.dtype = torch.float32
    hermitian: bool = True
    circulant: bool = True
    implementation: Optional[str] = None
    cutoff: Optional[float] = None

    def __post_init__(self):
        if self.bc is None:
            self.bc = boundaries.periodic_boundary_conditions(self.grid.ndim)
        if self.implementation is None:
            self.implementation = _default_implementation(self.grid, self.bc)
        if self.implementation == "matmul":
            self.circulant = False
        laplacians = fdm.set_laplacian_matrix(self.grid, self.bc)
        self._apply = fast_diagonalization.pseudoinverse_transform(
            laplacians, self.dtype, hermitian=self.hermitian,
            circulant=self.circulant, implementation=self.implementation,
            cutoff=self.cutoff,
        )

    def __call__(self, value: Tensor) -> Tensor:
        return self._apply(value)


@dataclasses.dataclass
class PressureProjection:
    """Chorin projection: makes a velocity field divergence-free.

    The divergence is the rhs; all-Neumann axes take its mean out; the
    Laplacian's pseudoinverse gives the pressure, whose BCs are imposed; its
    forward-difference gradient is subtracted from the velocity. Where
    ``_kernel_fits`` holds, the divergence and the subtraction are
    ``ops/cuda/fvm_projection.py``'s (one kernel launch each on the card)
    around the same solve. A ``solver.poisson`` span covers the solve (and,
    on the stencils' route, the rhs's mean removal).
    """

    grid: Grid
    bc: object  # the pressure's BC
    dtype: torch.dtype = torch.float32
    implementation: Optional[str] = None

    def __post_init__(self):
        self.solver = Pseudoinverse(grid=self.grid, bc=self.bc, dtype=self.dtype,
                                    hermitian=True, implementation=self.implementation)

    def _kernel_fits(self, v: GridVariableVector) -> bool:
        """Whether the divergence and the subtraction take
        ``ops/cuda/fvm_projection.py``: fields that ``fits_mac_kernels``, a
        pressure periodic on both axes whose solve is the ``rfft`` pair (an
        even n1), in the fields' dtype."""
        return (fvm_projection.fits_mac_kernels(v) and self.solver.implementation == "rfft"
                and self.dtype == v[0].dtype
                and all(boundaries.is_bc_periodic_boundary_conditions(self.bc, axis)
                        for axis in range(self.grid.ndim)))

    def __call__(self, v: GridVariableVector) -> GridVariableVector:
        grids.consistent_grid(self.grid, *v)
        if self._kernel_fits(v):
            return self._project_on_kernels(v)
        pressure_bc = boundaries.get_pressure_bc_from_velocity(v)
        rhs = fdm.divergence(v)
        with trace_annotation("solver.poisson"):
            rhs_inv = self.solver(rhs_transform(rhs, pressure_bc))
        q = pressure_bc.impose_bc(GridArray(rhs_inv, rhs.offset, rhs.grid))
        q_grad = fdm.forward_difference(q)
        return GridVariableVector(
            tuple(u.bc.impose_bc(u.array - q_g) for u, q_g in zip(v, q_grad))
        )

    def _project_on_kernels(self, v: GridVariableVector) -> GridVariableVector:
        u, w = (c.data.contiguous() for c in v)
        step = self.grid.step
        rhs = fvm_projection.divergence(u, w, step)
        with trace_annotation("solver.poisson"):
            q = self.solver(rhs)
        out = fvm_projection.subtract_gradient(u, w, q.contiguous(), step)
        return GridVariableVector(tuple(
            GridVariable(GridArray(d, c.offset, c.grid), c.bc) for d, c in zip(out, v)))


def rhs_transform(u: GridArray, bc) -> Tensor:
    """Takes out the mean over the grid dims where an axis is all-Neumann.

    The all-Neumann Poisson problem is solvable only for a mean-free rhs;
    each sample of a batch keeps its own mean.
    """
    u_data = u.data
    dims = tuple(range(-u.grid.ndim, 0))
    for axis in range(u.grid.ndim):
        if bc.types[axis] == (boundaries.BCType.NEUMANN, boundaries.BCType.NEUMANN):
            u_data = u_data - u_data.mean(dim=dims, keepdim=True)
    return u_data


def projection(
    v: GridVariableVector,
    solver: Optional[PressureProjection] = None,
) -> GridVariableVector:
    """One projection of ``v`` (builds the solver when none is given)."""
    if solver is None:
        grid = grids.consistent_grid_arrays(*v)
        pressure_bc = boundaries.get_pressure_bc_from_velocity(v)
        solver = PressureProjection(grid=grid, bc=pressure_bc, dtype=v[0].dtype)
    return solver(v)

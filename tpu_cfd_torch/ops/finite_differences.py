"""Finite-difference operators on staggered grid variables (PyTorch).

Counterpart of ``tpu_cfd/ops/finite_differences.py``. The operators take a
``GridVariable`` (its BCs give the ghost cells) and return a ``GridArray``
(a derivative has no BC of its own). Every stencil is ``shift`` (a
``torch.roll`` for periodic BCs) plus pointwise arithmetic, so leading batch
dims pass through. The Laplacian matrices are host numpy in fp64: set-up
constants for the eigendecomposition of ``fast_diagonalization``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np

from tpu_cfd_torch import boundaries, grids
from tpu_cfd_torch.ops import interpolation

Grid = grids.Grid
GridArray = grids.GridArray
GridVariable = grids.GridVariable
GridArrayTensor = grids.GridArrayTensor
GridVariableVector = grids.GridVariableVector


def stencil_sum(*arrays: GridArray) -> GridArray:
    """Sums arrays across a stencil, at their averaged offset."""
    offset = grids.averaged_offset_arrays(*arrays)
    result = sum(array.data for array in arrays)
    grid = grids.consistent_grid_arrays(*arrays)
    return GridArray(result, offset, grid)


def forward_difference(
    u: GridVariable, axis: Optional[Union[int, Tuple[int, ...]]] = None
):
    """Forward difference (u[i+1]-u[i])/h; the offset moves +0.5 along ``axis``."""
    if axis is None:
        axis = range(u.grid.ndim)
    if not isinstance(axis, int):
        return tuple(forward_difference(u, a) for a in axis)
    diff = stencil_sum(u.shift(+1, axis), -u.array)
    return diff / u.grid.step[axis]


def central_difference(
    u: GridVariable, axis: Optional[Union[int, Tuple[int, ...]]] = None
):
    """Central difference (u[i+1]-u[i-1])/(2h); the offset is unchanged."""
    if axis is None:
        axis = range(u.grid.ndim)
    if not isinstance(axis, int):
        return tuple(central_difference(u, a) for a in axis)
    diff = stencil_sum(u.shift(+1, axis), -u.shift(-1, axis))
    return diff / (2 * u.grid.step[axis])


def backward_difference(
    u: GridVariable, axis: Optional[Union[int, Tuple[int, ...]]] = None
):
    """Backward difference (u[i]-u[i-1])/h; the offset moves -0.5 along ``axis``."""
    if axis is None:
        axis = range(u.grid.ndim)
    if not isinstance(axis, int):
        return tuple(backward_difference(u, a) for a in axis)
    diff = stencil_sum(u.array, -u.shift(-1, axis))
    return diff / u.grid.step[axis]


def _check_vector(v) -> None:
    grid = grids.consistent_grid_arrays(*v)
    if len(v) != grid.ndim:
        raise ValueError(
            "The length of `v` must be equal to `grid.ndim`. "
            f"Expected length {grid.ndim}; got {len(v)}."
        )


def divergence(v: GridVariableVector) -> GridArray:
    """Divergence of a face-staggered vector field by backward differences."""
    _check_vector(v)
    return sum(backward_difference(u, axis) for axis, u in enumerate(v))


def centered_divergence(v: GridVariableVector) -> GridArray:
    """Divergence by central differences."""
    _check_vector(v)
    return sum(central_difference(u, axis) for axis, u in enumerate(v))


def laplacian(u: GridVariable, scales: Optional[Tuple[float, ...]] = None
              ) -> GridArray:
    """The (2·ndim+1)-point Laplacian stencil of ``u``."""
    if scales is None:
        scales = tuple(1 / s**2 for s in u.grid.step)
    result = -2 * u.array * sum(scales)
    for axis in range(u.grid.ndim):
        result += stencil_sum(u.shift(-1, axis), u.shift(+1, axis)) * scales[axis]
    return result


def laplacian_matrix(n: int, step: float, dtype=None) -> np.ndarray:
    """Dense 1-D periodic Laplacian (circulant [1, -2, 1]/h²), host numpy."""
    column = np.zeros(n)
    column[0] = -2 / step**2
    column[1] = column[-1] = 1 / step**2
    idx = (n - np.arange(n)[:, None] + np.arange(n)[None, :]) % n
    lap = column[idx]
    return lap.astype(dtype) if dtype is not None else lap


def _laplacian_boundary_dirichlet_cell_centered(
    laplacians: list, grid: Grid, axis: int, side: str
) -> list:
    """Patches a 1-D periodic Laplacian for a homogeneous Dirichlet wall.

    Cell-centred data half a step from the wall has the ghost value
    u[-1] = -u[0], so the diagonal entry gains -1/h².
    """
    lap = np.asarray(laplacians[axis])
    h2 = grid.step[axis] ** 2
    if side == "lower":
        lap[0, 0] -= 1 / h2
    else:
        lap[-1, -1] -= 1 / h2
    lap[0, -1] = 0.0  # no periodic wrap-around
    lap[-1, 0] = 0.0
    laplacians[axis] = lap
    return laplacians


def _laplacian_boundary_neumann_cell_centered(
    laplacians: list, grid: Grid, axis: int, side: str
) -> list:
    """Patches a 1-D periodic Laplacian for a homogeneous Neumann wall.

    The ghost value is u[-1] = u[0], so the diagonal entry gains +1/h².
    """
    lap = np.asarray(laplacians[axis])
    h2 = grid.step[axis] ** 2
    if side == "lower":
        lap[0, 0] += 1 / h2
    else:
        lap[-1, -1] += 1 / h2
    lap[0, -1] = 0.0
    lap[-1, 0] = 0.0
    laplacians[axis] = lap
    return laplacians


def laplacian_matrix_w_boundaries(
    grid: Grid,
    offset: Tuple[float, ...],
    bc,
    laplacians: Optional[Sequence[np.ndarray]] = None,
) -> list:
    """1-D Laplacian matrices that satisfy ``bc`` along each axis.

    Only homogeneous or periodic boundary conditions are supported.
    """
    if not isinstance(bc, boundaries.ConstantBoundaryConditions):
        raise NotImplementedError(f"Explicit laplacians are not implemented for {bc}.")
    if laplacians is None:
        laplacians = list(map(laplacian_matrix, grid.shape, grid.step))
    laplacians = list(laplacians)
    for axis in range(grid.ndim):
        if math.isclose(offset[axis], 0.5):
            for i, side in enumerate(["lower", "upper"]):
                if bc.types[axis][i] == boundaries.BCType.NEUMANN:
                    _laplacian_boundary_neumann_cell_centered(laplacians, grid, axis, side)
                elif bc.types[axis][i] == boundaries.BCType.DIRICHLET:
                    _laplacian_boundary_dirichlet_cell_centered(laplacians, grid, axis, side)
        if math.isclose(offset[axis] % 1, 0.0):
            if (bc.types[axis][0] == boundaries.BCType.DIRICHLET
                    and bc.types[axis][1] == boundaries.BCType.DIRICHLET):
                # edge-aligned Dirichlet: the interior has one cell fewer
                laplacians[axis] = laplacians[axis][:-1, :-1]
            elif boundaries.BCType.NEUMANN in bc.types[axis]:
                raise NotImplementedError(
                    "edge-aligned Neumann boundaries are not implemented."
                )
    return laplacians


def set_laplacian_matrix(grid: Grid, bc) -> list:
    """Laplacian operators of cell-centred data under ``bc``."""
    return laplacian_matrix_w_boundaries(grid, offset=grid.cell_center, bc=bc)


def gradient_tensor(v):
    """Cell-centred gradient tensor of a variable (or of a vector of them)."""
    if not isinstance(v, GridVariable):
        return GridArrayTensor(
            np.stack([np.asarray(gradient_tensor(u), dtype=object) for u in v], axis=-1)
        )
    grad = []
    for axis in range(v.grid.ndim):
        offset = v.offset[axis]
        if offset == 0:
            derivative = forward_difference(v, axis)
        elif offset == 1:
            derivative = backward_difference(v, axis)
        elif offset == 0.5:
            v_centered = interpolation.linear(v, v.grid.cell_center)
            derivative = central_difference(v_centered, axis)
        else:
            raise ValueError(f"expected offset values in {{0, 0.5, 1}}, got {offset}")
        grad.append(derivative)
    return GridArrayTensor(grad)


def curl_2d(v: Sequence[GridVariable]) -> GridArray:
    """2-D curl ∂v/∂x - ∂u/∂y by forward differences."""
    if len(v) != 2:
        raise ValueError(f"Length of `v` is not 2: {len(v)}")
    grid = grids.consistent_grid_arrays(*v)
    if grid.ndim != 2:
        raise ValueError(f"Grid dimensionality is not 2: {grid.ndim}")
    return forward_difference(v[1], axis=0) - forward_difference(v[0], axis=1)

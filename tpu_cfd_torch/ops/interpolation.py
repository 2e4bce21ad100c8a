"""Offset-to-offset interpolation of grid variables (PyTorch): linear,
upwind, Lax-Wendroff and the TVD flux limiters.

Counterpart of ``tpu_cfd/ops/interpolation.py``. Every scheme is
branchless (``torch.where``) and shift-based, and takes fields with any
leading batch dims: the velocity picks the upwind side cell by cell.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from tpu_cfd_torch import boundaries, grids

GridArray = grids.GridArray
GridVariable = grids.GridVariable
GridVariableVector = grids.GridVariableVector

InterpolationFn = Callable[
    [GridVariable, Tuple[float, ...], GridVariableVector, Optional[float]],
    GridVariable,
]
FluxLimiter = Callable[[torch.Tensor], torch.Tensor]


def _linear_along_axis(c: GridVariable, offset: float, axis: int) -> GridVariable:
    """Linear interpolation of ``c`` to ``offset`` along one axis."""
    offset_delta = offset - c.offset[axis]
    if offset_delta == 0:
        return c
    new_offset = tuple(offset if j == axis else o for j, o in enumerate(c.offset))
    if int(offset_delta) == offset_delta:
        return GridVariable(
            GridArray(c.shift(int(offset_delta), axis).data, new_offset, c.grid), c.bc)
    floor = int(math.floor(offset_delta))
    ceil = int(math.ceil(offset_delta))
    floor_weight = ceil - offset_delta
    ceil_weight = 1.0 - floor_weight
    data = (floor_weight * c.shift(floor, axis).data
            + ceil_weight * c.shift(ceil, axis).data)
    return GridVariable(GridArray(data, new_offset, c.grid), c.bc)


def linear(
    c: GridVariable,
    offset: Tuple[float, ...],
    v: Optional[object] = None,
    dt: Optional[float] = None,
) -> GridVariable:
    """Multi-linear interpolation of ``c`` to ``offset``, axis by axis."""
    del v, dt  # the advection schemes' signature
    if len(offset) != len(c.offset):
        raise ValueError(
            "`c.offset` and `offset` must have the same length; "
            f"got {c.offset} and {offset}."
        )
    interpolated = c
    for a, o in enumerate(offset):
        interpolated = _linear_along_axis(interpolated, offset=o, axis=a)
    return interpolated


def _single_interpolation_axis(c: GridVariable, offset: Tuple[float, ...]) -> int:
    axes = tuple(
        axis
        for axis, (current, target) in enumerate(zip(c.offset, offset))
        if current != target
    )
    if len(axes) != 1:
        raise ValueError(
            "`c.offset` and `offset` must differ at most in one entry, "
            f"but got: {c.offset} and {offset}."
        )
    return axes[0]


def upwind(
    c: GridVariable,
    offset: Tuple[float, ...],
    v: GridVariableVector,
    dt: Optional[float] = None,
) -> GridVariable:
    """First-order upwind interpolation of ``c`` to ``offset``: a positive
    velocity along the interpolation axis takes the previous cell's value, a
    negative one the next cell's."""
    del dt
    if c.offset == tuple(offset):
        return c
    axis = _single_interpolation_axis(c, offset)
    u = v[axis]
    offset_delta = u.offset[axis] - c.offset[axis]
    grid = grids.consistent_grid_arrays(c, u)
    if int(offset_delta) == offset_delta:
        return GridVariable(
            GridArray(c.shift(int(offset_delta), axis).data, tuple(offset), grid), c.bc)
    floor = int(math.floor(offset_delta))
    ceil = int(math.ceil(offset_delta))
    data = torch.where(u.data > 0, c.shift(floor, axis).data, c.shift(ceil, axis).data)
    return GridVariable(GridArray(data, tuple(offset), grid),
                        boundaries.periodic_boundary_conditions(grid.ndim))


def lax_wendroff(
    c: GridVariable,
    offset: Tuple[float, ...],
    v: GridVariableVector,
    dt: float,
) -> GridVariable:
    """Second-order Lax-Wendroff interpolation (not monotone: use it under a
    TVD limiter): the upwind value plus a Courant-number-weighted
    correction from the Taylor expansion at half a step."""
    if c.offset == tuple(offset):
        return c
    axis = _single_interpolation_axis(c, offset)
    u = v[axis]
    offset_delta = u.offset[axis] - c.offset[axis]
    floor = int(math.floor(offset_delta))  # for a positive velocity
    ceil = int(math.ceil(offset_delta))  # for a negative velocity
    grid = grids.consistent_grid_arrays(c, u)
    courant = (dt / grid.step[axis]) * u.data
    c_floor = c.shift(floor, axis).data
    c_ceil = c.shift(ceil, axis).data
    positive_u_case = c_floor + 0.5 * (1 - courant) * (c_ceil - c_floor)
    negative_u_case = c_ceil - 0.5 * (1 + courant) * (c_ceil - c_floor)
    data = torch.where(u.data > 0, positive_u_case, negative_u_case)
    return GridVariable(GridArray(data, tuple(offset), grid),
                        boundaries.periodic_boundary_conditions(grid.ndim))


def safe_div(x, y, default_numerator=1):
    """x / y with the zero denominators replaced by ``default_numerator``."""
    return x / torch.where(y != 0, y, default_numerator)


def van_leer_limiter(r):
    """Van Leer flux limiter: phi(r) = 2r/(1+r) for r > 0, else 0."""
    return torch.where(r > 0, safe_div(2 * r, 1 + r), 0.0)


def apply_tvd_limiter(
    interpolation_fn: InterpolationFn,
    limiter: FluxLimiter = van_leer_limiter,
) -> InterpolationFn:
    """A TVD scheme from upwind (stable) and ``interpolation_fn`` (high
    order): ``c_low - (c_low - c_high) * phi(r)``, where r is the ratio of
    consecutive gradients, taken at other points for each velocity sign
    (the flux-limiter construction of Dullemond's lecture notes, eqs.
    4.34-4.39)."""

    def tvd_interpolation(
        c: GridVariable,
        offset: Tuple[float, ...],
        v: GridVariableVector,
        dt: float,
    ) -> GridVariable:
        for axis, axis_offset in enumerate(offset):
            interpolation_offset = tuple(
                c_offset if i != axis else axis_offset
                for i, c_offset in enumerate(c.offset)
            )
            if interpolation_offset != tuple(c.offset):
                if interpolation_offset[axis] - c.offset[axis] != 0.5:
                    raise NotImplementedError(
                        "tvd_interpolation only supports forward "
                        "interpolation to control volume faces."
                    )
                c_low = upwind(c, offset, v, dt)
                c_high = interpolation_fn(c, offset, v, dt)

                c_left = c.shift(-1, axis)
                c_right = c.shift(1, axis)
                c_next_right = c.shift(2, axis)
                # gradient ratios for each velocity sign
                positive_u_r = safe_div(c.data - c_left.data, c_right.data - c.data)
                negative_u_r = safe_div(c_next_right.data - c_right.data,
                                        c_right.data - c.data)
                phi = torch.where(v[axis].data > 0, limiter(positive_u_r),
                                  limiter(negative_u_r))
                c_interpolated = c_low.data - (c_low.data - c_high.data) * phi
                c = GridVariable(GridArray(c_interpolated, interpolation_offset, c.grid),
                                 c.bc)
        return c

    return tvd_interpolation

"""Linear interpolation of grid variables between offsets (PyTorch).

Counterpart of ``linear`` in ``tpu_cfd/ops/interpolation.py``: as much as
``finite_differences.gradient_tensor`` needs. The advection schemes of that
module (upwind, Lax-Wendroff, TVD limiters) belong to the FVM solver, which
is not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

from tpu_cfd_torch import grids

GridArray = grids.GridArray
GridVariable = grids.GridVariable


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

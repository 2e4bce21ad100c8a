"""Boundary conditions for grid variables (periodic, Dirichlet, Neumann).

Counterpart of ``tpu_cfd/boundaries.py``. The ghost cells:

  - periodic: wrap around (a periodic ``shift`` is a ``torch.roll``);
  - Dirichlet at a cell center: ghost = 2*bc - mirror(interior);
  - Dirichlet at a cell edge: ghost = bc;
  - Neumann: ghost = edge - step*bc.

Grid dims are addressed from the end of the data's shape, so leading batch
dims work unchanged. The records are hashable and hold no tensors; the
boundary values a method needs are built on the data's device and dtype.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch

from tpu_cfd_torch import grids

Tensor = torch.Tensor
Grid = grids.Grid
GridArray = grids.GridArray
GridVariable = grids.GridVariable
GridVariableVector = grids.GridVariableVector

BoundaryValue = Optional[float]


class BCType:
    PERIODIC = "periodic"
    DIRICHLET = "dirichlet"
    NEUMANN = "neumann"


class Padding:
    MIRROR = "mirror"
    EXTEND = "extend"


def _data_axis(u: GridArray, dim: int) -> int:
    """Maps grid dim -> (possibly batched) data axis."""
    return dim - u.grid.ndim + u.data.ndim


def _pad(data: Tensor, axis: int, lo: int, hi: int, mode: str, value: float = 0.0
         ) -> Tensor:
    """``numpy.pad`` along one axis: ``wrap``, ``symmetric``, ``edge`` or
    ``constant``, any width."""
    n = data.shape[axis]
    if mode == "constant":
        shape = list(data.shape)
        parts = []
        for width in (lo, hi):
            shape[axis] = width
            parts.append(data.new_full(shape, value))
        return torch.cat([parts[0], data, parts[1]], dim=axis)
    i = torch.arange(-lo, n + hi, device=data.device)
    if mode == "wrap":
        i = i % n
    elif mode == "symmetric":
        i = i % (2 * n)
        i = torch.where(i < n, i, 2 * n - 1 - i)
    elif mode == "edge":
        i = i.clamp(0, n - 1)
    else:
        raise ValueError(f"unknown padding mode {mode!r}")
    return data.index_select(axis, i)


@dataclasses.dataclass(init=False, frozen=True)
class ConstantBoundaryConditions:
    """Constant-in-space-and-time boundary conditions.

    ``types[i]`` is the (lower, upper) BC type for grid dim ``i``;
    ``bc_values[i]`` the corresponding constant values (None for periodic).
    """

    types: Tuple[Tuple[str, str], ...]
    bc_values: Tuple[Tuple[BoundaryValue, BoundaryValue], ...]

    def __init__(
        self,
        types: Sequence[Tuple[str, str]],
        values: Sequence[Tuple[BoundaryValue, BoundaryValue]],
    ):
        object.__setattr__(self, "types", tuple(tuple(t) for t in types))
        object.__setattr__(self, "bc_values", tuple(tuple(v) for v in values))

    def shift(self, u: GridArray, offset: int, dim: int) -> GridArray:
        """Shifts ``u`` by ``offset`` cells along grid dim ``dim``.

        The result has ``u``'s shape and the offset ``u.offset + offset``;
        out-of-domain values are ghost cells of this BC.
        """
        if offset == 0:
            return u
        if self.types[dim] == (BCType.PERIODIC, BCType.PERIODIC):
            data = torch.roll(u.data, -offset, dims=_data_axis(u, dim))
            new_offset = tuple(
                o + offset if i == dim else o for i, o in enumerate(u.offset)
            )
            return GridArray(data, new_offset, u.grid)
        return self._trim(self._pad(u, offset, dim), -offset, dim)

    def _is_aligned(self, u: GridArray, dim: int) -> bool:
        """Checks that ``u`` holds all of the domain's interior values."""
        size_diff = u.shape[_data_axis(u, dim)] - u.grid.shape[dim]
        if self.types[dim][0] == BCType.DIRICHLET and math.isclose(u.offset[dim], 1):
            size_diff += 1
        if self.types[dim][1] == BCType.DIRICHLET and math.isclose(u.offset[dim], 1):
            size_diff += 1
        if self.types[dim][0] == BCType.NEUMANN and math.isclose(u.offset[dim] % 1, 0):
            raise NotImplementedError("Edge-aligned Neumann BCs are not implemented.")
        if size_diff < 0:
            raise ValueError("the GridArray does not contain all interior grid values.")
        return True

    def _pad(self, u: GridArray, width: int, dim: int, mode: Optional[str] = None
             ) -> GridArray:
        """Pads ``u`` with ``width`` ghost cells along grid dim ``dim``.

        A negative width pads the lower boundary, a positive one the upper.
        More than one ghost cell is defined for periodic BCs only.
        """
        if width < 0:
            bc_type, side, padding = self.types[dim][0], 0, (-width, 0)
        else:
            bc_type, side, padding = self.types[dim][1], 1, (0, width)
        axis = _data_axis(u, dim)
        new_offset = tuple(
            o - padding[0] if i == dim else o for i, o in enumerate(u.offset)
        )
        if bc_type != BCType.PERIODIC and abs(width) > 1:
            raise ValueError(
                "Padding past 1 ghost cell is not defined in nonperiodic case."
            )
        value = self.bc_values[dim][side]
        data = u.data
        if bc_type == BCType.PERIODIC:
            out = _pad(data, axis, *padding, "wrap")
        elif bc_type == BCType.DIRICHLET:
            if math.isclose(u.offset[dim] % 1, 0.5):  # cell center
                # the linear interpolation of (ghost, first interior) hits
                # the BC value on the boundary
                out = (2 * _pad(data, axis, *padding, "constant", value)
                       - _pad(data, axis, *padding, "symmetric"))
            elif math.isclose(u.offset[dim] % 1, 0):  # cell edge
                if mode == Padding.MIRROR:
                    out = (2 * _pad(data, axis, *padding, "constant", value)
                           - _pad(data, axis, *padding, "symmetric"))
                elif mode == Padding.EXTEND:
                    out = _pad(data, axis, *padding, "edge")
                else:
                    out = _pad(data, axis, *padding, "constant", value)
            else:
                raise ValueError(
                    "expected offset to be an edge or cell center, got "
                    f"offset[axis]={u.offset[dim]}"
                )
        elif bc_type == BCType.NEUMANN:
            if not (math.isclose(u.offset[dim] % 1, 0)
                    or math.isclose(u.offset[dim] % 1, 0.5)):
                raise ValueError(
                    "expected offset to be an edge or cell center, got "
                    f"offset[axis]={u.offset[dim]}"
                )
            # ghost = edge - step * value: the one-sided difference across
            # the boundary equals the BC value
            v = 0.0 if value is None else value
            ghosts = _pad(torch.zeros_like(data), axis, *padding, "constant", 1.0)
            out = _pad(data, axis, *padding, "edge") - u.grid.step[dim] * v * ghosts
        else:
            raise ValueError("invalid boundary type")
        return GridArray(out, new_offset, u.grid)

    def _trim(self, u: GridArray, width: int, dim: int) -> GridArray:
        """Trims ``width`` cells from the lower (width<0) or upper boundary."""
        padding = (-width, 0) if width < 0 else (0, width)
        axis = _data_axis(u, dim)
        data = u.data.narrow(axis, padding[0],
                             u.data.shape[axis] - padding[0] - padding[1])
        new_offset = tuple(
            o + padding[0] if i == dim else o for i, o in enumerate(u.offset)
        )
        return GridArray(data, new_offset, u.grid)

    pad = _pad
    trim = _trim

    def values(self, dim: int, grid: Grid, dtype=torch.float32, device=None
               ) -> Tuple[Optional[Tensor], Optional[Tensor]]:
        """Boundary-value tensors (the grid's shape without ``dim``), or
        ``(None, None)``."""
        if None in self.bc_values[dim]:
            return (None, None)
        shape = grid.shape[:dim] + grid.shape[dim + 1:]
        return tuple(
            torch.full(shape, self.bc_values[dim][i], dtype=dtype, device=device)
            for i in (0, 1)
        )

    def _trim_padding(self, u: GridArray, dim: int = 0, trim_side: str = "both"):
        """Trims padding added before; returns (array, padding removed).

        What lies left of offset 0 is lower padding, what lies past the
        grid's extent upper padding; the boundary points of a non-periodic
        edge-aligned field are set by the BC and are cut too.
        """
        axis = _data_axis(u, dim)
        lo_cut = hi_cut = 0
        if u.shape[axis] < u.grid.shape[dim]:
            return u, (0, 0)  # interior-only data carries no padding
        edge_aligned = math.isclose(u.offset[dim] % 1, 0)
        if trim_side in ("both", "left") and u.offset[dim] <= 0:
            lo_cut = -math.ceil(-u.offset[dim])
            if self.types[dim][0] == BCType.PERIODIC:
                lo_cut = max(lo_cut, u.grid.shape[dim] - u.shape[axis])
            elif edge_aligned:
                lo_cut -= 1
            u = self._trim(u, lo_cut, dim)
        if trim_side in ("both", "right"):
            if self.types[dim][1] == BCType.PERIODIC:
                hi_cut = max(u.shape[axis] - u.grid.shape[dim], 0)
            else:
                last = u.shape[axis] + u.offset[dim] - 1
                if last >= u.grid.shape[dim]:
                    hi_cut = math.ceil(last - u.grid.shape[dim])
                    if self.types[dim][1] == BCType.DIRICHLET and edge_aligned:
                        hi_cut += 1
        if hi_cut > 0:
            u = self._trim(u, hi_cut, dim)
        return u, (-lo_cut, hi_cut)

    def trim_boundary(self, u: GridArray) -> GridArray:
        """Removes the grid points on the boundary (and any padding)."""
        for axis in range(u.grid.ndim):
            self._is_aligned(u, axis)
            u, _ = self._trim_padding(u, axis)
        return u

    def pad_and_impose_bc(
        self,
        u: GridArray,
        offset_to_pad_to: Optional[Tuple[float, ...]] = None,
        mode: Optional[str] = None,
    ) -> GridVariable:
        """Wraps interior values into a ``GridVariable`` with its boundaries.

        ``mode=None`` pads edge-aligned Dirichlet data with the boundary
        value itself; ``MIRROR`` and ``EXTEND`` extend the flow past the wall.
        """
        if offset_to_pad_to is None:
            offset_to_pad_to = u.offset
        for axis in range(u.grid.ndim):
            self._is_aligned(u, axis)
            if (self.types[axis][0] == BCType.DIRICHLET
                    and math.isclose(u.offset[axis], 1.0)):
                if math.isclose(offset_to_pad_to[axis], 1.0):
                    u = self._pad(u, 1, axis, mode=mode)
                elif math.isclose(offset_to_pad_to[axis], 0.0):
                    u = self._pad(u, -1, axis, mode=mode)
        return GridVariable(u, self)

    def impose_bc(self, u: GridArray) -> GridVariable:
        """Trims the boundary points, then restores them from the BC."""
        offset = u.offset
        return self.pad_and_impose_bc(self.trim_boundary(u), offset)


class HomogeneousBoundaryConditions(ConstantBoundaryConditions):
    """Boundary conditions whose values are all zero."""

    def __init__(self, types: Sequence[Tuple[str, str]]):
        super().__init__(types, ((0.0, 0.0),) * len(types))


def is_bc_periodic_boundary_conditions(bc, dim: int) -> bool:
    if bc.types[dim][0] != BCType.PERIODIC:
        return False
    if bc.types[dim][0] != bc.types[dim][1]:
        raise ValueError(
            "periodic boundary conditions must be the same on both sides of the axis"
        )
    return True


def is_periodic_boundary_conditions(c: GridVariable, dim: int) -> bool:
    """Whether ``c`` is periodic along ``dim``."""
    return is_bc_periodic_boundary_conditions(c.bc, dim)


def periodic_boundary_conditions(ndim: int) -> ConstantBoundaryConditions:
    """Periodic homogeneous BCs for ``ndim`` spatial dimensions."""
    return HomogeneousBoundaryConditions(((BCType.PERIODIC, BCType.PERIODIC),) * ndim)


def dirichlet_boundary_conditions(
    ndim: int, bc_vals: Optional[Sequence[Tuple[float, float]]] = None,
) -> ConstantBoundaryConditions:
    """Dirichlet BCs on every boundary (homogeneous if no values are given)."""
    types = ((BCType.DIRICHLET, BCType.DIRICHLET),) * ndim
    if bc_vals is None:
        return HomogeneousBoundaryConditions(types)
    return ConstantBoundaryConditions(types, bc_vals)


def neumann_boundary_conditions(
    ndim: int, bc_vals: Optional[Sequence[Tuple[float, float]]] = None,
) -> ConstantBoundaryConditions:
    """Neumann BCs on every boundary (homogeneous if no values are given)."""
    types = ((BCType.NEUMANN, BCType.NEUMANN),) * ndim
    if bc_vals is None:
        return HomogeneousBoundaryConditions(types)
    return ConstantBoundaryConditions(types, bc_vals)


def channel_flow_boundary_conditions(
    ndim: int, bc_vals: Optional[Sequence[Tuple[float, float]]] = None,
) -> ConstantBoundaryConditions:
    """Periodic in x, Dirichlet walls in the other dimensions."""
    types = ((BCType.PERIODIC, BCType.PERIODIC),) + (
        (BCType.DIRICHLET, BCType.DIRICHLET),) * (ndim - 1)
    if bc_vals is None:
        return HomogeneousBoundaryConditions(types)
    return ConstantBoundaryConditions(types, ((None, None),) + tuple(bc_vals))


def consistent_boundary_conditions(*arrays: GridVariable) -> Tuple[str, ...]:
    """'periodic' or 'nonperiodic' per axis; raises if the arrays differ."""
    bc_types = []
    for axis in range(arrays[0].grid.ndim):
        bcs = {is_periodic_boundary_conditions(array, axis) for array in arrays}
        if len(bcs) != 1:
            raise Exception(f"arrays do not have consistent bc: {arrays}")
        bc_types.append("periodic" if bcs.pop() else "nonperiodic")
    return tuple(bc_types)


def get_pressure_bc_from_velocity(v: GridVariableVector
                                  ) -> HomogeneousBoundaryConditions:
    """Periodic velocity -> periodic pressure; walls -> zero-flux Neumann."""
    return HomogeneousBoundaryConditions(tuple(
        (BCType.PERIODIC, BCType.PERIODIC) if bc_type == "periodic"
        else (BCType.NEUMANN, BCType.NEUMANN)
        for bc_type in consistent_boundary_conditions(*v)
    ))


def get_pressure_bc_from_velocity_bc(
    bcs: Sequence[ConstantBoundaryConditions],
) -> HomogeneousBoundaryConditions:
    """As ``get_pressure_bc_from_velocity``, from the velocity's BCs alone."""
    pressure_bc_types = []
    for velocity_bc in bcs:
        if not isinstance(velocity_bc, HomogeneousBoundaryConditions):
            raise NotImplementedError(
                "Pressure BC inference is only implemented for homogeneous "
                f"velocity BCs, got {velocity_bc}"
            )
        types = velocity_bc.types
        if types[0][0] == BCType.PERIODIC and types[1][0] == BCType.PERIODIC:
            pressure_bc_types.append((BCType.PERIODIC, BCType.PERIODIC))
        else:
            pressure_bc_types.append((BCType.NEUMANN, BCType.NEUMANN))
    return HomogeneousBoundaryConditions(pressure_bc_types)


def has_all_periodic_boundary_conditions(*arrays: GridVariable) -> bool:
    """Whether every array is periodic in every dimension."""
    return all(is_periodic_boundary_conditions(array, axis)
               for array in arrays for axis in range(array.grid.ndim))


def get_advection_flux_bc_from_velocity_and_scalar(
    u: GridVariable, c: GridVariable, flux_direction: int
) -> ConstantBoundaryConditions:
    """The BC of the advection flux of scalar ``c`` carried by velocity ``u``.

    Periodic boundaries give a periodic flux; walls give homogeneous
    Dirichlet (non-porous) or homogeneous Neumann (porous, constant flux).
    The flux BC is valid only for taking a divergence.
    """
    if not isinstance(u.bc, HomogeneousBoundaryConditions):
        raise NotImplementedError(
            "advection-flux BC inference requires homogeneous velocity BCs;"
            f" got {u.bc}"
        )

    def _side(axis: int, side: int):
        u_type = u.bc.types[axis][side]
        if u_type == BCType.DIRICHLET and u.bc.bc_values[axis][side] == 0.0:
            return BCType.DIRICHLET, 0.0  # non-porous wall: no flux through it
        if u_type == BCType.NEUMANN and c.bc.types[axis][side] == BCType.NEUMANN:
            if not isinstance(c.bc, ConstantBoundaryConditions) or not (
                math.isclose(c.bc.bc_values[axis][side], 0.0)
            ):
                raise NotImplementedError(
                    "advection-flux BC inference supports only homogeneous"
                    f" Neumann scalars; got {c.bc}"
                )
            return BCType.NEUMANN, 0.0
        raise NotImplementedError(
            f"no advection-flux BC rule for velocity/scalar BC pair {(u.bc, c.bc)}"
        )

    out_types, out_values = [], []
    for axis in range(c.grid.ndim):
        if u.bc.types[axis][0] == BCType.PERIODIC:
            out_types.append((BCType.PERIODIC, BCType.PERIODIC))
            out_values.append((None, None))
        elif flux_direction != axis:
            # boundaries parallel to the flux only touch ghost cells, and the
            # divergence is taken on the interior
            out_types.append((BCType.DIRICHLET, BCType.DIRICHLET))
            out_values.append((0.0, 0.0))
        else:
            sides = [_side(axis, i) for i in range(2)]
            out_types.append(tuple(t for t, _ in sides))
            out_values.append(tuple(v for _, v in sides))
    return ConstantBoundaryConditions(out_types, out_values)

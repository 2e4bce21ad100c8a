"""Boundary conditions of the PyTorch port: periodic only, for now.

Counterpart of ``tpu_cfd/boundaries.py``. The pseudo-spectral solver and the
vorticity initial condition only tag fields as periodic, so this module
holds the boundary-condition record and ``periodic_boundary_conditions``.
The ghost-cell logic (shift, pad, trim, impose) waits for the FVM stack.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

BoundaryValue = Optional[float]


class BCType:
    PERIODIC = "periodic"
    DIRICHLET = "dirichlet"
    NEUMANN = "neumann"


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


class HomogeneousBoundaryConditions(ConstantBoundaryConditions):
    """Boundary conditions whose values are all zero."""

    def __init__(self, types: Sequence[Tuple[str, str]]):
        ndim = len(types)
        super().__init__(types, ((0.0, 0.0),) * ndim)


def periodic_boundary_conditions(ndim: int) -> ConstantBoundaryConditions:
    """Periodic homogeneous BCs for ``ndim`` spatial dimensions."""
    return HomogeneousBoundaryConditions(
        ((BCType.PERIODIC, BCType.PERIODIC),) * ndim
    )

"""Forcing functions for the Navier-Stokes solvers (PyTorch).

Counterpart of ``tpu_cfd/solvers/forcings.py``. Forcings are tensor-free
dataclasses; an evaluation builds its coordinate mesh on the ``device`` and
in the ``dtype`` it is given, so that fp64 solver runs evaluate the forcing
in fp64.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import torch

from tpu_cfd_torch import grids

Tensor = torch.Tensor
Grid = grids.Grid
GridArray = grids.GridArray


@dataclasses.dataclass
class ForcingFn:
    """Base class for forcing terms.

    ``vorticity=False`` forcings evaluate to a velocity-space pair (u, v);
    ``vorticity=True`` forcings evaluate to a scalar vorticity field.
    """

    grid: Grid
    scale: float = 1.0
    wave_number: int = 1
    diam: float = 1.0
    swap_xy: bool = False
    vorticity: bool = False
    offsets: Optional[Tuple[Tuple[float, ...], ...]] = None

    def __post_init__(self):
        if self.offsets is None:
            self.offsets = self.grid.cell_faces

    def velocity_eval(self, grid, velocity, dtype=torch.float32, device=None
                      ) -> Tuple[GridArray, GridArray]:
        raise NotImplementedError

    def vorticity_eval(self, grid, vorticity, dtype=torch.float32, device=None
                       ) -> GridArray:
        raise NotImplementedError

    def __call__(
        self,
        grid: Optional[Grid] = None,
        field: Optional[Union[Tuple[Tensor, Tensor], Tensor]] = None,
        dtype=torch.float32,
        device=None,
    ):
        if not self.vorticity:
            return self.velocity_eval(grid, field, dtype=dtype, device=device)
        return self.vorticity_eval(grid, field, dtype=dtype, device=device)


@dataclasses.dataclass
class KolmogorovForcing(ForcingFn):
    """Sinusoidal stripe forcing u = scale*sin(k·y) (Kochkov et al. 2021)."""

    diam: float = 2 * math.pi

    def __post_init__(self):
        if self.offsets is None:
            self.offsets = ((0.0, 0.0), (0.0, 0.0))

    def velocity_eval(self, grid, velocity=None, dtype=torch.float32,
                      device=None) -> Tuple[GridArray, GridArray]:
        grid = self.grid if grid is None else grid
        offsets = self.offsets
        domain_factor = 2 * math.pi / self.diam
        if self.swap_xy:
            x = grid.mesh(offsets[1], dtype=dtype, device=device)[0]
            v = GridArray(
                self.scale * torch.sin(self.wave_number * domain_factor * x),
                offsets[1], grid,
            )
            u = GridArray(torch.zeros_like(v.data), (1, 1 / 2), grid)
        else:
            y = grid.mesh(offsets[0], dtype=dtype, device=device)[1]
            u = GridArray(
                self.scale * torch.sin(self.wave_number * domain_factor * y),
                offsets[0], grid,
            )
            v = GridArray(torch.zeros_like(u.data), (1 / 2, 1), grid)
        return (u, v)

    def vorticity_eval(self, grid, vorticity=None, dtype=torch.float32,
                       device=None) -> GridArray:
        grid = self.grid if grid is None else grid
        offsets = self.offsets
        domain_factor = 2 * math.pi / self.diam
        axis, off = (0, offsets[1]) if self.swap_xy else (1, offsets[0])
        z = grid.mesh(off, dtype=dtype, device=device)[axis]
        return GridArray(
            -self.scale * self.wave_number * domain_factor
            * torch.cos(self.wave_number * domain_factor * z),
            off, grid,
        )


@dataclasses.dataclass
class SimpleSolenoidalForcing(ForcingFn):
    """Template for solenoidal (divergence-free) forcings F = (ψ, -ψ)."""

    vorticity: bool = True

    def __post_init__(self):
        if self.offsets is None:
            self.offsets = ((0.0, 0.0), (0.0, 0.0))

    @staticmethod
    def potential(x: Tensor, y: Tensor, s: float, k: float) -> Tensor:
        raise NotImplementedError

    @staticmethod
    def vort_potential(x: Tensor, y: Tensor, s: float, k: float) -> Tensor:
        raise NotImplementedError

    def _xy(self, grid, dtype, device):
        offsets = self.offsets
        ox, oy = (offsets[1], offsets[0]) if self.swap_xy else (offsets[0], offsets[1])
        x = grid.mesh(ox, dtype=dtype, device=device)[0]
        y = grid.mesh(oy, dtype=dtype, device=device)[1]
        return x, y

    def velocity_eval(self, grid, velocity=None, dtype=torch.float32,
                      device=None) -> Tuple[GridArray, GridArray]:
        grid = self.grid if grid is None else grid
        offsets = self.offsets
        k = self.wave_number * 2 * math.pi / self.diam
        scale = 0.5 * self.scale / (2 * math.pi) / self.wave_number
        rot = self.potential(*self._xy(grid, dtype, device), scale, k)
        if self.swap_xy:
            return (GridArray(-rot, (1, 1 / 2), grid),
                    GridArray(rot, offsets[1], grid))
        return (GridArray(rot, offsets[0], grid),
                GridArray(-rot, (1 / 2, 1), grid))

    def vorticity_eval(self, grid, vorticity=None, dtype=torch.float32,
                       device=None) -> GridArray:
        grid = self.grid if grid is None else grid
        k = self.wave_number * 2 * math.pi / self.diam
        return GridArray(
            self.vort_potential(*self._xy(grid, dtype, device), self.scale, k),
            self.offsets[0], grid,
        )


@dataclasses.dataclass
class SinCosForcing(SimpleSolenoidalForcing):
    """The FNO-paper forcing 0.1*(sin(2π(x+y)) + cos(2π(x+y))) (Li et al. 2020)."""

    scale: float = 0.1

    @staticmethod
    def potential(x: Tensor, y: Tensor, s: float, k: float) -> Tensor:
        return s * (torch.sin(k * (x + y)) - torch.cos(k * (x + y)))

    @staticmethod
    def vort_potential(x: Tensor, y: Tensor, s: float, k: float) -> Tensor:
        return s * (torch.cos(k * (x + y)) + torch.sin(k * (x + y)))

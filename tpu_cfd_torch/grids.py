"""Grid data model for the PyTorch port: ``Grid``, ``GridArray``, ``GridVariable``.

Counterpart of ``tpu_cfd/grids.py``. ``Grid`` is hashable metadata and holds
no tensors; its meshes are built on demand on the ``device`` the caller
names. ``GridArray`` and ``GridVariable`` are plain frozen dataclasses around
a tensor, with ``.data`` — as much as the vorticity initial condition and the
forcings use. The finite-volume methods (``shift``, ``interior``,
``enforce_edge_bc``) belong to the FVM stack and are not ported yet.

Grid axes are addressed from the end of a tensor's shape, so tensors may
carry leading batch dimensions.
"""

from __future__ import annotations

import dataclasses
import numbers
import operator
from typing import Any, Optional, Sequence, Tuple, Union

import numpy as np
import torch

Tensor = torch.Tensor


@dataclasses.dataclass(init=False, frozen=True)
class Grid:
    """Size, cell width and physical extent of an Arakawa C-grid.

    Along each dimension ``i``: ``shape[i]`` cells of width ``step[i]``
    spanning ``domain[i] = (lower, upper)``.
    """

    shape: Tuple[int, ...]
    step: Tuple[float, ...]
    domain: Tuple[Tuple[float, float], ...]

    def __init__(
        self,
        shape: Sequence[int],
        step: Optional[Union[float, Sequence[float]]] = None,
        domain: Optional[Union[float, Sequence[Tuple[float, float]]]] = None,
    ):
        shape = tuple(operator.index(s) for s in shape)
        object.__setattr__(self, "shape", shape)

        if step is not None and domain is not None:
            raise TypeError("cannot provide both step and domain")
        elif domain is not None:
            if isinstance(domain, (int, float)):
                domain = ((0.0, float(domain)),) * len(shape)
            else:
                if len(domain) != len(shape):
                    raise ValueError(
                        "length of domain does not match ndim: "
                        f"{len(domain)} != {len(shape)}"
                    )
                for bounds in domain:
                    if len(bounds) != 2:
                        raise ValueError(
                            f"domain is not sequence of pairs of numbers: {domain}"
                        )
            domain = tuple((float(lo), float(hi)) for lo, hi in domain)
        else:
            if step is None:
                step = 1.0
            if isinstance(step, numbers.Number):
                step = (float(step),) * len(shape)
            elif len(step) != len(shape):
                raise ValueError(
                    f"length of step does not match ndim: {len(step)} != {len(shape)}"
                )
            domain = tuple((0.0, float(s * n)) for s, n in zip(step, shape))

        object.__setattr__(self, "domain", domain)
        step = tuple((hi - lo) / n for (lo, hi), n in zip(domain, shape))
        object.__setattr__(self, "step", step)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def cell_center(self) -> Tuple[float, ...]:
        """Offset at the center of each grid cell."""
        return self.ndim * (0.5,)

    @property
    def cell_faces(self) -> Tuple[Tuple[float, ...], ...]:
        """Offsets at each of the 'forward' cell faces (MAC staggering)."""
        d = self.ndim
        return tuple(
            tuple(1.0 if i == j else 0.5 for j in range(d)) for i in range(d)
        )

    def axes(
        self,
        offset: Optional[Sequence[float]] = None,
        dtype=torch.float32,
        device=None,
    ) -> Tuple[Tensor, ...]:
        """1-D coordinate tensors per dimension, shifted by ``offset * step``.

        Computed on the host with numpy in the target precision, the same
        arithmetic as the JAX package, so fp32 meshes round alike.
        """
        if offset is None:
            offset = self.cell_center
        if len(offset) != self.ndim:
            raise ValueError(f"unexpected offset length: {len(offset)} vs {self.ndim}")
        return tuple(
            torch.as_tensor(
                lo + (np.arange(n, dtype=_np_dtype(dtype)) + float(o)) * s,
                device=device,
            ).to(dtype)
            for (lo, _), o, n, s in zip(self.domain, offset, self.shape, self.step)
        )

    def fft_axes(self, dtype=torch.float32, device=None) -> Tuple[Tensor, ...]:
        """Ordinal FFT frequencies per axis (multiply by 2π for angular)."""
        return tuple(
            torch.as_tensor(np.fft.fftfreq(n, d=s), device=device).to(dtype)
            for n, s in zip(self.shape, self.step)
        )

    def mesh(
        self,
        offset: Optional[Sequence[float]] = None,
        dtype=torch.float32,
        device=None,
    ) -> Tuple[Tensor, ...]:
        """N-D coordinate meshes, each of shape ``self.shape``."""
        axes = self.axes(offset, dtype=dtype, device=device)
        return tuple(torch.meshgrid(*axes, indexing="ij"))

    def fft_mesh(self, dtype=torch.float32, device=None) -> Tuple[Tensor, ...]:
        """Full-spectrum ordinal frequency meshes."""
        fft_axes = self.fft_axes(dtype=dtype, device=device)
        return tuple(torch.meshgrid(*fft_axes, indexing="ij"))

    def rfft_mesh(self, dtype=torch.float32, device=None) -> Tuple[Tensor, ...]:
        """Half-spectrum (rfft along the last axis) frequency meshes."""
        mesh = self.fft_mesh(dtype=dtype, device=device)
        k_max = self.shape[-1] // 2
        return tuple(m[..., : k_max + 1] for m in mesh)


def _np_dtype(dtype) -> type:
    return np.float64 if dtype == torch.float64 else np.float32


@dataclasses.dataclass(frozen=True, eq=False)
class GridArray:
    """A tensor of values defined at a fixed offset on a grid."""

    data: Tensor
    offset: Tuple[float, ...]
    grid: Grid

    def __post_init__(self):
        object.__setattr__(self, "offset", tuple(float(o) for o in self.offset))


@dataclasses.dataclass(frozen=True, eq=False)
class GridVariable:
    """A ``GridArray`` plus the boundary conditions that complete the field."""

    array: GridArray
    bc: Any

    def __post_init__(self):
        if not isinstance(self.array, GridArray):
            raise ValueError(
                f"Expected array type to be GridArray, got {type(self.array)}"
            )
        if len(self.bc.types) != self.grid.ndim:
            raise ValueError(
                "Incompatible dimension between grid and bc, grid dimension = "
                f"{self.grid.ndim}, bc dimension = {len(self.bc.types)}"
            )

    @property
    def data(self) -> Tensor:
        return self.array.data

    @property
    def offset(self) -> Tuple[float, ...]:
        return self.array.offset

    @property
    def grid(self) -> Grid:
        return self.array.grid

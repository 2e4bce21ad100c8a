"""Grid data model for the PyTorch port: ``Grid``, ``GridArray``, ``GridVariable``.

Counterpart of ``tpu_cfd/grids.py``. ``Grid`` is hashable metadata and holds
no tensors; its meshes are built on demand on the ``device`` the caller
names. ``GridArray`` and ``GridVariable`` are plain frozen dataclasses around
a tensor with offset-checked arithmetic; a ``GridVariable`` takes its ghost
cells from its boundary conditions (``shift``, ``interior``,
``enforce_edge_bc``). ``GridArrayVector`` and ``GridVariableVector`` are
tuples with elementwise vector arithmetic.

Grid axes are addressed from the end of a tensor's shape, so tensors may
carry leading batch dimensions.
"""

from __future__ import annotations

import dataclasses
import math
import numbers
import operator
from typing import Any, Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

Tensor = torch.Tensor

_HANDLED_TYPES = (numbers.Number, torch.Tensor)


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


class GridArrayMixin:
    """Arithmetic of ``GridArray``: offsets and grids must match."""

    def _binary_op(self, other, op, reflexive=False):
        if isinstance(other, GridVariable):
            return NotImplemented
        if isinstance(other, GridArray):
            if tuple(self.offset) != tuple(other.offset):
                raise ValueError(
                    f"offsets do not match: {self.offset} vs {other.offset}"
                )
            if self.grid != other.grid:
                raise ValueError("grids do not match")
            data = op(other.data, self.data) if reflexive else op(self.data, other.data)
            return GridArray(data, self.offset, self.grid)
        if isinstance(other, _HANDLED_TYPES):
            data = op(other, self.data) if reflexive else op(self.data, other)
            return GridArray(data, self.offset, self.grid)
        return NotImplemented

    __add__ = lambda self, o: self._binary_op(o, operator.add)  # noqa: E731
    __radd__ = lambda self, o: self._binary_op(o, operator.add, True)  # noqa: E731
    __sub__ = lambda self, o: self._binary_op(o, operator.sub)  # noqa: E731
    __rsub__ = lambda self, o: self._binary_op(o, operator.sub, True)  # noqa: E731
    __mul__ = lambda self, o: self._binary_op(o, operator.mul)  # noqa: E731
    __rmul__ = lambda self, o: self._binary_op(o, operator.mul, True)  # noqa: E731
    __truediv__ = lambda self, o: self._binary_op(o, operator.truediv)  # noqa: E731
    __rtruediv__ = lambda self, o: self._binary_op(o, operator.truediv, True)  # noqa: E731
    __pow__ = lambda self, o: self._binary_op(o, operator.pow)  # noqa: E731

    def __neg__(self):
        return GridArray(-self.data, self.offset, self.grid)

    def __abs__(self):
        return GridArray(self.data.abs(), self.offset, self.grid)

    def __eq__(self, other):
        if isinstance(other, type(self)):
            return (
                self.offset == other.offset
                and self.grid == other.grid
                and self.data.shape == other.data.shape
                and bool(torch.equal(self.data, other.data))
            )
        return NotImplemented

    def __hash__(self):
        return id(self)


@dataclasses.dataclass(frozen=True, eq=False)
class GridArray(GridArrayMixin):
    """A tensor of values defined at a fixed offset on a grid."""

    data: Tensor
    offset: Tuple[float, ...]
    grid: Grid

    def __post_init__(self):
        object.__setattr__(self, "offset", tuple(float(o) for o in self.offset))

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.data.shape)

    @property
    def ndim(self) -> int:
        return self.data.ndim

    def astype(self, dtype) -> "GridArray":
        return GridArray(self.data.to(dtype), self.offset, self.grid)


class GridVariableMixin:
    """Arithmetic of ``GridVariable``: offsets, grids and BCs must match."""

    def _binary_op(self, other, op, reflexive=False):
        if isinstance(other, GridVariable):
            if tuple(self.offset) != tuple(other.offset):
                raise ValueError(
                    f"offsets do not match: {self.offset} vs {other.offset}"
                )
            if self.grid != other.grid:
                raise ValueError("grids do not match")
            if self.bc != other.bc:
                raise ValueError(
                    f"boundary conditions do not match: {self.bc} vs {other.bc}"
                )
            data = op(other.data, self.data) if reflexive else op(self.data, other.data)
            return GridVariable(GridArray(data, self.offset, self.grid), self.bc)
        if isinstance(other, _HANDLED_TYPES):
            data = op(other, self.data) if reflexive else op(self.data, other)
            return GridVariable(GridArray(data, self.offset, self.grid), self.bc)
        return NotImplemented

    __add__ = lambda self, o: self._binary_op(o, operator.add)  # noqa: E731
    __radd__ = lambda self, o: self._binary_op(o, operator.add, True)  # noqa: E731
    __sub__ = lambda self, o: self._binary_op(o, operator.sub)  # noqa: E731
    __rsub__ = lambda self, o: self._binary_op(o, operator.sub, True)  # noqa: E731
    __mul__ = lambda self, o: self._binary_op(o, operator.mul)  # noqa: E731
    __rmul__ = lambda self, o: self._binary_op(o, operator.mul, True)  # noqa: E731
    __truediv__ = lambda self, o: self._binary_op(o, operator.truediv)  # noqa: E731
    __rtruediv__ = lambda self, o: self._binary_op(o, operator.truediv, True)  # noqa: E731
    __pow__ = lambda self, o: self._binary_op(o, operator.pow)  # noqa: E731

    def __neg__(self):
        return GridVariable(GridArray(-self.data, self.offset, self.grid), self.bc)

    def __abs__(self):
        return GridVariable(GridArray(self.data.abs(), self.offset, self.grid), self.bc)

    def __eq__(self, other):
        if isinstance(other, type(self)):
            return (
                self.offset == other.offset
                and self.grid == other.grid
                and self.bc == other.bc
                and self.data.shape == other.data.shape
                and bool(torch.equal(self.data, other.data))
            )
        return NotImplemented

    def __hash__(self):
        return id(self)


@dataclasses.dataclass(frozen=True, eq=False)
class GridVariable(GridVariableMixin):
    """A ``GridArray`` plus the boundary conditions that complete the field.

    ``shift`` pads with the ghost cells of ``bc`` and trims back to the shape.
    """

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

    @property
    def dtype(self):
        return self.array.dtype

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.array.shape

    def astype(self, dtype) -> "GridVariable":
        return GridVariable(self.array.astype(dtype), self.bc)

    def shift(self, offset: int, dim: int) -> GridArray:
        """Shifts this variable by ``offset`` cells along grid dim ``dim``.

        Out-of-domain values are ghost cells of ``self.bc``; the shape is
        unchanged.
        """
        return self.bc.shift(self.array, offset, dim)

    def _interior_grid(self) -> Grid:
        """A grid with its domain restricted to the variable's interior."""
        grid = self.grid
        domain = list(grid.domain)
        shape = list(grid.shape)
        for axis in range(grid.ndim):
            if self.bc.types[axis][1] == "periodic":
                continue
            if math.isclose(self.offset[axis], 1.0):
                shape[axis] -= 1
                domain[axis] = (domain[axis][0], domain[axis][1] - grid.step[axis])
        return Grid(shape, domain=tuple(domain))

    def _interior_array(self) -> Tensor:
        """The values of the interior points."""
        data = self.data
        for axis in range(self.grid.ndim):
            if self.bc.types[axis][1] == "periodic":
                continue
            if math.isclose(self.offset[axis], 1.0):
                data = data.narrow(axis - self.grid.ndim + data.ndim, 0,
                                   data.shape[axis - self.grid.ndim] - 1)
        return data

    def interior(self) -> GridArray:
        """The interior values (drops upper boundary-aligned points)."""
        return GridArray(self._interior_array(), self.offset, self._interior_grid())

    def enforce_edge_bc(self, *args) -> "GridVariable":
        """Overwrites boundary-aligned points with the Dirichlet BC values."""
        if self.grid.shape != tuple(self.data.shape[-self.grid.ndim:]):
            raise ValueError("Stored array and grid have mismatched shapes.")
        data = self.data
        for axis in range(self.grid.ndim):
            if "periodic" in self.bc.types[axis]:
                continue
            values = self.bc.values(axis, self.grid, *args)
            for boundary_side, value in enumerate(values):
                if value is None or not math.isclose(self.offset[axis] % 1, 0):
                    continue
                if data is self.data:
                    data = data.clone()
                data.select(axis - self.grid.ndim + data.ndim,
                            -boundary_side).copy_(value)
        return GridVariable(GridArray(data, self.offset, self.grid), self.bc)


def _vector_op(cls, self, other, op, reflexive=False):
    if isinstance(other, (cls, tuple)):
        if len(self) != len(other):
            raise ValueError("vector lengths do not match")
        pairs = zip(other, self) if reflexive else zip(self, other)
        return cls(op(a, b) for a, b in pairs)
    return cls(op(other, a) if reflexive else op(a, other) for a in self)


class GridArrayVector(tuple):
    """A tuple of ``GridArray``\\s with elementwise vector arithmetic."""

    def __new__(cls, arrays):
        arrays = tuple(arrays)
        if not all(isinstance(a, GridArray) for a in arrays):
            raise TypeError(
                "GridArrayVector members must be GridArray, got "
                f"{[type(a) for a in arrays]}"
            )
        return super().__new__(cls, arrays)

    __add__ = lambda self, o: _vector_op(GridArrayVector, self, o, operator.add)  # noqa: E731
    __radd__ = __add__
    __sub__ = lambda self, o: _vector_op(GridArrayVector, self, o, operator.sub)  # noqa: E731
    __rsub__ = lambda self, o: _vector_op(GridArrayVector, self, o, operator.sub, True)  # noqa: E731
    __mul__ = lambda self, o: _vector_op(GridArrayVector, self, o, operator.mul)  # noqa: E731
    __rmul__ = __mul__
    __truediv__ = lambda self, o: _vector_op(GridArrayVector, self, o, operator.truediv)  # noqa: E731

    def __neg__(self):
        return GridArrayVector(-a for a in self)

    @property
    def dtype(self):
        return self[0].dtype


class GridVariableVector(tuple):
    """A tuple of ``GridVariable``\\s with elementwise vector arithmetic."""

    def __new__(cls, variables):
        variables = tuple(variables)
        if not all(isinstance(v, GridVariable) for v in variables):
            raise TypeError(
                "GridVariableVector members must be GridVariable, got "
                f"{[type(v) for v in variables]}"
            )
        return super().__new__(cls, variables)

    __add__ = lambda self, o: _vector_op(GridVariableVector, self, o, operator.add)  # noqa: E731
    __radd__ = __add__
    __sub__ = lambda self, o: _vector_op(GridVariableVector, self, o, operator.sub)  # noqa: E731
    __rsub__ = lambda self, o: _vector_op(GridVariableVector, self, o, operator.sub, True)  # noqa: E731
    __mul__ = lambda self, o: _vector_op(GridVariableVector, self, o, operator.mul)  # noqa: E731
    __rmul__ = __mul__
    __truediv__ = lambda self, o: _vector_op(GridVariableVector, self, o, operator.truediv)  # noqa: E731

    def __neg__(self):
        return GridVariableVector(-v for v in self)

    @property
    def arrays(self) -> GridArrayVector:
        return GridArrayVector(v.array for v in self)

    @property
    def dtype(self):
        return self[0].dtype


class GridArrayTensor(np.ndarray):
    """A numpy object array of ``GridArray``\\s (a rank-2 field, say a gradient)."""

    def __new__(cls, arrays):
        return np.asarray(arrays, dtype=object).view(cls)


def applied(func: Callable) -> Callable:
    """Lifts a tensor function to ``GridArray``\\s of one offset and grid."""

    def wrapper(*args, **kwargs):
        arrays = [a for a in (*args, *kwargs.values()) if isinstance(a, GridArray)]
        offset = consistent_offset_arrays(*arrays)
        grid = consistent_grid_arrays(*arrays)
        raw_args = [a.data if isinstance(a, GridArray) else a for a in args]
        raw_kwargs = {k: (v.data if isinstance(v, GridArray) else v)
                      for k, v in kwargs.items()}
        return GridArray(func(*raw_args, **raw_kwargs), offset, grid)

    return wrapper


def _as_tensor_like(x, like: Tensor):
    return x if isinstance(x, Tensor) else torch.as_tensor(x, dtype=like.dtype,
                                                           device=like.device)


def where(
    condition: Union[GridArray, Tensor],
    x: Union[GridArray, Tensor, float],
    y: Union[GridArray, Tensor, float],
) -> GridArray:
    """``torch.where`` over ``GridArray``\\s (a nonzero condition is true)."""

    def _where(c, a, b):
        ref = next(t for t in (a, b, c) if isinstance(t, Tensor))
        cond = c if c.dtype == torch.bool else c != 0
        return torch.where(cond, _as_tensor_like(a, ref), _as_tensor_like(b, ref))

    return applied(_where)(condition, x, y)


def averaged_offset(*offsets: Sequence[float]) -> Tuple[float, ...]:
    """The averaged offset of the given offsets."""
    n = len(offsets)
    return tuple(sum(o) / n for o in zip(*offsets))


def averaged_offset_arrays(*arrays: Union[GridArray, GridVariable]) -> Tuple[float, ...]:
    """The averaged offset of the given arrays."""
    return averaged_offset(*[a.offset for a in arrays])


def control_volume_offsets(c: Union[GridArray, GridVariable]
                           ) -> Tuple[Tuple[float, ...], ...]:
    """Offsets of the faces of the control volume centered on ``c``."""
    return tuple(
        tuple(o + 0.5 if i == j else o for i, o in enumerate(c.offset))
        for j in range(len(c.offset))
    )


def consistent_offset_arrays(*arrays: Any) -> Tuple[float, ...]:
    """The one offset of all ``arrays``; raises if they differ."""
    offsets = {tuple(a.offset) for a in arrays}
    if len(offsets) != 1:
        raise ValueError(f"arrays do not have a unique offset: {offsets}")
    return offsets.pop()


def consistent_grid(grid: Grid, *arrays: Any):
    """Checks that all ``arrays`` lie on ``grid``; returns them."""
    grids_ = {a.grid for a in arrays}
    if grids_ != {grid}:
        raise ValueError(
            f"arrays' grids {grids_} are not consistent with the grid {grid}"
        )
    return arrays


def consistent_grid_arrays(*arrays: Any) -> Grid:
    """The one grid of all ``arrays``; raises if they differ."""
    grids_ = {a.grid for a in arrays}
    if len(grids_) != 1:
        raise ValueError(f"arrays do not have a unique grid: {grids_}")
    return grids_.pop()

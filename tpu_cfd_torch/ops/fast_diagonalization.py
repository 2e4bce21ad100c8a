"""Fast diagonalization of separable linear operators (A⊗I + I⊗B + ...).

Counterpart of ``tpu_cfd/ops/fast_diagonalization.py``. Computes
F(A ⊗ I + I ⊗ B) = (X_A ⊗ X_B) F(Λ_A ⊕ Λ_B) (X_Aᵀ ⊗ X_Bᵀ) from the
operators' eigendecompositions (Lynch, Rice & Thomas 1964):

  - ``rfft`` and ``fft`` (circulant operators): one ``torch.fft`` pair and a
    pointwise product;
  - ``matmul`` (Hermitian operators): the eigenvectors come from
    ``np.linalg.eigh`` on the host, once, and the rhs is rotated axis by
    axis with ``torch.matmul`` in full fp32 or fp64 (TF32 stays off).

The eigenvalues are host numpy, computed once at set-up; they move to the
rhs's device on first use. The rhs's *trailing* ``ndim`` axes match the
operators, so leading batch dims pass through.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence

import numpy as np
import torch

Tensor = torch.Tensor


def outer_sum(x: Sequence) -> object:
    """Outer sum of 1-D arrays: out[i,j,k] = a[i] + b[j] + c[k]."""
    return functools.reduce(lambda a, b: a[..., None] + b, x)


def _np_dtype(dtype) -> np.dtype:
    if isinstance(dtype, torch.dtype):
        return np.dtype(torch.empty((), dtype=dtype).numpy().dtype)
    return np.dtype(dtype)


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros((), dtype=np.dtype(dtype))).dtype


def _narrow_diagonals(diagonals, dtype) -> np.ndarray:
    """Narrows the set-up eigenvalue diagonals to the working precision.

    Symmetric circulant operators have real eigenvalues, so the ~0
    imaginary part of the numpy FFT is dropped.
    """
    diagonals = np.asarray(diagonals)
    if np.iscomplexobj(diagonals):
        scale = max(float(np.abs(diagonals).max()), 1e-30)
        if float(np.abs(diagonals.imag).max()) <= 1e-10 * scale:
            diagonals = diagonals.real
    dtype = _np_dtype(dtype)
    if np.iscomplexobj(diagonals):
        return diagonals.astype(np.result_type(dtype, np.complex64))
    return diagonals.astype(np.finfo(dtype).dtype)


class _OnDevice:
    """Host numpy constants, copied to a device once per device."""

    def __init__(self, *arrays: np.ndarray):
        self.arrays = arrays
        self.cache = {}

    def __call__(self, device) -> tuple:
        key = str(device)
        if key not in self.cache:
            self.cache[key] = tuple(torch.as_tensor(a, device=device) for a in self.arrays)
        return self.cache[key]


def _check_shape(rhs: Tensor, shape) -> None:
    if tuple(rhs.shape[-len(shape):]) != tuple(shape):
        raise ValueError(
            f"rhs.shape={tuple(rhs.shape)} does not end with operator shape={shape}"
        )


def transform(
    func: Callable[[np.ndarray], np.ndarray],
    operators: Sequence[np.ndarray],
    dtype,
    *,
    hermitian: bool = False,
    circulant: bool = False,
    implementation: Optional[str] = None,
) -> Callable[[Tensor], Tensor]:
    """Returns a function that applies F(⊕ᵢ opᵢ) to an rhs.

    Args:
      func: applied, on the host, to the N-D array of summed eigenvalues.
      operators: square matrices, one per grid axis.
      dtype: dtype of the right-hand side (torch or numpy).
      hermitian: all operators are Hermitian (required for 'matmul').
      circulant: all operators are circulant (required for 'fft'/'rfft').
      implementation: 'matmul' | 'fft' | 'rfft'. Default 'rfft', and
        'matmul' where the last axis is odd.
    """
    operators = [np.asarray(op) for op in operators]
    if any(op.ndim != 2 or op.shape[0] != op.shape[1] for op in operators):
        raise ValueError(
            "operators are not all square matrices. Shapes are "
            + ", ".join(str(op.shape) for op in operators)
        )
    if implementation is None:
        implementation = "rfft"
    if implementation == "rfft" and operators[-1].shape[0] % 2:
        implementation = "matmul"

    if implementation == "matmul":
        if not hermitian:
            raise ValueError(
                'non-hermitian operators not yet supported with implementation="matmul"'
            )
        return _hermitian_matmul_transform(func, operators, dtype)
    if implementation in ("fft", "rfft"):
        if not circulant:
            raise ValueError(
                "non-circulant operators not yet supported with "
                f'implementation="{implementation}"'
            )
        if implementation == "fft":
            return _circulant_fft_transform(func, operators, dtype)
        return _circulant_rfft_transform(func, operators, dtype)
    raise ValueError(f"invalid implementation: {implementation}")


def _hermitian_matmul_transform(func, operators, dtype) -> Callable[[Tensor], Tensor]:
    """Fast diagonalization by per-axis eigenvector products."""
    eigenvalues, eigenvectors = zip(*(np.linalg.eigh(op) for op in operators))
    summed_eigenvalues = outer_sum(eigenvalues)
    np_dtype = _np_dtype(dtype)
    diagonals = np.asarray(func(summed_eigenvalues), np_dtype)
    shape = summed_eigenvalues.shape
    if diagonals.shape != shape:
        raise ValueError(
            "output shape from func() does not match input shape: "
            f"{diagonals.shape} vs {shape}"
        )
    constants = _OnDevice(diagonals, *(np.asarray(v, np_dtype) for v in eigenvectors))
    ndim = len(operators)
    out_dtype = _torch_dtype(dtype)

    def _contract(x: Tensor, mat: Tensor, axis: int) -> Tensor:
        # x's axis against mat's rows: (…, n, …) -> (…, n, …)
        return torch.matmul(x.movedim(axis, -1), mat).movedim(-1, axis)

    def apply(rhs: Tensor) -> Tensor:
        _check_shape(rhs, shape)
        diag, *vectors = constants(rhs.device)
        # full-precision products: TF32 would miss the solver's tolerances
        torch.backends.cuda.matmul.allow_tf32 = False
        out = rhs.to(out_dtype)
        for i, v in enumerate(vectors):  # into the eigenbasis: Vᵀx
            out = _contract(out, v, i - ndim)
        out = out * diag
        for i, v in enumerate(vectors):  # back: Vx
            out = _contract(out, v.T, i - ndim)
        return out

    return apply


def _circulant_fft_transform(func, operators, dtype) -> Callable[[Tensor], Tensor]:
    """Fast diagonalization by an N-D FFT (circulant operators)."""
    eigenvalues = [np.fft.fft(op[:, 0]) for op in operators]
    summed_eigenvalues = outer_sum(eigenvalues)
    diagonals = _narrow_diagonals(func(summed_eigenvalues), dtype)
    shape = tuple(op.shape[0] for op in operators)
    if diagonals.shape != shape:
        raise ValueError(
            "output shape from func() does not match input shape: "
            f"{diagonals.shape} vs {shape}"
        )
    constants = _OnDevice(diagonals)
    dims = tuple(range(-len(operators), 0))
    out_dtype = _torch_dtype(dtype)

    def apply(rhs: Tensor) -> Tensor:
        _check_shape(rhs, shape)
        (diag,) = constants(rhs.device)
        out = torch.fft.ifftn(diag * torch.fft.fftn(rhs, dim=dims), dim=dims)
        return out if rhs.is_complex() else out.real.to(out_dtype)

    return apply


def _circulant_rfft_transform(func, operators, dtype) -> Callable[[Tensor], Tensor]:
    """Fast diagonalization by an N-D real FFT (even last axis required)."""
    if operators[-1].shape[0] % 2:
        raise ValueError(
            'implementation="rfft" currently requires an even size for the last axis'
        )
    eigenvalues = [np.fft.fft(op[:, 0]) for op in operators[:-1]] + [
        np.fft.rfft(operators[-1][:, 0])
    ]
    summed_eigenvalues = outer_sum(eigenvalues)
    diagonals = _narrow_diagonals(func(summed_eigenvalues), dtype)
    if diagonals.shape != summed_eigenvalues.shape:
        raise ValueError(
            "output shape from func() does not match input shape: "
            f"{diagonals.shape} vs {summed_eigenvalues.shape}"
        )
    constants = _OnDevice(diagonals)
    dims = tuple(range(-len(operators), 0))
    sizes = tuple(op.shape[0] for op in operators)
    out_dtype = _torch_dtype(dtype)

    def apply(rhs: Tensor) -> Tensor:
        (diag,) = constants(rhs.device)
        out = torch.fft.irfftn(diag * torch.fft.rfftn(rhs, dim=dims), s=sizes, dim=dims)
        return out.to(out_dtype)

    return apply


def _pseudoinverse_func(dtype, cutoff: Optional[float]):
    if cutoff is None:
        cutoff = 10 * np.finfo(_np_dtype(dtype)).eps

    def func(eigs):
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.where(np.abs(eigs) > cutoff, 1 / eigs, 0)

    return func


def pseudoinverse_transform(
    operators: Sequence[np.ndarray],
    dtype,
    *,
    hermitian: bool = False,
    circulant: bool = False,
    implementation: Optional[str] = None,
    cutoff: Optional[float] = None,
) -> Callable[[Tensor], Tensor]:
    """Returns a function that applies the pseudoinverse of ⊕ᵢ opᵢ.

    Eigenvalues with |λ| < cutoff are zeroed instead of inverted (the
    Poisson null space). The eigendecomposition happens once, here.
    """
    return transform(_pseudoinverse_func(dtype, cutoff), operators, dtype,
                     hermitian=hermitian, circulant=circulant,
                     implementation=implementation)


def pseudoinverse(
    v: Tensor,
    operators: Sequence[np.ndarray],
    dtype,
    *,
    hermitian: bool = False,
    circulant: bool = False,
    implementation: Optional[str] = None,
    cutoff: Optional[float] = None,
) -> Tensor:
    """Applies the pseudoinverse of ⊕ᵢ opᵢ to ``v``."""
    return pseudoinverse_transform(
        operators, dtype, hermitian=hermitian, circulant=circulant,
        implementation=implementation, cutoff=cutoff)(v)

"""rfft2/irfft2 as dense DFT matrix products (PyTorch).

Counterpart of ``tpu_cfd/ops/dft2d.py``. The matrices are host-side numpy
constants built exactly as the JAX package builds them (float64 angles, then
cast), and the products are ``torch.matmul``. Layouts:

- full: ``(..., n, m)`` spectra with ``m`` up to ``n//2+1``;
- aligned: ``m = n//2`` (the Nyquist column dropped);
- Galerkin block: ``(..., len(rows), m)`` on the 2/3-rule dealiasing
  support (``galerkin_block``).

Precision strings (``"highest"``, ``"high"``, ``"default"``) are kept for
API parity with the JAX package. On the card all three compute in full
fp32: each call sets ``torch.backends.cuda.matmul.allow_tf32 = False``
explicitly. Mapping ``high``/``default`` onto TF32 or bf16 is later work.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

Tensor = torch.Tensor

PRECISIONS = ("highest", "high", "default")


@functools.lru_cache(maxsize=None)
def _mats(n: int, m: int, dtype_str: str):
    """Host-side DFT matrices for an n-point axis, m spectrum columns kept.

    Returns a dict of numpy arrays:
      fwd_last_re/im:  (n, m)  real input -> half spectrum (last axis)
      fwd_first_re/im: (n, n)  full DFT along the first (row) axis
      inv_first_re/im: (n, n)  inverse full DFT (rows), 1/n normalized
      inv_last_re/im:  (m, n)  half spectrum -> real output, Hermitian
                               multiplicities folded in, 1/n normalized
    """
    f = np.float64 if dtype_str == "float64" else np.float32
    j = np.arange(n)
    k = np.arange(m)
    ang_last = 2 * np.pi * np.outer(j, k) / n
    ang_first = 2 * np.pi * np.outer(j, j) / n
    w = np.full((m,), 2.0)
    w[0] = 1.0
    if n % 2 == 0 and m == n // 2 + 1:
        w[-1] = 1.0
    return {
        "fwd_last_re": np.cos(ang_last).astype(f),
        "fwd_last_im": (-np.sin(ang_last)).astype(f),
        "fwd_first_re": np.cos(ang_first).astype(f),
        "fwd_first_im": (-np.sin(ang_first)).astype(f),
        "inv_first_re": (np.cos(ang_first) / n).astype(f),
        "inv_first_im": (np.sin(ang_first) / n).astype(f),
        "inv_last_re": ((w[:, None] * np.cos(ang_last.T)) / n).astype(f),
        "inv_last_im": ((-w[:, None] * np.sin(ang_last.T)) / n).astype(f),
    }


@functools.lru_cache(maxsize=None)
def _mats_rows(n: int, rows: tuple, dtype_str: str):
    """First-axis DFT matrices restricted to a subset of signed modes.

    ``rows`` are full-spectrum row indices (fft ordering) of the kept x
    modes. Returns fwd (len(rows), n) and inv (n, len(rows)) re/im pairs;
    the inverse carries the 1/n normalization.
    """
    f = np.float64 if dtype_str == "float64" else np.float32
    j = np.arange(n)
    k = np.asarray(rows)
    ang = 2 * np.pi * np.outer(k, j) / n
    return {
        "fwd_re": np.cos(ang).astype(f),
        "fwd_im": (-np.sin(ang)).astype(f),
        "inv_re": (np.cos(ang.T) / n).astype(f),
        "inv_im": (np.sin(ang.T) / n).astype(f),
    }


def galerkin_block(n: int):
    """(rows, m) of the 2/3-rule dealiasing support on an n×n rfft2 spectrum.

    Signed x modes -kmax ≤ kx < kmax with kmax = (2n/3)//2, mode 0 first,
    and the low ``int(2/3*(n//2+1))`` y columns.
    """
    kmax_x = int(2 / 3 * n) // 2
    rows = tuple(range(kmax_x)) + tuple(range(n - kmax_x, n))
    m = int(2 / 3 * (n // 2 + 1))
    return rows, m


def _dtype_str(t: Tensor) -> str:
    return "float64" if t.dtype in (torch.float64, torch.complex128) else "float32"


@functools.lru_cache(maxsize=64)
def _on_device(kind: str, n: int, key, dtype_str: str, device: str, name: str):
    src = _mats(n, key, dtype_str) if kind == "full" else _mats_rows(n, key, dtype_str)
    return torch.from_numpy(src[name]).to(device)


def _full(n, m, dtype_str, device, name):
    return _on_device("full", n, m, dtype_str, str(device), name)


def _rows(n, rows, dtype_str, device, name):
    return _on_device("rows", n, tuple(rows), dtype_str, str(device), name)


def set_matmul_precision(precision: str) -> None:
    """Validates ``precision`` and pins fp32 matmuls to full fp32 on the card."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    torch.backends.cuda.matmul.allow_tf32 = False


def _first_axis(Gre, Gim, xre, xim):
    yre = torch.matmul(Gre, xre) - torch.matmul(Gim, xim)
    yim = torch.matmul(Gre, xim) + torch.matmul(Gim, xre)
    return yre, yim


def rfft2_block(x: Tensor, rows: tuple, m: int, precision="highest") -> Tensor:
    """rfft2 restricted to the (rows, m) mode block (Galerkin truncation).

    x: real ``(..., n, n)`` -> complex ``(..., len(rows), m)``.
    """
    set_matmul_precision(precision)
    n = x.shape[-1]
    if x.shape[-2] != n:
        raise ValueError("square trailing axes required")
    d, dev = _dtype_str(x), x.device
    yre = torch.matmul(x, _full(n, m, d, dev, "fwd_last_re"))
    yim = torch.matmul(x, _full(n, m, d, dev, "fwd_last_im"))
    zre, zim = _first_axis(_rows(n, rows, d, dev, "fwd_re"),
                           _rows(n, rows, d, dev, "fwd_im"), yre, yim)
    return torch.complex(zre, zim)


def irfft2_block(x: Tensor, n: int, rows: tuple, precision="highest") -> Tensor:
    """irfft2 of a (rows, m) mode block back to the full ``(..., n, n)`` grid.

    Modes outside the block are treated as zero.
    """
    set_matmul_precision(precision)
    m = x.shape[-1]
    if x.shape[-2] != len(rows):
        raise ValueError("block row count mismatch")
    d, dev = _dtype_str(x), x.device
    yre, yim = _first_axis(_rows(n, rows, d, dev, "inv_re"),
                           _rows(n, rows, d, dev, "inv_im"), x.real, x.imag)
    out = torch.matmul(yre, _full(n, m, d, dev, "inv_last_re"))
    return out + torch.matmul(yim, _full(n, m, d, dev, "inv_last_im"))


def rfft2_matmul(x: Tensor, precision="highest", m: int | None = None) -> Tensor:
    """``torch.fft.rfft2`` over the last two axes via dense matrix products.

    x: real ``(..., n, n)`` -> complex ``(..., n, m)`` (m defaults to n//2+1).
    """
    set_matmul_precision(precision)
    n = x.shape[-1]
    if x.shape[-2] != n:
        raise ValueError("square trailing axes required")
    m = n // 2 + 1 if m is None else m
    d, dev = _dtype_str(x), x.device
    yre = torch.matmul(x, _full(n, m, d, dev, "fwd_last_re"))
    yim = torch.matmul(x, _full(n, m, d, dev, "fwd_last_im"))
    zre, zim = _first_axis(_full(n, m, d, dev, "fwd_first_re"),
                           _full(n, m, d, dev, "fwd_first_im"), yre, yim)
    return torch.complex(zre, zim)


def irfft2_matmul(x: Tensor, precision="highest") -> Tensor:
    """``torch.fft.irfft2`` over the last two axes via dense matrix products.

    x: complex ``(..., n, m)`` with m ≤ n//2+1 -> real ``(..., n, n)``;
    columns beyond m are treated as zero.
    """
    set_matmul_precision(precision)
    n, m = x.shape[-2], x.shape[-1]
    if m > n // 2 + 1:
        raise ValueError("spectrum axis wider than the half spectrum")
    d, dev = _dtype_str(x), x.device
    yre, yim = _first_axis(_full(n, m, d, dev, "inv_first_re"),
                           _full(n, m, d, dev, "inv_first_im"), x.real, x.imag)
    out = torch.matmul(yre, _full(n, m, d, dev, "inv_last_re"))
    return out + torch.matmul(yim, _full(n, m, d, dev, "inv_last_im"))

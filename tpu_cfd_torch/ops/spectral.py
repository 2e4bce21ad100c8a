"""2-D Fourier calculus helpers for the pseudo-spectral solver (PyTorch).

Counterpart of ``tpu_cfd/ops/spectral.py``. Frequencies are *ordinal*
(cycles per unit length, ``fftfreq``); derivative factors are ``2j*pi*k``.
Spectra are rfft2 half-spectra ``(..., n, n//2+1)`` with leading batch dims.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from tpu_cfd_torch import grids

Tensor = torch.Tensor
Grid = grids.Grid


def fft_mesh_2d(n: int, diam: float, dtype=torch.float32, device=None
                ) -> Tuple[Tensor, Tensor]:
    """Full-spectrum ordinal frequency meshes for an n×n grid of extent diam."""
    k = torch.as_tensor(np.fft.fftfreq(n, d=diam / n), device=device).to(dtype)
    kx, ky = torch.meshgrid(k, k, indexing="ij")
    return kx, ky


def rfft_mesh_2d(n: int, diam: float, dtype=torch.float32, device=None
                 ) -> Tuple[Tensor, Tensor]:
    """Half-spectrum (rfft2) ordinal frequency meshes."""
    kx, ky = fft_mesh_2d(n, diam, dtype, device)
    k_max = n // 2
    return kx[..., : k_max + 1], ky[..., : k_max + 1]


def fft_expand_dims(fft_mesh: Tuple[Tensor, Tensor], batch_size: int
                    ) -> Tuple[Tensor, Tensor]:
    """Expands (x, y) meshes to (b, x, y, 1) for broadcasting over batches."""
    return tuple(k[None, :, :, None].expand(batch_size, *k.shape, 1) for k in fft_mesh)


def spectral_laplacian_2d(fft_mesh: Tuple[Tensor, Tensor]) -> Tensor:
    """Fourier symbol of the Laplacian: -4π²(kx²+ky²), with lap[0,0]=1.

    The zero mode is set to 1 so that the stream-function solve never
    divides by zero; mean-free vorticity has a zero mean mode.
    """
    kx, ky = fft_mesh
    lap = -4 * (math.pi**2) * (kx.abs() ** 2 + ky.abs() ** 2)
    lap = lap.clone()
    lap[..., 0, 0] = 1.0
    return lap


def spectral_curl_2d(
    vhat: Tuple[Tensor, Tensor], rfft_mesh: Tuple[Tensor, Tensor]
) -> Tensor:
    """2-D curl in the Fourier basis: 2πi (kx v̂ - ky û)."""
    uhat, vhat_ = vhat
    kx, ky = rfft_mesh
    return 2j * math.pi * (vhat_ * kx - uhat * ky)


def spectral_div_2d(
    vhat: Tuple[Tensor, Tensor], rfft_mesh: Tuple[Tensor, Tensor]
) -> Tensor:
    """2-D divergence in the Fourier basis: 2πi (kx û + ky v̂)."""
    uhat, vhat_ = vhat
    kx, ky = rfft_mesh
    return 2j * math.pi * (uhat * kx + vhat_ * ky)


def spectral_grad_2d(
    vhat: Tensor, rfft_mesh: Tuple[Tensor, Tensor]
) -> Tuple[Tensor, Tensor]:
    """Fourier-domain gradient (∂x, ∂y)."""
    kx, ky = rfft_mesh
    return 2j * math.pi * kx * vhat, 2j * math.pi * ky * vhat


def spectral_rot_2d(
    vhat: Tensor, rfft_mesh: Tuple[Tensor, Tensor]
) -> Tuple[Tensor, Tensor]:
    """Perpendicular gradient (∂y, -∂x): velocity from a stream function."""
    vgradx, vgrady = spectral_grad_2d(vhat, rfft_mesh)
    return vgrady, -vgradx


def brick_wall_mask_2d(n: int) -> np.ndarray:
    """Boolean 2/3-rule keep mask on an ``(n, n//2+1)`` rfft2 spectrum.

    Signed ``-kmax <= kx < kmax`` with ``kmax = int(2n/3)//2`` on the full
    axis, and the low ``int(2/3*(n//2+1))`` columns of the half axis.
    """
    kmax_x = int(2 / 3 * n) // 2
    kx = np.round(np.fft.fftfreq(n) * n).astype(int)
    keep_x = (-kmax_x <= kx) & (kx < kmax_x)
    keep_y = np.arange(n // 2 + 1) < int(2 / 3 * (n // 2 + 1))
    return np.outer(keep_x, keep_y)


def brick_wall_filter_2d(grid: Grid, dtype=torch.float32, device=None) -> Tensor:
    """2/3-rule dealiasing mask on the rfft2 spectrum, as a tensor."""
    n, _ = grid.shape
    return torch.as_tensor(brick_wall_mask_2d(n), device=device).to(dtype)


def vorticity_to_velocity(
    grid: Grid,
    w_hat: Tensor,
    rfft_mesh: Optional[Tuple[Tensor, Tensor]] = None,
) -> Tuple[Tuple[Tensor, Tensor], Tensor]:
    """Solves the stream function ψ̂ = -ŵ/Δ̂ and returns (û, v̂), ψ̂."""
    if rfft_mesh is None:
        rfft_mesh = grid.rfft_mesh(dtype=w_hat.real.dtype, device=w_hat.device)
    kx, ky = rfft_mesh
    if tuple(kx.shape[-2:]) != tuple(w_hat.shape[-2:]):
        raise ValueError("frequency mesh/spectrum mismatch")
    stream_hat = -w_hat / spectral_laplacian_2d((kx, ky))
    velocity_hat = spectral_rot_2d(stream_hat, (kx, ky))
    return velocity_hat, stream_hat

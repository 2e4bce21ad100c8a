"""Functional-norm losses: L2/Lp, the fractional Sobolev norm, the Bochner
norm and the space-time NSE residual.

Counterpart of ``tpu_cfd/train/losses.py``. The losses are plain callables;
the Sobolev weights are host float64 constants built once and cast to the
input's real dtype and device at call time. ``ResidualLoss`` keeps its
wave-number meshes as float32 host arrays, as the JAX package does, so an
fp64 input sees the same fp32-rounded meshes there and here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor

# numpy's pad modes (the JAX package's names) -> torch's
_PAD_MODES = {"edge": "replicate", "wrap": "circular"}


def central_diff(u: Tensor, h: Optional[float] = None, mode: str = "constant"
                 ) -> Tuple[Tensor, Tensor]:
    """Central-difference spatial gradients with 1-cell padding.

    ``u``: (..., n, n) with the two spatial dims last.
    """
    n = u.shape[-1]
    h = 1 / n if h is None else h
    lead = u.shape[:-2]
    mode = _PAD_MODES.get(mode, mode)
    u = F.pad(u.reshape(-1, 1, n, n), (1, 1, 1, 1), mode=mode).reshape(
        *lead, n + 2, n + 2)
    d, s = 2, 1
    gradx = (u[..., d:, s:-s] - u[..., :-d, s:-s]) / d
    grady = (u[..., s:-s, d:] - u[..., s:-s, :-d]) / d
    return gradx / h, grady / h


@dataclasses.dataclass
class L2Loss2d:
    """Relative L2 with an optional H¹-seminorm regularizer."""

    regularizer: bool = False
    h: float = 1 / 512
    beta: float = 1.0
    gamma: float = 1e-1
    metric_reduction: str = "L1"
    eps: float = 1e-3
    weighted: bool = False

    def __call__(self, preds: Tensor, targets: Tensor,
                 targets_grad: Optional[Tensor] = None,
                 K: Optional[Tensor] = None,
                 weights: Optional[Tensor] = None) -> Tensor:
        K = 1.0 if K is None else K ** 0.5
        sum_dims = tuple(range(1, preds.ndim))
        target_norm = (targets ** 2).sum(dim=sum_dims) + self.eps

        if weights is None and self.weighted:
            inv_l2 = 1 / torch.sqrt(target_norm)
            weights = inv_l2 / inv_l2.mean()
        elif not self.weighted:
            weights = 1.0

        loss = (self.beta * weights * ((preds - targets) ** 2).sum(dim=sum_dims)
                / target_norm)

        if targets_grad is not None and self.gamma > 0:
            grad_dims = tuple(range(1, targets_grad.ndim))
            targets_prime_norm = 2 * (K * targets_grad ** 2).mean(dim=grad_dims) + self.eps
            preds_grad = torch.cat(central_diff(preds), dim=1)
            grad_diff = (K * (preds_grad - targets_grad)) ** 2
            loss = loss + self.gamma * grad_diff.mean(dim=grad_dims) / targets_prime_norm

        if self.metric_reduction == "L2":
            return torch.sqrt(loss.mean())
        if self.metric_reduction == "L1":
            return torch.sqrt(loss).mean()
        if self.metric_reduction == "Linf":
            return torch.sqrt(loss).max()
        raise ValueError(f"unknown metric_reduction: {self.metric_reduction}")


@dataclasses.dataclass
class LpLoss:
    """The original FNO relative/absolute Lp loss."""

    d: int = 2
    p: int = 2
    h: Optional[float] = None
    size_average: bool = True
    reduction: bool = True
    relative: bool = False

    def _reduce(self, x: Tensor) -> Tensor:
        if self.reduction:
            return x.mean() if self.size_average else x.sum()
        return x

    def abs(self, x: Tensor, y: Tensor) -> Tensor:
        bsz = x.shape[0]
        h = 1.0 / (x.shape[1] - 1.0) if self.h is None else self.h
        diff_norms = torch.linalg.vector_norm((x - y).reshape(bsz, -1), ord=self.p, dim=1)
        return self._reduce((h ** (self.d / self.p)) * diff_norms)

    def rel(self, x: Tensor, y: Tensor) -> Tensor:
        bsz = x.shape[0]
        diff_norms = torch.linalg.vector_norm((x - y).reshape(bsz, -1), ord=self.p, dim=1)
        y_norms = torch.linalg.vector_norm(y.reshape(bsz, -1), ord=self.p, dim=1)
        return self._reduce(diff_norms / y_norms)

    def __call__(self, x: Tensor, y: Tensor) -> Tensor:
        return self.rel(x, y) if self.relative else self.abs(x, y)


class SobolevLoss:
    """Fractional Sobolev norm ‖(α-Δ)^{s/2}(u-v)‖ in the Fourier domain.

    Fractional order ``norm_order`` (s), frequency cutoff, relative
    Bochner-style time aggregation (∫_T ‖·‖² dt)^{1/2}. Inputs are
    ``(b, n, n, T)`` (time last by default). With ``norm_order == 0`` the
    weight is ``sqrt(alpha + 4π²|k|²)`` itself, as in the JAX package.
    """

    def __init__(self, n_grid: int = 256, time_average: bool = True,
                 reduction: bool = True, mesh_weighted: bool = True,
                 relative: bool = False, inp_time_last: bool = True,
                 freq_cutoff: Optional[int] = None, norm_order: float = -1,
                 alpha: float = 0.1, fft_norm: str = "backward",
                 diam: float = 1.0):
        self.relative = relative
        self.time_average = time_average
        self.reduction = reduction
        self.mesh_weighted = mesh_weighted
        self.norm_order = norm_order
        self.alpha = alpha
        self.fft_norm = fft_norm
        self.inp_time_last = inp_time_last
        self.n_grid = n_grid
        self._set_weight(n_grid, diam, norm_order, freq_cutoff)
        self._weights = {}

    def _set_weight(self, n, diam, norm_order, freq_cutoff):
        k = np.fft.fftfreq(n, d=diam / n)
        kx, ky = np.meshgrid(k, k, indexing="ij")
        kx = kx[None, :, :, None]
        ky = ky[None, :, :, None]
        if freq_cutoff is None:
            freq_cutoff = n // 2 + 1
        freq_cutoff = freq_cutoff / diam
        # negative orders send the cut modes to zero weight (1/inf),
        # positive orders zero them directly
        cutoff_val = np.inf if norm_order < 0 else 0.0
        kx = np.where(np.abs(kx) > freq_cutoff, cutoff_val, kx)
        ky = np.where(np.abs(ky) > freq_cutoff, cutoff_val, ky)
        self.weight = np.sqrt(self.alpha + 4 * np.pi ** 2 * (kx ** 2 + ky ** 2))

    def _weight(self, dtype: torch.dtype, device) -> Tensor:
        key = (dtype, str(device))
        if key not in self._weights:
            w = torch.from_numpy(self.weight).to(device=device, dtype=dtype)
            w = w ** (self.norm_order / 2) if self.norm_order != 0 else w
            # guard 1/inf -> 0 for the cutoff modes with negative orders
            self._weights[key] = torch.where(torch.isfinite(w), w, torch.zeros_like(w))
        return self._weights[key]

    def __call__(self, x: Tensor, y: Optional[Tensor] = None) -> Tensor:
        bsz = x.shape[0]
        n = self.n_grid
        if not self.inp_time_last:
            x = torch.movedim(x, 1, -1)
            if y is not None:
                y = torch.movedim(y, 1, -1)
        nt = x.shape[-1]

        x = torch.fft.fftn(x, dim=(1, 2), norm=self.fft_norm).reshape(bsz, n, n, -1)
        if y is None:
            y = torch.zeros_like(x)
        else:
            y = torch.fft.fftn(y, dim=(1, 2), norm=self.fft_norm).reshape(bsz, n, n, -1)

        w = self._weight(x.real.dtype, x.device)
        x = x * w
        y = y * w
        diff_freq = torch.linalg.vector_norm(x - y, dim=(1, 2))     # (bsz, T)
        if self.relative:
            y2_norms = torch.linalg.vector_norm(y, dim=(1, 2))
            y2_norms = torch.sqrt((y2_norms ** 2).sum(dim=-1))
        else:
            y2_norms = torch.ones((bsz,), dtype=diff_freq.dtype, device=x.device)

        loss = torch.sqrt((diff_freq ** 2).sum(dim=-1))
        y2_norms = y2_norms / n if self.mesh_weighted else y2_norms
        loss = loss / y2_norms
        loss = loss / math.sqrt(nt) if self.time_average else loss
        loss = loss.mean(0) if self.reduction else loss.sum(0)
        return loss / n if self.mesh_weighted else loss


class BochnerNorm(SobolevLoss):
    """(∫_T ‖u‖_p² dt)^{1/2} of ``u`` ``(b, n, n, T)`` (time first unless
    ``time_last``); with ``dt`` None the time integral is a mean."""

    def __init__(self, n_grid: int = 256, dt: Optional[float] = None, p: int = 2,
                 relative: bool = True, mesh_weighted: bool = True,
                 reduction: bool = True, time_average: bool = False,
                 time_last: bool = False):
        super().__init__(n_grid=n_grid, relative=relative, inp_time_last=time_last,
                         reduction=reduction, mesh_weighted=mesh_weighted,
                         time_average=time_average)
        self.dt = dt
        self.p = p
        self.time_last = time_last

    def __call__(self, u: Tensor) -> Tensor:
        n = self.n_grid
        if u.ndim == 3:
            u = u[None]
        if not self.time_last:
            u = torch.movedim(u, 1, -1)
        norm_space = (u.abs() ** self.p).sum(dim=(1, 2)) ** (1 / self.p)
        norm_space = norm_space / n if self.mesh_weighted else norm_space
        if self.dt is not None:
            norm = torch.sqrt((norm_space ** 2).sum(dim=-1) * self.dt)
        else:
            norm = torch.sqrt((norm_space ** 2).mean(dim=-1))
        return norm.mean() if self.reduction else norm.sum()


class ResidualLoss:
    """The NSE residual of a trajectory ``(b, n, n, T)`` in the space-time
    Fourier domain, the time derivative taken spectrally (2πi k_t): how well
    a predicted trajectory satisfies the vorticity equation."""

    def __init__(self, alpha: float = 1e-1, visc: float = 1e-3, n_grid: int = 64,
                 n_t: int = 40, delta_t: float = 1e-2, norm: str = "ortho"):
        self.alpha = alpha
        self.visc = visc
        self.n_grid = n_grid
        self.n_t = n_t
        self.delta_t = delta_t
        self.norm = norm
        n = n_grid
        kx = np.fft.fftfreq(n, d=1 / n)
        ky = np.fft.fftfreq(n, d=1 / n)
        kt = np.fft.fftfreq(n_t, d=delta_t)
        kx, ky, kt = np.meshgrid(kx, ky, kt, indexing="ij")
        lap = -4 * np.pi ** 2 * (kx ** 2 + ky ** 2)
        lap[0, 0, :] = 1.0
        self.kx = kx.astype(np.float32)
        self.ky = ky.astype(np.float32)
        self.kt = kt.astype(np.float32)
        self.lap = lap.astype(np.float32)

    def __call__(self, w: Tensor, psi: Optional[Tensor] = None,
                 f: Optional[Tensor] = None) -> Tensor:
        n = w.shape[1]
        dims, norm = (1, 2, 3), self.norm

        def fftn(z):
            return torch.fft.fftn(z, dim=dims, norm=norm)

        def ifftn(z):
            return torch.fft.ifftn(z, dim=dims, norm=norm)

        def const(a):
            # float32 host products, promoted to the input's precision by the
            # operation that uses them, as numpy constants are under JAX
            return torch.from_numpy(a).to(w.device)

        # the wave numbers times 2πi, each rounded to float32 on the host
        ikx, iky, ikt = (const(2 * np.pi * k * 1j) for k in (self.kx, self.ky, self.kt))
        mikx = const(-2.0 * np.pi * self.kx * 1j)
        lap = const(self.lap)

        w_h = fftn(w)
        w_h_t = fftn(ifftn(ikt * w_h))
        psi_h = fftn(psi) if psi is not None else -w_h / lap
        q = ifftn(iky * psi_h)
        v = ifftn(mikx * psi_h)
        w_x = ifftn(ikx * w_h)
        w_y = ifftn(iky * w_h)
        convection = fftn(q * w_x + v * w_y)
        ff = torch.zeros_like(w_h) if f is None else fftn(f)
        residual = (w_h_t + convection - self.visc * (lap * w_h) - ff).real
        return torch.linalg.vector_norm(residual, dim=(-1, -2)).mean() / n

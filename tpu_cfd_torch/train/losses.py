"""Functional-norm losses: L2/Lp and the fractional Sobolev norm.

Counterpart of ``tpu_cfd/train/losses.py``. The losses are plain callables;
the Sobolev weights are host float64 constants built once and cast to the
input's real dtype and device at call time. ``BochnerNorm`` and
``ResidualLoss`` wait for the fine-tuning slice (ROADMAP.md Queue A item 4).
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

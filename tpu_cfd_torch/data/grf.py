"""Gaussian random fields with covariance (-Δ + τ²)^(-α) (PyTorch).

Counterpart of ``tpu_cfd/data/grf.py``. The sampler takes its white noise
from a ``torch.Generator`` or, for the tests, as a tensor (``noise=``). With
``smoothing=True`` the noise is drawn at ``max_mesh_size``² and resized to
n² (bilinear, antialiased, the counterpart of ``jax.image.resize(...,
"bilinear")``), so that every target resolution sees the same realization.
That noise is drawn and resized one sample at a time, so memory holds one
``(2, max_mesh_size, max_mesh_size)`` draw (32 MiB in fp32 at 2048²)
whatever the batch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def _resize_bilinear(x: Tensor, n: int) -> Tensor:
    """(..., m, m) -> (..., n, n), bilinear and antialiased."""
    lead, m = x.shape[:-2], x.shape[-1]
    if m == n:
        return x
    y = F.interpolate(x.reshape(-1, 1, m, m), size=(n, n), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.reshape(*lead, n, n)


@dataclasses.dataclass
class GRF2d:
    """2-D mean-zero GRF sampler on [0,1]² (periodic spectral construction).

    ``alpha`` sets the smoothness (alpha > d/2 = 1); ``tau`` damps or boosts
    the high frequencies. ``sqrt_eig`` is the square root of the covariance
    spectrum.
    """

    dim: int = 2
    n: int = 128
    alpha: float = 2.0
    tau: float = 3.0
    normalize: bool = False
    smoothing: bool = False
    max_mesh_size: int = 2048
    dtype: torch.dtype = torch.float32
    # ``sample``'s spectra, one a (parameters, n, device)
    _spectra: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                       compare=False)

    def sqrt_eig(self, n: Optional[int] = None, device=None) -> Tensor:
        n = self.n if n is None else n
        sigma = self.tau ** (0.5 * (2 * self.alpha - self.dim))
        k = torch.as_tensor(np.fft.fftfreq(n, d=1.0 / n), device=device).to(self.dtype)
        kx, ky = torch.meshgrid(k, k, indexing="ij")
        sqrt_eig = (
            (n**self.dim)
            * math.sqrt(2.0)
            * sigma
            * ((4 * (math.pi**2) * (kx**2 + ky**2) + self.tau**2) ** (-self.alpha / 2.0))
        )
        sqrt_eig[0, 0] = 0.0
        return sqrt_eig

    def _spectrum(self, n: int, device) -> Tensor:
        """``sqrt_eig(n, device)``, built once: built anew it copies the
        wavenumbers from the host, a copy that waits for every operation
        queued on the device, which a sampler called a sample at a time
        would pay once a sample."""
        key = (self.dim, self.alpha, self.tau, self.dtype, n, device)
        if key not in self._spectra:
            self._spectra[key] = self.sqrt_eig(n, device=device)
        return self._spectra[key]

    def sample(
        self,
        generator: Optional[torch.Generator] = None,
        bsz: int = 1,
        n: Optional[int] = None,
        noise: Optional[Tensor] = None,
        device=None,
    ) -> Tensor:
        """Samples ``(bsz, n, n)`` fields.

        The white noise is ``noise`` (``(bsz, 2, n0, n0)``, n0 being
        ``max_mesh_size`` with ``smoothing`` and n without) or ``bsz`` draws
        of ``(2, n0, n0)`` from ``generator``, on ``device`` (the generator's
        by default).
        """
        n = self.n if n is None else n
        n0 = self.max_mesh_size if self.smoothing else n
        if noise is None:
            if generator is None:
                raise ValueError("GRF2d.sample needs a generator or a noise tensor")
            device = generator.device if device is None else device
            noise = [torch.randn((2, n0, n0), generator=generator, dtype=self.dtype,
                                 device=device) for _ in range(bsz)]
        elif tuple(noise.shape[-3:]) != (2, n0, n0):
            raise ValueError(f"noise of shape {tuple(noise.shape)} does not end "
                             f"with {(2, n0, n0)}")
        coeff = torch.stack([
            _resize_bilinear(z.to(dtype=self.dtype, device=device), n) for z in noise])
        coeff = torch.complex(coeff[:, 0], coeff[:, 1])
        coeff = self._spectrum(n, coeff.device) * coeff
        s = torch.fft.ifftn(coeff, dim=(-2, -1)).real
        if self.normalize:
            s = s / torch.linalg.vector_norm(s / n, dim=(-2, -1), keepdim=True)
        return s

    def __call__(self, generator: Optional[torch.Generator] = None, bsz: int = 1,
                 n: Optional[int] = None, noise: Optional[Tensor] = None, device=None
                 ) -> Tensor:
        return self.sample(generator, bsz, n, noise=noise, device=device)

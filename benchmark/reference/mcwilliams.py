"""Plain reference of one McWilliams dataset batch: IC, rollout, recorder.

The McWilliams-1984 initial vorticity from white noise, the dealiased
pseudo-spectral Navier-Stokes solver in vorticity form stepped by the
low-storage RK4 (Carpenter-Kennedy) with Crank-Nicolson diffusion on
``torch.fft``, and the recorder: the inverse transform of each record and
an antialiased bilinear subsample (PIL's triangle filter, edges clamped and
renormalized). Dealiasing is the 2/3 rule on the nonlinear term; with the
configuration's ``dealias`` ``galerkin`` it is a Galerkin truncation as well:
the state lives on the kept modes, the IC's other modes dropped (the fused
kernels' route), and with ``nonlinear`` the state keeps every mode (the
``torch.fft`` route).

``tf32=True`` rounds the input of every transform to TF32: the control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.precision import rounder

# Carpenter-Kennedy low-storage RK4 coefficients (5 stages)
ALPHAS = (0.0, 0.1496590219993, 0.3704009573644, 0.6222557631345,
          0.9582821306748, 1.0)
BETAS = (0.0, -0.4178904745, -1.192151694643, -1.697784692471, -1.514183444257)
GAMMAS = (0.1496590219993, 0.3792103129999, 0.8229550293869, 0.6994504559488,
          0.1530572479681)


def keep_mask(n: int) -> np.ndarray:
    """The 2/3 rule on the ``(n, n//2+1)`` half spectrum: signed x modes
    ``-kmax <= kx < kmax`` with ``kmax = int(2n/3)//2``, y modes below
    ``int(2/3 (n//2+1))``."""
    kmax = int(2 / 3 * n) // 2
    kx = np.round(np.fft.fftfreq(n) * n).astype(int)
    keep_x = (kx >= -kmax) & (kx < kmax)
    keep_y = np.arange(n // 2 + 1) < int(2 / 3 * (n // 2 + 1))
    return np.outer(keep_x, keep_y)


def initial_vorticity(noise: torch.Tensor, diam: float, peak_wavenumber: float,
                      tf32: bool = False) -> torch.Tensor:
    """``(b, n, n)`` McWilliams vorticity from ``(b, n, n)`` white noise: the
    stream function is the noise filtered by ``(k (1 + (k/k0)^4))^-1``,
    scaled to unit kinetic energy; the vorticity is ``k^2`` times it."""
    r = rounder(tf32)
    n = noise.shape[-1]
    f = 2 * math.pi * np.fft.fftfreq(n, d=diam / n)
    k = np.sqrt(f[:, None] ** 2 + f[None, :] ** 2)
    density = np.where(k > 0, 1.0 / np.maximum(k * (1 + (k / peak_wavenumber) ** 4),
                                               1e-300), 0.0)
    dt = noise.dtype
    k_t = torch.as_tensor(k, dtype=dt, device=noise.device)
    dens_t = torch.as_tensor(density, dtype=dt, device=noise.device)
    psi = torch.fft.ifft2(torch.fft.fft2(r(noise)) * dens_t).real
    uh = k_t * torch.fft.fft2(r(psi))
    energy = (2.0 / float(n * n) ** 2) * (uh.abs() ** 2).sum(dim=(-2, -1), keepdim=True)
    psi = psi / torch.sqrt(energy)
    return torch.fft.ifft2(torch.fft.fft2(r(psi)) * k_t ** 2).real


class Solver:
    """Vorticity-form Navier-Stokes on an ``n x n`` periodic square of side
    ``diam``: ``w_t = -(u . grad) w + nu lap w - drag w``, state the rfft2
    half spectrum."""

    def __init__(self, n: int, diam: float, viscosity: float, dt: float,
                 drag: float = 0.0, device="cpu", dtype=torch.float32,
                 tf32: bool = False):
        self.n, self.dt, self.r = n, dt, rounder(tf32)
        fx = np.fft.fftfreq(n, d=diam / n)
        fy = np.fft.rfftfreq(n, d=diam / n)
        kx, ky = np.meshgrid(fx, fy, indexing="ij")
        lap = -4 * math.pi ** 2 * (kx ** 2 + ky ** 2)
        guard = lap.copy()
        guard[0, 0] = 1.0
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
        self.kx, self.ky = t(kx), t(ky)
        self.lap_guarded = t(guard)
        self.linear = t(viscosity * lap - drag)
        self.mask = t(keep_mask(n).astype(np.float64))

    def explicit(self, w: torch.Tensor) -> torch.Tensor:
        two_pi_i = 2j * math.pi
        psi = -w / self.lap_guarded
        spectra = torch.stack([two_pi_i * self.ky * psi, -two_pi_i * self.kx * psi,
                               two_pi_i * self.kx * w, two_pi_i * self.ky * w])
        vx, vy, gx, gy = torch.fft.irfft2(self.r(spectra), s=(self.n, self.n)).unbind(0)
        advection = -(gx * vx + gy * vy)
        return torch.fft.rfft2(self.r(advection)) * self.mask

    def step(self, w: torch.Tensor) -> torch.Tensor:
        h = 0
        for k in range(len(BETAS)):
            h = self.explicit(w) + BETAS[k] * h
            mu = 0.5 * self.dt * (ALPHAS[k + 1] - ALPHAS[k])
            w = (w + GAMMAS[k] * self.dt * h + mu * self.linear * w) / (1 - mu * self.linear)
        return w


def subsample_matrix(n: int, ns: int) -> np.ndarray:
    """``(ns, n)`` weights of an antialiased bilinear downsample: a triangle
    of half-width ``n/ns`` input cells around each output centre, taps
    outside the field dropped and the rest renormalized (PIL's rule)."""
    scale = n / ns
    a = np.zeros((ns, n))
    for i in range(ns):
        centre = scale * (i + 0.5)
        lo = max(int(centre - scale + 0.5), 0)
        hi = min(int(centre + scale + 0.5), n)
        j = np.arange(lo, hi)
        w = np.maximum(0.0, 1.0 - np.abs((j - centre + 0.5) / scale))
        a[i, lo:hi] = w / w.sum()
    return a


def records(noise: torch.Tensor, cfg: dict, tf32: bool = False) -> torch.Tensor:
    """``(b, R, ns, ns)`` records of one batch from its ``(b, n, n)`` noise,
    as the dataset stores them: after the warm-up, a record one step on and
    then every ``record_every`` steps, ``ceil(recorded_steps / record_every)``
    records in all."""
    n, ns = cfg["grid_size"], cfg["grid_size"] // cfg["subsample"]
    solver = Solver(n, cfg["domain"], cfg["viscosity"], cfg["dt"], cfg.get("drag", 0.0),
                    device=noise.device, dtype=noise.dtype, tf32=tf32)
    w = torch.fft.rfft2(initial_vorticity(noise, cfg["domain"], cfg["peak_wavenumber"], tf32))
    if cfg["dealias"] == "galerkin":
        w = w * solver.mask
    for _ in range(cfg["warmup_steps"]):
        w = solver.step(w)
    every = cfg["record_every"]
    num = -(-cfg["recorded_steps"] // every)
    a = torch.as_tensor(subsample_matrix(n, ns), dtype=noise.dtype, device=noise.device)
    out = []
    for i in range(num):
        for _ in range(1 if i == 0 else every):
            w = solver.step(w)
        field = torch.fft.irfft2(w, s=(n, n))
        out.append(a @ field @ a.T)
    return torch.stack(out, dim=1)


def solver_steps(cfg: dict) -> int:
    """Solver steps a sample takes: the warm-up and the recorded schedule."""
    every = cfg["record_every"]
    num = -(-cfg["recorded_steps"] // every)
    return cfg["warmup_steps"] + 1 + (num - 1) * every

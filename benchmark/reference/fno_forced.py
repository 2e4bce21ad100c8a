"""Plain reference of one batch of the FNO paper's forced dataset: the GRF
initial condition, the forced rollout, the four recorded fields.

The initial vorticity is a Gaussian random field with covariance
``(-lap + tau^2)^-alpha`` on [0, 1)^2, drawn from two standard-normal fields
a sample, each sample's generator seeded from ``(seed, sample id)``. The
vorticity is stepped in the rfft2 half spectrum, every mode kept, by the
order-2 IMEX Runge-Kutta / Crank-Nicolson scheme of Chandler & Kerswell
(2013) with ``alpha = beta = 1/2``::

    g  = u + beta dt L u
    u1 = (g + dt N(u)) / (1 - beta dt L)
    u' = (g + dt (alpha N(u1) + (1 - alpha) N(u))) / (1 - beta dt L)

where ``L`` is the viscous term ``nu lap - drag`` and ``N`` the explicit
term: the advection ``-(u . grad) w``, products on the grid and the 2/3 rule
applied to their spectrum, plus the forcing ``scale (sin 2 pi k (x + y) +
cos 2 pi k (x + y))`` on the cell corners. The records are the vorticity,
the stream function ``-w / lap``, the time derivative (the change over the
solver call that led to the record, over its time) and the residual
``w_t - N(w) - L w``, each inverse-transformed and subsampled with
antialiasing as in ``reference/mcwilliams.py``.

Departures from upstream's ``ns_2d.py`` (Li et al., ICLR 2021), which are
those of the torch-cfd generator the port follows: upstream steps the
nonlinear term by forward Euler and the viscous term by Crank-Nicolson at
dt 1e-4, here the order-2 scheme above at dt 1e-3; upstream records from
t = 0 at T / record_steps, here after a warm-up, one record a step after
it and then one every ``record_every`` steps; upstream stores the
vorticity alone, strided, here four fields subsampled with antialiasing.

``tf32=True`` rounds the input of every transform to TF32: the control.
Matrix products run in full float32 (TF32 off) either way.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.mcwilliams import keep_mask, subsample_matrix
from benchmark.reference.precision import rounder

FIELDS = ("vorticity", "stream", "vort_t", "residual")


def sample_generator(seed: int, sample_id: int, device="cpu") -> torch.Generator:
    """The generator of one sample: a 64-bit seed from numpy's
    ``SeedSequence([seed, sample_id])``."""
    state = np.random.SeedSequence([int(seed), int(sample_id)]).generate_state(
        1, dtype=np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def white_noise(seed: int, sample_ids, n: int, dtype, device) -> torch.Tensor:
    """``(b, 2, n, n)`` standard-normal draws, one ``(2, n, n)`` draw from
    each sample's own generator."""
    return torch.stack([
        torch.randn((2, n, n), generator=sample_generator(seed, i, device), dtype=dtype,
                    device=device)
        for i in sample_ids])


def initial_vorticity(noise: torch.Tensor, alpha: float, tau: float,
                      tf32: bool = False) -> torch.Tensor:
    """``(b, n, n)`` GRF from ``(b, 2, n, n)`` noise: the two fields as the
    real and imaginary parts of white noise in Fourier space, scaled by the
    square root of the covariance spectrum ``n^2 sqrt(2) sigma (4 pi^2 |k|^2 +
    tau^2)^(-alpha/2)``, ``sigma = tau^(alpha - 1)`` and the mean mode 0, and
    the real part of the inverse transform."""
    n = noise.shape[-1]
    k = np.fft.fftfreq(n, d=1.0 / n)
    k2 = k[:, None] ** 2 + k[None, :] ** 2
    sigma = tau ** (0.5 * (2 * alpha - 2))
    sqrt_eig = n ** 2 * math.sqrt(2.0) * sigma * (4 * math.pi ** 2 * k2 + tau ** 2) ** (-alpha / 2)
    sqrt_eig[0, 0] = 0.0
    coeff = torch.complex(noise[:, 0], noise[:, 1])
    coeff = torch.as_tensor(sqrt_eig, dtype=noise.dtype, device=noise.device) * coeff
    return torch.fft.ifft2(rounder(tf32)(coeff)).real


def forcing(n: int, diam: float, scale: float, wave_number: int, dtype, device) -> torch.Tensor:
    """``(n, n)`` forcing ``scale (cos k (x + y) + sin k (x + y))``, ``k = 2
    pi wave_number / diam``, at the cell corners ``x_i = i diam / n``."""
    x = np.arange(n) * (diam / n)
    s = x[:, None] + x[None, :]
    k = 2 * math.pi * wave_number / diam
    return torch.as_tensor(scale * (np.cos(k * s) + np.sin(k * s)), dtype=dtype, device=device)


class Solver:
    """Forced vorticity-form Navier-Stokes on an ``n x n`` periodic square of
    side ``diam``, state the rfft2 half spectrum with every mode kept."""

    def __init__(self, n: int, diam: float, viscosity: float, dt: float,
                 force: torch.Tensor, drag: float = 0.0, tf32: bool = False):
        self.n, self.dt, self.r = n, dt, rounder(tf32)
        device, dtype = force.device, force.dtype
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
        self.force_hat = torch.fft.rfft2(self.r(force))

    def explicit(self, w: torch.Tensor) -> torch.Tensor:
        """N(w): the dealiased advection and the forcing."""
        two_pi_i = 2j * math.pi
        psi = -w / self.lap_guarded
        spectra = torch.stack([two_pi_i * self.ky * psi, -two_pi_i * self.kx * psi,
                               two_pi_i * self.kx * w, two_pi_i * self.ky * w])
        vx, vy, gx, gy = torch.fft.irfft2(self.r(spectra), s=(self.n, self.n)).unbind(0)
        advection = -(gx * vx + gy * vy)
        return torch.fft.rfft2(self.r(advection)) * self.mask + self.force_hat

    def solve(self, f: torch.Tensor, eta: float) -> torch.Tensor:
        """u with u - eta L u = f."""
        return f / (1 - eta * self.linear)

    def step(self, w: torch.Tensor, alpha: float = 0.5, beta: float = 0.5) -> torch.Tensor:
        dt = self.dt
        g = w + beta * dt * self.linear * w
        n0 = self.explicit(w)
        u1 = self.solve(g + dt * n0, beta * dt)
        n1 = alpha * self.explicit(u1) + (1 - alpha) * n0
        return self.solve(g + dt * n1, beta * dt)

    def residual(self, w: torch.Tensor, w_t: torch.Tensor) -> torch.Tensor:
        return w_t - self.explicit(w) - self.linear * w


def records(noise: torch.Tensor, cfg: dict, tf32: bool = False) -> dict:
    """Each field's ``(b, R, ns, ns)`` records of one batch from its ``(b, 2,
    n, n)`` noise, as the dataset stores them: after the warm-up, a record
    one step on and then every ``record_every`` steps,
    ``ceil(recorded_steps / record_every)`` records in all."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _records(noise, cfg, tf32)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def _records(noise, cfg, tf32):
    n, ns = cfg["grid_size"], cfg["grid_size"] // cfg["subsample"]
    dtype, device = noise.dtype, noise.device
    force = forcing(n, cfg["domain"], cfg["forcing_scale"], cfg["forcing_wave_number"],
                    dtype, device)
    solver = Solver(n, cfg["domain"], cfg["viscosity"], cfg["dt"], force,
                    cfg.get("drag", 0.0), tf32)
    r = rounder(tf32)
    w = torch.fft.rfft2(r(initial_vorticity(noise, cfg["alpha"], cfg["tau"], tf32)))
    for _ in range(cfg["warmup_steps"]):
        w = solver.step(w)
    every = cfg["record_every"]
    num = -(-cfg["recorded_steps"] // every)
    a = torch.as_tensor(subsample_matrix(n, ns), dtype=dtype, device=device)
    out = {k: [] for k in FIELDS}
    for i in range(num):
        steps = 1 if i == 0 else every
        w_old = w
        for _ in range(steps):
            w = solver.step(w)
        w_t = (w - w_old) / (steps * cfg["dt"])
        spectra = {"vorticity": w, "stream": -w / solver.lap_guarded, "vort_t": w_t,
                   "residual": solver.residual(w, w_t)}
        for k in FIELDS:
            out[k].append(a @ torch.fft.irfft2(r(spectra[k]), s=(n, n)) @ a.T)
    return {k: torch.stack(v, dim=1) for k, v in out.items()}


def solver_steps(cfg: dict) -> int:
    """Solver steps a sample takes: the warm-up and the recorded schedule."""
    every = cfg["record_every"]
    num = -(-cfg["recorded_steps"] // every)
    return cfg["warmup_steps"] + 1 + (num - 1) * every

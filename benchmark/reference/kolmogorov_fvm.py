"""Plain reference of the forced Kolmogorov flow on a staggered (MAC) grid:
finite volumes, Van Leer advection, classic RK4 with a Chorin projection
after each stage, as torch-cfd's example
``Kolmogrov2d_rk4_fvm_forced_turbulence.ipynb`` runs Google's JAX-CFD
finite-volume solver (Kochkov et al., PNAS 2021).

Plain PyTorch, written from the discretization's equations; nothing of the
port or of JAX is imported. Every field is a batch ``(b, n, n)`` on
[0, L)², periodic, indexed ``[sample, i, j]`` with i along x and j along y,
cell width h = L / n. The velocity lives on the cell faces: u at
((i + 1) h, (j + 1/2) h), v at ((i + 1/2) h, (j + 1) h); a cell's scalar
at its center. ``_at(f, axis, k)`` is f at index + k along that axis.

Terms, each by ``torch.roll`` and pointwise arithmetic:

- advection of each component c of the velocity by the velocity, as the
  divergence of fluxes through the faces of c's own control volume: along
  each axis a, the a-component of the velocity linearly interpolated to
  that face (the mean of it and its neighbour along c's staggered axis),
  and c's face value by the Van Leer TVD limiter on Lax–Wendroff: the
  upwind value, the Lax–Wendroff value with the Courant number dt·u/h, and
  the limiter phi(r) = 2r / (1 + r) for r > 0 (else 0) of the ratio r of
  consecutive differences on the upwind side; the flux c·u differenced
  backward and summed, with the sign taken out;
- diffusion ν/ρ times the 5-point Laplacian;
- the Kolmogorov forcing scale·sin(k y) on the u faces (y at u's offset,
  (j + 1/2) h, k = wave number · 2π / L), divided by ρ; none on v;
- linear drag −drag·(u, v);
- the projection: the divergence by backward differences, the pressure by
  a Poisson solve with ``torch.fft`` on the eigenvalues of the 5-point
  Laplacian, −(4 / h²)(sin²(π k_x / n) + sin²(π k_y / n)), the zero mode
  dropped, and its forward-difference gradient taken from the velocity;
- classic RK4 with the projection after each of its stages and of the step;
- the initial velocity: white noise filtered to a log-normal spectrum
  peaked at ``peak_wavenumber`` (variance 1/4, divided by |k|), then three
  times projected and scaled to a maximum speed of ``max_velocity``;
- the vorticity frames by the forward-difference curl.

Departures from JAX-CFD's code, none of them in the equations:
- the projection's zero mode is dropped exactly, where JAX-CFD's
  pseudoinverse zeroes the eigenvalues below ten times the precision's
  epsilon: both leave the pressure's mean out, which no gradient sees;
- the Laplacian's eigenvalues are written in closed form, where JAX-CFD
  takes them from an FFT of its 1-D operator's first column;
- the limiter's two gradient ratios are chosen by the sign of the face
  velocity before the limiter, not after (the same value);
- the zero forcing of v is not added; the sums run in another order.
Their effect is rounding: in fp64 the port's frames read within 1e-15 of
these at 16² and 32² on the CPU, and within 3e-15 at 128² on the card.
"""

from __future__ import annotations

import math

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _at(f: torch.Tensor, axis: int, k: int) -> torch.Tensor:
    """``f`` at index + k along grid axis ``axis`` (0: x, 1: y), periodic."""
    return torch.roll(f, -k, dims=f.ndim - 2 + axis)


def _safe_div(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x / y with a zero y read as 1."""
    return x / torch.where(y != 0, y, torch.ones_like(y))


def cell_width(cfg: dict) -> float:
    return cfg["domain_length"] / cfg["grid_size"]


def time_step(cfg: dict) -> float:
    """The CFL-bound step at the configuration's Courant number and maximum
    speed (diffusion is not bound: the example's stable_time_step takes it
    as implicit, which caps dt at h)."""
    h = cell_width(cfg)
    return min(h, cfg["max_courant_number"] * h / cfg["max_velocity"])


def divergence(u: torch.Tensor, v: torch.Tensor, h: float) -> torch.Tensor:
    """At the cell centers, by backward differences."""
    return (u - _at(u, 0, -1)) / h + (v - _at(v, 1, -1)) / h


def curl(u: torch.Tensor, v: torch.Tensor, h: float) -> torch.Tensor:
    """∂v/∂x − ∂u/∂y by forward differences, at the cell corners."""
    return (_at(v, 0, 1) - v) / h - (_at(u, 1, 1) - u) / h


def inverse_laplacian(n: int, h: float, dtype, device) -> torch.Tensor:
    """1/λ on the ``rfft2`` half spectrum, 0 at the zero mode."""
    kx = torch.arange(n, dtype=dtype, device=device)
    ky = torch.arange(n // 2 + 1, dtype=dtype, device=device)
    lam = -(4 / h ** 2) * (torch.sin(math.pi * kx / n)[:, None] ** 2
                           + torch.sin(math.pi * ky / n)[None, :] ** 2)
    inv = 1 / torch.where(lam == 0, torch.ones_like(lam), lam)
    inv[0, 0] = 0
    return inv


def project(u: torch.Tensor, v: torch.Tensor, h: float, inv_lap: torch.Tensor):
    """The divergence-free part of (u, v)."""
    n = u.shape[-1]
    q = torch.fft.irfft2(torch.fft.rfft2(divergence(u, v, h)) * inv_lap, s=(n, n))
    return u - (_at(q, 0, 1) - q) / h, v - (_at(q, 1, 1) - q) / h


def _face_value(c: torch.Tensor, u_face: torch.Tensor, axis: int, courant: float):
    """``c`` at the face between a cell and the next along ``axis``: the Van
    Leer TVD limiter on Lax–Wendroff, upwind by the sign of ``u_face``."""
    c_next, c_prev, c_next2 = _at(c, axis, 1), _at(c, axis, -1), _at(c, axis, 2)
    diff = c_next - c
    positive = u_face > 0
    low = torch.where(positive, c, c_next)
    cr = courant * u_face
    high = torch.where(positive, c + 0.5 * (1 - cr) * diff, c_next - 0.5 * (1 + cr) * diff)
    r = torch.where(positive, _safe_div(c - c_prev, diff), _safe_div(c_next2 - c_next, diff))
    phi = torch.where(r > 0, _safe_div(2 * r, 1 + r), torch.zeros_like(r))
    return low - (low - high) * phi


def advection(vel: tuple, d: int, h: float, dt: float) -> torch.Tensor:
    """−div(c u) for the velocity's component ``d`` on its control volume."""
    c = vel[d]
    rate = torch.zeros_like(c)
    for a in range(2):
        u_face = 0.5 * (vel[a] + _at(vel[a], d, 1))
        flux = _face_value(c, u_face, a, dt / h) * u_face
        rate = rate - (flux - _at(flux, a, -1)) / h
    return rate


def laplacian(c: torch.Tensor, h: float) -> torch.Tensor:
    return sum(_at(c, a, 1) + _at(c, a, -1) - 2 * c for a in range(2)) / h ** 2


def forcing(cfg: dict, n: int, dtype, device) -> torch.Tensor:
    """The forcing of u, at u's y = (j + 1/2) h; (n, n)."""
    h = cfg["domain_length"] / n
    y = (torch.arange(n, dtype=torch.float64) + 0.5) * h
    k = cfg["forcing_wave_number"] * 2 * math.pi / cfg["domain_length"]
    f = cfg["forcing_scale"] * torch.sin(k * y) / cfg["density"]
    return f[None, :].expand(n, n).to(dtype=dtype, device=device)


def explicit_terms(vel: tuple, cfg: dict, h: float, dt: float, force_u: torch.Tensor):
    nu = cfg["viscosity"] / cfg["density"]
    rates = []
    for d in range(2):
        rate = advection(vel, d, h, dt) + nu * laplacian(vel[d], h) - cfg["drag"] * vel[d]
        rates.append(rate + force_u if d == 0 else rate)
    return tuple(rates)


def rk4_step(vel: tuple, cfg: dict, h: float, dt: float, inv_lap, force_u) -> tuple:
    """Classic RK4, each stage's state projected, the step's result too."""
    def f(x):
        return explicit_terms(x, cfg, h, dt, force_u)

    def combine(weights):
        return project(*(vel[d] + dt * sum(w * k[d] for w, k in weights) for d in range(2)),
                       h, inv_lap)

    k0 = f(vel)
    k1 = f(combine([(0.5, k0)]))
    k2 = f(combine([(0.5, k1)]))
    k3 = f(combine([(1.0, k2)]))
    return combine([(1 / 6, k0), (1 / 3, k1), (1 / 3, k2), (1 / 6, k3)])


def initial_velocity(noise: torch.Tensor, cfg: dict, inv_lap: torch.Tensor) -> tuple:
    """From white noise ``(b, 2, n, n)``: the filtered, projected and
    normalised velocity ``(u, v)``."""
    n = noise.shape[-1]
    h = cfg["domain_length"] / n
    freq = 2 * math.pi * torch.fft.fftfreq(n, d=h, dtype=noise.dtype, device=noise.device)
    k = torch.sqrt(freq[:, None] ** 2 + freq[None, :] ** 2)
    variance = 0.25
    mean = math.log(cfg["peak_wavenumber"]) + variance
    safe_k = torch.where(k > 0, k, torch.ones_like(k))
    logk = torch.log(safe_k)
    density = torch.exp(-(mean - logk) ** 2 / 2 / variance - logk) / safe_k
    filt = torch.where(k > 0, density, torch.zeros_like(k))
    vel = tuple(torch.fft.ifft2(torch.fft.fft2(noise[:, d]) * filt).real for d in range(2))
    for _ in range(cfg["ic_iterations"]):
        vel = project(*vel, h, inv_lap)
        vmax = torch.sqrt(vel[0] ** 2 + vel[1] ** 2).amax(dim=(-2, -1), keepdim=True)
        vel = tuple(cfg["max_velocity"] * c / vmax for c in vel)
    return vel


def records(noise: torch.Tensor, cfg: dict):
    """The rollout of ``noise``'s samples in its dtype and on its device:
    ``(frames (frames, b, n, n), (u, v) final)``, a frame after every
    ``inner_steps`` steps."""
    n = noise.shape[-1]
    h = cfg["domain_length"] / n
    dt = time_step(dict(cfg, grid_size=n))
    inv_lap = inverse_laplacian(n, h, noise.dtype, noise.device)
    force_u = forcing(cfg, n, noise.dtype, noise.device)
    vel = initial_velocity(noise, cfg, inv_lap)
    frames = []
    for _ in range(cfg["frames"]):
        for _ in range(cfg["inner_steps"]):
            vel = rk4_step(vel, cfg, h, dt, inv_lap, force_u)
        frames.append(curl(*vel, h))
    return torch.stack(frames), vel

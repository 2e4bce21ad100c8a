"""Initial conditions: filtered divergence-free velocity and McWilliams vorticity.

Counterpart of ``tpu_cfd/solvers/initial_conditions.py``. Fields may carry
leading batch dims: where the JAX package maps one sample at a time, these
take a batch, and every reduction (the energy of ``streamfunc_normalize``,
the maximum speed of ``project_and_normalize``) runs per sample over the
grid dims.

Randomness: each sample draws from its own ``torch.Generator``, seeded from
``(seed, sample_id)`` by ``sample_generator``, so a resumed run draws the same
noise for the same sample. That stream differs from the JAX package's
``jax.random.fold_in(key, sample_id)``: datasets of the two packages match in
distribution, not bit for bit. Tests feed both the same noise through the
``noise=`` arguments.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from tpu_cfd_torch import boundaries, grids
from tpu_cfd_torch.solvers import pressure

Tensor = torch.Tensor
Grid = grids.Grid
GridArray = grids.GridArray
GridVariable = grids.GridVariable
GridVariableVector = grids.GridVariableVector


def sample_generator(seed: int, sample_id: int, device="cpu") -> torch.Generator:
    """A generator for one sample, seeded from ``(seed, sample_id)``."""
    state = np.random.SeedSequence([int(seed), int(sample_id)]).generate_state(
        1, dtype=np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def wrap_velocities(v: Sequence[Tensor], grid: Grid, bcs: Sequence[object]
                    ) -> GridVariableVector:
    """Wraps raw velocity tensors on the cell faces."""
    return GridVariableVector(tuple(
        GridVariable(GridArray(u, offset, grid), bc)
        for u, offset, bc in zip(v, grid.cell_faces, bcs)
    ))


def wrap_vorticity(w: Tensor, grid: Grid, bc: object) -> GridVariable:
    """Wraps a raw vorticity tensor at cell centers."""
    return GridVariable(GridArray(w, grid.cell_center, grid), bc)


def _log_normal_density(k: Tensor, mode: float, variance: float = 0.25) -> Tensor:
    """Unscaled log-normal density peaked at ``mode``."""
    mean = math.log(mode) + variance
    logk = torch.log(k)
    return torch.exp(-((mean - logk) ** 2) / 2 / variance - logk)


def McWilliams_density(k: Tensor, mode: float, tau: float = 1.0) -> Tensor:
    """McWilliams-1984 spectral density |ψ̂|² ~ k⁻¹(τ² + (k/k₀)⁴)⁻¹."""
    return (k * (tau**2 + (k / mode) ** 4)) ** (-1)


def _angular_frequency_magnitude(grid: Grid, dtype=torch.float32, device=None
                                 ) -> Tensor:
    frequencies = [
        2 * math.pi * torch.as_tensor(np.fft.fftfreq(size, step), device=device).to(dtype)
        for size, step in zip(grid.shape, grid.step)
    ]
    freq_vector = torch.stack(torch.meshgrid(*frequencies, indexing="ij"), dim=0)
    return torch.linalg.vector_norm(freq_vector, dim=0)


def spectral_filter(
    spectral_density: Callable[[Tensor], Tensor], v: Tensor, grid: Grid
) -> Tensor:
    """Filters white noise (last ``grid.ndim`` axes) to a spectral density."""
    k = _angular_frequency_magnitude(grid, dtype=v.dtype, device=v.device)
    filters = torch.where(k > 0, spectral_density(k), torch.zeros_like(k))
    dims = tuple(range(-grid.ndim, 0))
    return torch.fft.ifftn(torch.fft.fftn(v, dim=dims) * filters, dim=dims).real


def streamfunc_normalize(k: Tensor, psi: Tensor) -> Tensor:
    """Normalizes each stream function (last two axes) to unit kinetic energy."""
    nx, ny = psi.shape[-2:]
    psih = torch.fft.fft2(psi)
    uh_mag = k * psih
    # python-float normalizer: (nx*ny)**2 overflows int32 at 256^2 and above
    norm = 2.0 / float(nx * ny) ** 2
    kinetic_energy = (norm * uh_mag.abs() ** 2).sum(dim=(-2, -1), keepdim=True)
    return psi / torch.sqrt(kinetic_energy)


def vorticity_field(
    grid: Grid,
    peak_wavenumber: float = 3,
    dtype=torch.float32,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Tensor] = None,
    device=None,
) -> GridVariable:
    """McWilliams-1984 isotropic-turbulence initial vorticity.

    The stream function is white noise filtered to the McWilliams density
    and normalized to unit kinetic energy; vorticity = -Δψ, spectrally.
    The noise is ``noise`` (shape ``(..., *grid.shape)``; leading dims are
    samples) or one standard-normal draw of ``grid.shape`` from
    ``generator``, on ``device`` (the generator's device by default).
    """
    if noise is None:
        if generator is None:
            raise ValueError("vorticity_field needs a generator or a noise tensor")
        device = generator.device if device is None else device
        noise = torch.randn(grid.shape, generator=generator, dtype=dtype,
                            device=device)
    noise = noise.to(dtype=dtype, device=device if device is not None else noise.device)
    spectral_density = lambda k: McWilliams_density(k, peak_wavenumber)  # noqa: E731
    k = _angular_frequency_magnitude(grid, dtype=dtype, device=noise.device)
    psi = spectral_filter(spectral_density, noise, grid)
    psi = streamfunc_normalize(k, psi)
    vorticity = torch.fft.ifftn(torch.fft.fftn(psi, dim=(-2, -1)) * k**2,
                                dim=(-2, -1)).real
    bc = boundaries.periodic_boundary_conditions(grid.ndim)
    return wrap_vorticity(vorticity, grid, bc)


def project_and_normalize(
    v: GridVariableVector,
    maximum_velocity: float = 1,
    projection: Optional[pressure.PressureProjection] = None,
) -> GridVariableVector:
    """Projects ``v`` to be divergence-free, then scales each sample to a
    maximum speed of ``maximum_velocity``."""
    grid = grids.consistent_grid_arrays(*v)
    if projection is None:
        pressure_bc = boundaries.get_pressure_bc_from_velocity(v)
        projection = pressure.PressureProjection(grid, pressure_bc, dtype=v.dtype)
    v = projection(v)
    speed = torch.linalg.vector_norm(torch.stack([u.data for u in v]), dim=0)
    # one maximum a sample, over the grid dims: a batch-wide maximum would
    # scale every sample by the fastest one's speed
    vmax = speed.amax(dim=tuple(range(-grid.ndim, 0)), keepdim=True)
    return GridVariableVector(
        tuple(GridVariable(maximum_velocity * u.array / vmax, u.bc) for u in v)
    )


def filtered_velocity_field(
    grid: Grid,
    maximum_velocity: float = 1,
    peak_wavenumber: float = 3,
    iterations: int = 3,
    dtype=torch.float32,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Tensor] = None,
    device=None,
) -> GridVariableVector:
    """Divergence-free velocity with a log-normal energy spectrum.

    White noise per component is filtered to a density peaked at
    ``peak_wavenumber`` (divided by k^(ndim-1), the shell's volume), then
    projected and renormalized ``iterations`` times. The noise is ``noise``
    (shape ``(..., ndim, *grid.shape)``; leading dims are samples) or one
    standard-normal draw of ``(ndim, *grid.shape)`` from ``generator``, the
    components in order, on ``device`` (the generator's device by default).
    """
    if noise is None:
        if generator is None:
            raise ValueError("filtered_velocity_field needs a generator or a noise tensor")
        device = generator.device if device is None else device
        noise = torch.randn((grid.ndim, *grid.shape), generator=generator, dtype=dtype,
                            device=device)
    noise = noise.to(dtype=dtype, device=device if device is not None else noise.device)
    if tuple(noise.shape[-grid.ndim - 1:]) != (grid.ndim, *grid.shape):
        raise ValueError(f"noise of shape {tuple(noise.shape)} does not end with "
                         f"{(grid.ndim, *grid.shape)}")

    def spectral_density(k):
        return _log_normal_density(k, peak_wavenumber) / k ** (grid.ndim - 1)

    bcs = [boundaries.periodic_boundary_conditions(grid.ndim)] * grid.ndim
    components = [spectral_filter(spectral_density, noise.select(-grid.ndim - 1, i), grid)
                  for i in range(grid.ndim)]
    velocity = wrap_velocities(components, grid, bcs)
    # repeated projection and normalization removes the roundoff drift
    pressure_bc = boundaries.get_pressure_bc_from_velocity(velocity)
    projection = pressure.PressureProjection(grid, pressure_bc, dtype=dtype)
    for _ in range(iterations):
        velocity = project_and_normalize(velocity, maximum_velocity, projection)
    return velocity

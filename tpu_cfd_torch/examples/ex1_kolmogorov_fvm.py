"""Forced Kolmogorov turbulence with the MAC-grid FVM solver (RK4 + projection).

Counterpart of ``examples/ex1_kolmogorov_fvm.py``: a ``filtered_velocity_field``
initial condition (maximum velocity 3, peak wavenumber 3, 3 projections),
classic RK4 stepping with a pressure projection after each stage,
``KolmogorovForcing`` (wave number 3) and drag 0.1, a CFL-bounded dt
(``stable_time_step`` at Courant 0.5), then a facet plot of the vorticity
snapshots from the finite-difference curl (``fvm.rollout``). fp64 by
default, on the card too (the JAX example ran fp64 on its CPU); ``--f32``
for fp32. ``--batch b`` steps an ensemble of b independent samples, each
from its own noise, as one batch; the figure shows the first.

Runs on the card unless ``--no-cuda`` asks for the CPU:
  python -m tpu_cfd_torch.examples.ex1_kolmogorov_fvm [--n 128] [--frames 10] [--batch 8]
The figure goes to ``--out`` (default FIG_PATH/kolmogorov_fvm_<n>.png) where
matplotlib is installed.
"""

from __future__ import annotations

import argparse
import math
import os
import time

import numpy as np
import torch

from tpu_cfd_torch import grids
from tpu_cfd_torch.device import resolve_device
from tpu_cfd_torch.ops import finite_differences as fdm
from tpu_cfd_torch.solvers import forcings, fvm, initial_conditions as ic
from tpu_cfd_torch.solvers.equations import stable_time_step
from tpu_cfd_torch.train import pipeline
from tpu_cfd_torch.utils import visualizations as viz

VISCOSITY, DENSITY, MAX_VELOCITY, PEAK_WAVENUMBER, DRAG = 1e-3, 1.0, 3.0, 3, 0.1
SEED = 42


def initial_velocity(grid: grids.Grid, noise: torch.Tensor, dtype: torch.dtype, device):
    """The example's initial velocity from white ``noise`` of shape
    ``(..., 2, n, n)``, a sample for each leading index."""
    return ic.filtered_velocity_field(grid, MAX_VELOCITY, PEAK_WAVENUMBER, iterations=3,
                                      dtype=dtype, noise=noise, device=device)


def build(n: int, dtype: torch.dtype, device, seed: int = SEED, batch: int = None,
          noise: torch.Tensor = None):
    """The example's initial velocity, equation and time step at n². The
    IC's noise is ``noise`` (``(..., 2, n, n)``), or else drawn on the CPU in
    fp64 from ``seed``, so that every device and dtype starts from the same
    draw: ``(2, n, n)``, one sample, or ``(batch, 2, n, n)``, an ensemble."""
    grid = grids.Grid((n, n), domain=((0, 2 * math.pi), (0, 2 * math.pi)))
    if noise is None:
        shape = (2, n, n) if batch is None else (batch, 2, n, n)
        noise = torch.randn(shape, dtype=torch.float64,
                            generator=torch.Generator().manual_seed(seed))
    v0 = initial_velocity(grid, noise, dtype, device)
    dt = stable_time_step(dx=min(grid.step), max_velocity=MAX_VELOCITY,
                          max_courant_number=0.5, viscosity=VISCOSITY)
    eqn = fvm.NavierStokes2DFVMProjection(
        viscosity=VISCOSITY, grid=grid, density=DENSITY, drag=DRAG,
        forcing=forcings.KolmogorovForcing(grid=grid, diam=2 * math.pi,
                                           wave_number=PEAK_WAVENUMBER,
                                           offsets=(v0[0].offset, v0[1].offset)),
        solver=fvm.RKStepper.from_method("classic_rk4"), dtype=dtype)
    return v0, eqn, dt


def main(argv=None) -> dict:
    """Runs the example; returns ``{"frames" (frames, n, n) vorticity, or
    (frames, batch, n, n) with ``--batch``, "velocity" (the final
    GridVariableVector), "div0" (the IC's divergence L2), "max_div" (the
    final |div|), "dt", "ms_per_step" (the rollout's, after a first step
    that builds the forcing, FFT plans and constants), "figure"}``."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=128)
    p.add_argument("--frames", type=int, default=10,
                   help="recorded frames (the reference notebook: 100)")
    p.add_argument("--inner-steps", type=int, default=20)
    p.add_argument("--batch", type=int, default=None,
                   help="an ensemble of this many independent samples (default: one)")
    p.add_argument("--f32", action="store_true", help="fp32 (default fp64)")
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--no-cuda", action="store_true", help="run on the CPU")
    args = p.parse_args(argv)
    device = resolve_device("cpu" if args.no_cuda else None)
    dtype = torch.float32 if args.f32 else torch.float64

    v, eqn, dt = build(args.n, dtype, device, batch=args.batch)
    div0 = float(torch.linalg.vector_norm(fdm.divergence(v).data))
    print(f"divergence of initial velocity L2: {div0:.2e}")
    print(f"dt: {dt}")

    eqn(v, dt)  # the first step builds the forcing, FFT plans and constants
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    frames, v = fvm.rollout(v, eqn, dt, args.inner_steps, args.frames)
    frames = frames.cpu().numpy()  # waits for the device
    ms_per_step = 1e3 * (time.perf_counter() - t0) / (args.frames * args.inner_steps)
    if not (np.isfinite(frames).all() and all(bool(torch.isfinite(u.data).all())
                                              for u in v)):
        raise FloatingPointError("the FVM rollout produced a non-finite field")
    max_div = float(fdm.divergence(v).data.abs().max())
    print(f"final max |divergence|: {max_div:.2e}; {ms_per_step:.3f} ms a step")

    out = args.out or os.path.join(pipeline.FIG_PATH, f"kolmogorov_fvm_{args.n}.png")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    first = frames if args.batch is None else frames[:, 0]
    figure = viz.save_figure(lambda: viz.plot_contour_trajectory(first), out,
                             dpi=110, bbox_inches="tight")
    if figure is not None:
        print(f"figure: {figure}")
    return {"frames": frames, "velocity": v, "div0": div0, "max_div": max_div,
            "dt": dt, "ms_per_step": ms_per_step, "figure": figure}


if __name__ == "__main__":
    main()

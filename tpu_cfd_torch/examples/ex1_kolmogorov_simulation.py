"""Forced Kolmogorov turbulence: simulate, then the enstrophy spectrum and
snapshots.

Counterpart of ``examples/ex1_kolmogorov_simulation.py``: the
pseudo-spectral solver at 256² (viscosity 1e-3, drag 0.1, Kolmogorov
forcing at wave number 4) from a McWilliams initial vorticity, 3,000 RK4-CN
steps of 7e-4 with 10 records, the final frame's enstrophy spectrum against
the k^(-5) guide. The solver keeps the class default ``fft_impl="fft"``, as
the JAX example does, so it runs ``torch.fft`` and launches no hand-written
kernel.

Runs on the card unless ``--no-cuda`` asks for the CPU:
  python -m tpu_cfd_torch.examples.ex1_kolmogorov_simulation [--n 256]
Figures go to ``<out>_snapshots.png`` and ``<out>_spectrum.png`` where
matplotlib is installed.
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np
import torch

from tpu_cfd_torch import grids
from tpu_cfd_torch.device import resolve_device
from tpu_cfd_torch.solvers import equations, forcings, initial_conditions as ic
from tpu_cfd_torch.solvers import trajectories
from tpu_cfd_torch.train import pipeline
from tpu_cfd_torch.utils import visualizations as viz


def main(argv=None) -> dict:
    """Runs the example; returns ``{"trajectory" (records, n, n),
    "enstrophy" (final mean w²), "spectrum" (k = 1..n/2-1), "peak_k",
    "figures"}``."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=256)
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--dt", type=float, default=7e-4)
    p.add_argument("--out", type=str, default=None,
                   help="figure path prefix (default FIG_PATH/kolmogorov_demo)")
    p.add_argument("--no-cuda", action="store_true", help="run on the CPU")
    args = p.parse_args(argv)
    device = resolve_device("cpu" if args.no_cuda else None)

    n, diam = args.n, 2 * math.pi
    grid = grids.Grid((n, n), domain=((0, diam), (0, diam)))
    forcing = forcings.KolmogorovForcing(grid=grid, scale=1.0, wave_number=4)
    ns = equations.NavierStokes2DSpectral(
        viscosity=1e-3, grid=grid, drag=0.1, forcing_fn=forcing, device=device)
    noise = torch.randn(grid.shape, generator=torch.Generator().manual_seed(0))
    w0 = ic.vorticity_field(grid, peak_wavenumber=4, noise=noise.to(device)).data

    with torch.no_grad():
        result = trajectories.get_trajectory_imex(
            ns, torch.fft.rfft2(w0), args.dt, num_steps=args.steps,
            record_every_steps=args.steps // 10, fields=("vorticity",))
        w_traj = torch.fft.irfft2(result["vorticity"], s=(n, n)).cpu().numpy()
    enstrophy = float(np.mean(w_traj[-1] ** 2))
    spectrum = viz.get_enstrophy_spectrum(w_traj[-1], diam / n)
    peak_k = int(np.argmax(spectrum)) + 1
    print(f"trajectory: {w_traj.shape}, final enstrophy {enstrophy:.3f}, "
          f"spectrum peak at k={peak_k}")

    out = args.out or os.path.join(pipeline.FIG_PATH, "kolmogorov_demo")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    figures = []
    for path, plot in (
            (f"{out}_snapshots.png",
             lambda: viz.plot_contour_trajectory(w_traj, num_snapshots=5)),
            (f"{out}_spectrum.png",
             lambda: viz.plot_enstrophy_spectrum(
                 [w_traj[-1]], h=diam / n, slope=5, labels=["simulated"],
                 title="Kolmogorov flow enstrophy spectrum"))):
        if viz.save_figure(plot, path, dpi=110) is None:
            break
        figures.append(path)
        print(f"figure: {path}")
    return {"trajectory": w_traj, "enstrophy": enstrophy, "spectrum": spectrum,
            "peak_k": peak_k, "figures": figures}


if __name__ == "__main__":
    main()

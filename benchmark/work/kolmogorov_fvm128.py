"""Work of the Kolmogorov FVM rollout: classic RK4 on the staggered grid
with a projection after each stage (``solvers/fvm.py``), counted from what
the equations need on n x n points, whatever implements them.

A step takes four explicit evaluations, four projections and the RK
combination. Operations a grid point:

- an explicit evaluation, 105: for each velocity component and each of its
  two control-volume faces, the face velocity (2), the Courant number (1),
  the difference to the next cell (1), the Lax-Wendroff value on the
  upwind side (4), the gradient ratio (2), the Van Leer limiter 2r/(1+r)
  (3), the limited value (3), the flux (1) and its backward difference
  over h (2), 19 a face; the two faces' sum (1); the 5-point Laplacian (9)
  and its viscosity (1); the sum of the rates (1) and the drag (2): 52 a
  component; and the forcing of u (1);
- a projection, 11: the divergence (5), the pressure's gradient and its
  subtraction (6); with, besides, the Poisson solve's product on the
  n (n/2 + 1) modes of the half spectrum (2 a mode) and a real FFT pair
  of the pressure (2.5 N log2 N each);
- the RK combination, 28: three stage states u0 + (a dt) k (2 a component)
  and the step's u0 + sum of four (b dt) k (8 a component).

Bytes: each explicit evaluation reads the velocity (2 fields) and writes
its rate (2); each projection reads and writes the velocity (4); the
stages' states read u0 and one rate and write the state (6 each, 3 of
them), the step's result reads u0 and four rates and writes it (12): 62
fields of n x n values a sample-step.
"""

from benchmark.work import fft_flops

STAGES = 4
EXPLICIT_POINT_FLOPS = 105
PROJECTION_POINT_FLOPS = 11
POISSON_MODE_FLOPS = 2
RK_POINT_FLOPS = 28
FIELD_PASSES = 62
REAL_BYTES = {"float32": 4, "float64": 8}


def sample_step_flops(cfg: dict) -> float:
    n = cfg["grid_size"]
    points = n * n
    projection = (PROJECTION_POINT_FLOPS * points + POISSON_MODE_FLOPS * n * (n // 2 + 1)
                  + 2 * fft_flops(points))
    return STAGES * (EXPLICIT_POINT_FLOPS * points + projection) + RK_POINT_FLOPS * points


def sample_step_bytes(cfg: dict, precision: str) -> float:
    return FIELD_PASSES * cfg["grid_size"] ** 2 * REAL_BYTES[precision]


def window_flops(rec) -> float:
    """Operations of every sample-step the window completed."""
    return rec.counters["sample_steps"] * sample_step_flops(rec.config)


def rollout_bound_s(rec):
    """The least time the traced solver calls could take: their sample-steps'
    operations at the peak rate, or their bytes at the peak bandwidth,
    whichever is longer. None without solver calls."""
    if not rec.ranges.calls.get("bench.solver", 0):
        return None
    samples = rec.ranges.counts["bench.solver"]
    return max(samples * sample_step_flops(rec.config) / rec.peak_flops,
               samples * sample_step_bytes(rec.config, rec.cell["precision"]) / rec.peak_bytes)

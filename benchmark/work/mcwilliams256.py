"""Work of the McWilliams rollout: the dealiased pseudo-spectral RK4-CN step.

A step is 5 stages. A stage evaluates the nonlinear term from the state on
the kept (2/3-rule) modes: 4 inverse real transforms (two velocity
components, two vorticity gradients) and 1 forward transform on the n x n
grid, the product -(u w_x + v w_y) (3 operations a point), and on each kept
mode the stream function, velocity and gradient factors (10 operations),
the low-storage update and the Crank-Nicolson solve (10 operations).
"""

from benchmark.work import fft_flops

STAGES = 5
MODE_FLOPS = 20
COMPLEX_BYTES = {"float32": 8, "float64": 16}


def kept_modes(n: int) -> int:
    """Modes of the 2/3 rule on the ``(n, n//2+1)`` half spectrum."""
    return 2 * (int(2 / 3 * n) // 2) * int(2 / 3 * (n // 2 + 1))


def sample_step_flops(cfg: dict) -> float:
    n = cfg["grid_size"]
    stage = 5 * fft_flops(n * n) + 3 * n * n + MODE_FLOPS * kept_modes(n)
    return STAGES * stage


def window_flops(rec) -> float:
    """Operations of every sample-step the window completed."""
    return rec.counters["sample_steps"] * sample_step_flops(rec.config)


def rollout_bound_s(rec):
    """The least time the traced solver calls could take: their operations
    at the peak rate, or each call's state read and written once at the
    peak bandwidth, whichever is longer. None without solver calls."""
    calls = rec.ranges.calls.get("bench.solver", 0)
    if not calls:
        return None
    flops = rec.ranges.counts["bench.solver"] * sample_step_flops(rec.config)
    state = kept_modes(rec.config["grid_size"]) * COMPLEX_BYTES[rec.cell["precision"]]
    moved = 2 * calls * rec.cell["batch"] * state
    return max(flops / rec.peak_flops, moved / rec.peak_bytes)

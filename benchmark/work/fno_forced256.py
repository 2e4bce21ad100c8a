"""Work of the FNO dataset's rollout: the forced IMEX order-2 step on every
mode of the rfft2 half spectrum (the unfused ``torch.fft`` route).

A step evaluates the explicit term twice. An evaluation takes 4 inverse real
transforms (two velocity components, two vorticity gradients) and 1 forward
transform on the n x n grid, the product -(u w_x + v w_y) (3 operations a
point), and on each mode the stream function (2), the velocity and gradient
factors (8), the 2/3 rule (2) and the forcing (2). The step's own work on
each mode is 30 operations: the implicit term and its right-hand side (6),
the two stages' right-hand sides (8), the two implicit solves (10) and the
blend of the two explicit terms (6). Bytes: each solver call reads and
writes its state once.
"""

from benchmark.work import fft_flops

EXPLICIT_EVALUATIONS = 2
EXPLICIT_MODE_FLOPS = 14
STEP_MODE_FLOPS = 30
COMPLEX_BYTES = {"float32": 8, "float64": 16}


def modes(n: int) -> int:
    """Modes of the ``(n, n//2+1)`` half spectrum, every one stepped."""
    return n * (n // 2 + 1)


def sample_step_flops(cfg: dict) -> float:
    n = cfg["grid_size"]
    explicit = 5 * fft_flops(n * n) + 3 * n * n + EXPLICIT_MODE_FLOPS * modes(n)
    return EXPLICIT_EVALUATIONS * explicit + STEP_MODE_FLOPS * modes(n)


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
    state = modes(rec.config["grid_size"]) * COMPLEX_BYTES[rec.cell["precision"]]
    moved = 2 * calls * rec.cell["batch"] * state
    return max(flops / rec.peak_flops, moved / rec.peak_bytes)

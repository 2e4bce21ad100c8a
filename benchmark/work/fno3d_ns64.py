"""Work of the FNO-3D train step (``drivers/train_fno3d.py``), counted from
what the inputs need, whatever implements it (``work/__init__.py``'s rule).

Forward, on ``P = b n^2 T_out`` spacetime points: the lift (a dense layer
from the ``T_in + 3`` input channels to the width); each block's spectral
conv (a real transform of the ``n x n x T_out`` volume a channel in and
one a channel out, and the corner blocks' complex contraction on ``(2 m)(2
m) m_t`` modes), its MLP (two ``width x width`` products) and its 1x1 skip;
the head (``width -> channel_expansion -> 1``); the loss's 2-D transforms of
prediction and target, a frame each. Backward counts twice the forward, and
Adam 12 operations a parameter. Elementwise work (GELUs, adds, the grid
channels) is not counted.
"""

import math

from benchmark.reference.fno3d import n_params
from benchmark.work import fft_flops

ADAM_FLOPS = 12
COMPLEX = 8  # bytes of a complex64 value


def _volume(cfg: dict) -> int:
    return cfg["grid_size"] ** 2 * cfg["out_steps"]


def _contraction(cfg: dict) -> float:
    """One sample's corner contraction of a conv."""
    m, mt, w = cfg["modes"], cfg["modes_t"], cfg["width"]
    return 8 * (2 * m) * (2 * m) * mt * w * w


def conv_flops(cfg: dict, b: int) -> float:
    """A spectral conv's forward on ``b`` samples."""
    w = cfg["width"]
    return b * (2 * w * fft_flops(_volume(cfg)) + _contraction(cfg))


def forward_flops(cfg: dict, b: int) -> float:
    n, t_out = cfg["grid_size"], cfg["out_steps"]
    w, e = cfg["width"], cfg["channel_expansion"]
    rows = b * _volume(cfg)
    total = 2 * rows * (cfg["time_steps"] + 3) * w
    total += cfg["num_layers"] * (conv_flops(cfg, b) + 2 * rows * 3 * w * w)
    total += 2 * rows * (w * e + e)
    total += b * 2 * t_out * fft_flops(n * n)  # the loss's transforms
    return total


def step_flops(cfg: dict, b: int) -> float:
    return 3 * forward_flops(cfg, b) + ADAM_FLOPS * n_params(cfg)


def window_flops(rec) -> float:
    return rec.counters["train_steps"] * step_flops(rec.config, rec.cell["batch"])


def conv_bound_s(rec):
    """The least time the forward spectral convs the port counted in the
    window (``fno3d.COUNTS``: those run op by op, the train steps'; on the
    card the test pass replays one CUDA graph, which moves no counter) could
    take: each conv's input read and output written once in fp32 and its
    spectral weights read once, against its transforms and contraction at
    the peak rate, whichever is longer. None without convs."""
    calls, points = rec.counters.get("conv_calls", 0), rec.counters.get("conv_points", 0)
    if not calls or not points:
        return None
    cfg = rec.config
    w, m, mt = cfg["width"], cfg["modes"], cfg["modes_t"]
    samples = points / _volume(cfg)
    flops = samples * (2 * w * fft_flops(_volume(cfg)) + _contraction(cfg))
    weights = 4 * m * m * mt * w * w * COMPLEX
    moved = 4 * points * 2 * w + calls * weights
    return max(flops / rec.peak_flops, moved / rec.peak_bytes)

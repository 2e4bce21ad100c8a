"""Work of the SFNO recipe's train step (channels last, ``(b, x, y, t, c)``).

Forward: the lifting (dense layer, temporal spectral conv, FFN), each
backbone layer (space-time spectral conv, FFN, 1x1 skip), the reduction and
the output's spectral conv over the padded time axis. A spectral conv is a
forward transform a channel in, the corner blocks' complex contraction on
``(2 mx)(2 my) mt`` modes, and an inverse transform a channel out. The loss
transforms prediction and target. Backward counts twice the forward, and
Adam 12 operations a parameter. Elementwise work (norm, activations,
residual adds) is not counted.
"""

import math

from benchmark.reference.sfno import param_spec
from benchmark.work import fft_flops

ADAM_FLOPS = 12


def _conv(b, nx, ny, t_in, t_out, ci, co, modes):
    mx, my, mt = modes
    return b * (ci * fft_flops(nx * ny * t_in) + co * fft_flops(nx * ny * t_out)
                + 8 * (2 * mx) * (2 * my) * mt * ci * co)


def forward_flops(cfg: dict, b: int) -> float:
    n, t, w = cfg["grid_size"], cfg["time_steps"], cfg["width"]
    e, lat, out = cfg["channel_expansion"] * w, cfg["latent_steps"], cfg["out_time_steps"]
    modes = (cfg["modes"], cfg["modes"], cfg["modes_t"])
    rows_in, rows = b * n * n * t, b * n * n * lat
    ffn = 2 * rows * (w * e + e * w)
    total = 2 * rows_in * w * w + _conv(b, n, n, t, lat, w, w, modes) + ffn
    for _ in range(cfg["num_layers"] - 1):
        total += _conv(b, n, n, lat, lat, w, w, modes) + ffn + 2 * rows * w * w
    total += 2 * rows * w
    padded = 2 * (lat + 1)
    total += _conv(b, n, n, padded, padded, 1, 1, modes)
    total += b * 2 * out * fft_flops(n * n)  # the loss's transforms
    return total


def step_flops(cfg: dict, b: int) -> float:
    params = sum(math.prod(shape) for _, shape, _, _ in param_spec(cfg))
    return 3 * forward_flops(cfg, b) + ADAM_FLOPS * params


def window_flops(rec) -> float:
    return rec.counters["train_steps"] * step_flops(rec.config, rec.cell["batch"])


def ffn_bound_s(rec):
    """The least time the traced FFN forwards could take: 2 products a row,
    or the rows read and written and the weights read once a call."""
    calls = rec.ranges.calls.get("bench.ffn", 0)
    if not calls:
        return None
    w = rec.config["width"]
    e = rec.config["channel_expansion"] * w
    rows = rec.ranges.counts["bench.ffn"]
    flops = 2 * rows * (w * e + e * w)
    moved = 4 * (rows * 2 * w + calls * (2 * w * e + e + w))
    return max(flops / rec.peak_flops, moved / rec.peak_bytes)

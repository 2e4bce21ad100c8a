"""Work of Spectral-Refiner's fine-tune (``drivers/refine.py``), counted
from what the inputs need, whatever implements it (``work/__init__.py``'s
rule): each transform of N real points 2.5 N log2 N operations, whichever
library or product computes it; each complex contraction 8 m k n; bytes
each transform's input read and its output written once, in fp64 (8 bytes
a real value, 16 a complex one). Elementwise work is not counted.

A sample's refine iteration, forward:

- the enlarged conv: the forward transform of the padded latent (the last
  frame and ``latent_steps`` steps, padded on the left to twice that in
  time), the contraction of its ``(2 mx)(2 my) mt`` kept modes with the
  1 x 1 weights, the inverse transform to ``out_steps + 1`` steps after the
  padding's;
- the post-process, on each of the ``out_steps`` planes: its rfft2, two
  Crank-Nicolson solves of 5 transforms each (the convection's 4 inverse and
  1 forward), the residual's convection (5), the 3 inverse transforms of
  w, w_t and the residual: 19 transforms of n^2 points; and the forcing's
  rfft2, once a call;
- the norm: the residual's 2-D transform, a plane.

Backward: the adjoint of each forward transform whose input carries a
gradient (all but the latent's and the forcing's), and the contraction's
weight gradient. A refine is ``iters`` iterations and one more forward (the
keep-best evaluation). A unit adds the zero-shot pass (the SFNO forward:
each spectral conv's transforms a channel in and out and its contraction,
the dense layers and FFNs at 2 operations a multiply-add) and the refined
trajectory (one conv forward).
"""

from benchmark.work import fft_flops

REAL, COMPLEX = 8, 16  # bytes of an fp64 value and of a complex128 one
POST_TRANSFORMS = 19   # a plane's transforms in the post-process


def _transform_bytes(real_points: int, last: int) -> float:
    """A transform between ``real_points`` real values and their half
    spectrum (the last axis of length ``last`` kept to ``last // 2 + 1``)."""
    return REAL * real_points + COMPLEX * real_points // last * (last // 2 + 1)


def _conv_shapes(cfg: dict):
    n = cfg["grid_size"]
    t_in = 2 * (cfg["latent_steps"] + 1)
    t_out = cfg["out_steps"] + 1 + cfg["latent_steps"] + 1
    return n * n * t_in, t_in, n * n * t_out, t_out


def _contraction(modes, ci: int, co: int) -> float:
    mx, my, mt = modes
    return 8 * (2 * mx) * (2 * my) * mt * ci * co


def conv_forward(cfg: dict, modes) -> tuple:
    """(operations, bytes) of an output conv's forward on one sample."""
    p_in, t_in, p_out, t_out = _conv_shapes(cfg)
    return (fft_flops(p_in) + _contraction(modes, 1, 1) + fft_flops(p_out),
            _transform_bytes(p_in, t_in) + _transform_bytes(p_out, t_out))


def iteration(cfg: dict) -> tuple:
    """(forward, backward) of one sample's refine iteration, each as
    (operations, bytes)."""
    n, planes = cfg["grid_size"], cfg["out_steps"]
    plane_ops, plane_bytes = fft_flops(n * n), _transform_bytes(n * n, n)
    conv_ops, conv_bytes = conv_forward(cfg, cfg["modes_ft"])
    p_out, t_out = _conv_shapes(cfg)[2:]
    per_planes = planes * (POST_TRANSFORMS + 1)
    forward = (conv_ops + per_planes * plane_ops, conv_bytes + per_planes * plane_bytes)
    backward = (fft_flops(p_out) + _contraction(cfg["modes_ft"], 1, 1) + per_planes * plane_ops,
                _transform_bytes(p_out, t_out) + per_planes * plane_bytes)
    return forward, backward


def refine_work(cfg: dict, samples: int) -> tuple:
    """(operations, bytes) of a refine of ``samples`` samples: the
    iterations, the keep-best evaluation, the forcing's transforms."""
    (f_ops, f_bytes), (b_ops, b_bytes) = iteration(cfg)
    n, iters = cfg["grid_size"], cfg["iters"]
    calls = iters + 1
    return (samples * (iters * (f_ops + b_ops) + f_ops) + calls * fft_flops(n * n),
            samples * (iters * (f_bytes + b_bytes) + f_bytes)
            + calls * _transform_bytes(n * n, n))


def zero_shot_flops(cfg: dict, samples: int) -> float:
    """The SFNO's forward on ``samples`` samples."""
    n, w, e = cfg["grid_size"], cfg["width"], cfg["channel_expansion"] * cfg["width"]
    steps, latent = cfg["steps"], cfg["latent_steps"]
    modes = (cfg["modes"], cfg["modes"], cfg["modes_t"])
    rows_in, rows = n * n * steps, n * n * latent
    ffn = 2 * rows * 2 * w * e
    lifting = (2 * rows_in * w * w + w * (fft_flops(rows_in) + fft_flops(rows))
               + _contraction(modes, w, w) + ffn)
    layer = 2 * w * fft_flops(rows) + _contraction(modes, w, w) + ffn + 2 * rows * w * w
    head = 2 * rows * w + conv_forward(cfg, modes)[0]
    return samples * (lifting + (cfg["num_layers"] - 1) * layer + head)


def unit_flops(cfg: dict, samples: int) -> float:
    return (zero_shot_flops(cfg, samples) + refine_work(cfg, samples)[0]
            + samples * conv_forward(cfg, cfg["modes_ft"])[0])


def window_flops(rec) -> float:
    """Operations of every unit the window completed."""
    return rec.counters["units"] * unit_flops(rec.config, rec.cell["batch"])


def refine_bound_s(rec):
    """The least time the traced refines could take: their operations at
    the peak rate or their bytes at the peak bandwidth, whichever is
    longer. None without refines."""
    calls = rec.ranges.calls.get("bench.refine", 0)
    if not calls:
        return None
    samples = rec.ranges.counts["bench.refine"]
    ops, nbytes = refine_work(rec.config, samples / calls)
    return calls * max(ops / rec.peak_flops, nbytes / rec.peak_bytes)


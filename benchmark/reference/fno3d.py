"""Plain reference of the FNO-3D train step on the FNO paper's data format.

The FNO-3D of Li et al., *Fourier Neural Operator for Parametric PDEs*
(ICLR 2021, arXiv:2010.08895; ``fourier_3d.py`` of
github.com/neuraloperator/neuraloperator), as torch-cfd's ``fno/fno3d.py``
defines it and the port's FNO3d training CLI trains it on an
FNO-paper-format file (``u`` shaped ``(N, n, n, T)``): the first ``T_in``
frames of a trajectory are its input and the next ``T_out`` its target.

- Input: the input frames normalised pointwise with the train set's
  statistics (mean and standard deviation over the samples, ``eps`` 1e-7
  added to the latter), broadcast along the output time axis, then the
  (x, y, t) grid channels: x and y on ``linspace(0, 1, n)``, t on
  ``linspace(0, 1, T_out + 1)[1:]``.
- A dense lift to ``width`` channels; ``num_layers`` blocks of a spectral
  conv, a pointwise MLP (``width`` → ``width`` → ``width``, GELU in its
  tanh form between) on the conv's output, plus a 1x1 skip of the block's
  input, then a GELU after every block but the last; the head, a dense
  layer to ``channel_expansion`` channels and one to a single channel.
- A spectral conv is ``rfftn`` over (x, y, t), the four (x, y) corner
  blocks of ``modes`` x ``modes`` modes at the ``modes_t`` lowest t modes
  times their complex weights (``(modes, modes, modes_t, ci, co)``, no
  bias), the other modes zero, and ``irfftn``.
- Loss: the relative Sobolev loss of order 0 (``reference/sfno.py``) of the
  prediction against the raw target frames; autograd; Adam (betas 0.9 and
  0.999, eps 1e-8, no weight decay) under the one-cycle cosine schedule,
  ``div_factor`` 1e4 and ``final_div_factor`` 1e3.

Departures from the paper, all the port's (torch-cfd's model and the
training CLI's recipe):

- the block: the conv's output goes through the MLP before the skip is
  added, and a GELU follows, where the paper adds conv and skip, applies
  BatchNorm and a ReLU; the head has no activation between its two layers
  (torch-cfd's ``last_activation=False``), where the paper's has a ReLU.
  At the paper's widths (20, modes 8/8/8, a 128-wide head) that is
  6,561,737 parameters against the paper's 6,558,537: +3,360 for the MLPs,
  -160 for BatchNorm;
- the loss: the relative Sobolev loss of order 0, where the paper takes the
  relative L2 loss of targets normalised and decoded again;
- the optimizer: Adam on the one-cycle schedule, where the paper steps the
  rate down by half every 100 epochs and decays weights by 1e-4.

Parameters are a dict by the port's ``state_dict`` names, spectral weights
as real pairs ``(modes, modes, modes_t, ci, co, 2)``, dense weights ``(out,
in)``. Products run in full float32 (TF32 off); ``tf32=True`` rounds the
operands of every product and transform to TF32 instead: the control.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from benchmark.reference.precision import rounder
from benchmark.reference.sfno import gelu, onecycle, sobolev_loss

Tensor = torch.Tensor

NORM_EPS = 1e-7
DIV_FACTOR, FINAL_DIV_FACTOR = 1e4, 1e3


def param_spec(cfg: dict) -> List[Tuple[str, tuple, str, float]]:
    """(name, shape, init, scale) of every parameter, in the port's order.

    ``init``: ``normal`` (a dense weight, std ``scale``), ``uniform`` (a
    spectral weight on ``[0, scale)``) or ``zeros``.
    """
    w, e = cfg["width"], cfg["channel_expansion"]
    modes = (cfg["modes"], cfg["modes"], cfg["modes_t"])
    layers = range(cfg["num_layers"])
    spec = []

    def dense(name, fan_in, fan_out):
        spec.append((f"{name}.weight", (fan_out, fan_in), "normal", math.sqrt(1.0 / fan_in)))
        spec.append((f"{name}.bias", (fan_out,), "zeros", 0.0))

    dense("lift", cfg["time_steps"] + 3, w)
    for i in layers:
        for j in range(4):
            spec.append((f"convs.{i}.weight_{j}", (*modes, w, w, 2), "uniform", 0.5 / (w * w)))
    for i in layers:
        dense(f"mlps.{i}.dense_0", w, w)
        dense(f"mlps.{i}.dense_1", w, w)
    for i in layers:
        dense(f"skips.{i}", w, w)
    dense("head.dense_0", w, e)
    dense("head.dense_1", e, 1)
    return spec


def n_params(cfg: dict) -> int:
    return sum(math.prod(shape) for _, shape, _, _ in param_spec(cfg))


def input_statistics(a: Tensor) -> Tuple[Tensor, Tensor]:
    """The train inputs' pointwise mean and standard deviation over the
    samples, ``a`` ``(N, n, n, T_in)``, computed in float64."""
    a = a.double()
    return a.mean(0), a.std(0, unbiased=False)


def normalize(a: Tensor, stats: Tuple[Tensor, Tensor]) -> Tensor:
    mean, std = stats
    return ((a.double() - mean) / (std + NORM_EPS)).to(a.dtype)


def make_input(a: Tensor, out_steps: int) -> Tensor:
    """``(b, n, n, T_in)`` -> ``(b, n, n, out_steps, T_in + 3)``."""
    b, nx, ny, t_in = a.shape
    kw = dict(dtype=a.dtype, device=a.device)
    gx = torch.linspace(0, 1, nx, **kw)[:, None, None].expand(nx, ny, out_steps)
    gy = torch.linspace(0, 1, ny, **kw)[None, :, None].expand(nx, ny, out_steps)
    gt = torch.linspace(0, 1, out_steps + 1, **kw)[1:][None, None, :].expand(nx, ny, out_steps)
    grid = torch.stack([gx, gy, gt], dim=-1)[None].expand(b, nx, ny, out_steps, 3)
    frames = a[:, :, :, None, :].expand(b, nx, ny, out_steps, t_in)
    return torch.cat([frames, grid], dim=-1)


class Model:
    """FNO-3D's forward as plain tensor operations on ``params``."""

    def __init__(self, cfg: dict, tf32: bool = False):
        self.cfg, self.r = cfg, rounder(tf32)
        self.modes = (cfg["modes"], cfg["modes"], cfg["modes_t"])

    def linear(self, p, name, x):
        return self.r(x) @ self.r(p[f"{name}.weight"]).T + p[f"{name}.bias"]

    def spectral(self, p, name, v):
        b, nx, ny, nt, _ = v.shape
        mx, my, mt = self.modes
        kt = nt // 2 + 1
        vh = torch.fft.rfftn(self.r(v), dim=(1, 2, 3))
        co = p[f"{name}.weight_0"].shape[-2]
        out = vh.new_zeros((b, nx, ny, kt, co))
        for ix, sx in enumerate((slice(0, mx), slice(nx - mx, nx))):
            for iy, sy in enumerate((slice(0, my), slice(ny - my, ny))):
                wgt = torch.view_as_complex(p[f"{name}.weight_{ix + 2 * iy}"].contiguous())
                out[:, sx, sy, :mt] = torch.einsum(
                    "bxyti,xytio->bxyto", self.r(vh[:, sx, sy, :mt]), self.r(wgt))
        return torch.fft.irfftn(self.r(out), s=(nx, ny, nt), dim=(1, 2, 3))

    def __call__(self, p: Dict[str, Tensor], a: Tensor) -> Tensor:
        """Normalised input frames ``(b, n, n, T_in)`` -> ``(b, n, n,
        out_steps)``."""
        cfg = self.cfg
        x = self.linear(p, "lift", make_input(a, cfg["out_steps"]))
        last = cfg["num_layers"] - 1
        for i in range(cfg["num_layers"]):
            x1 = self.spectral(p, f"convs.{i}", x)
            x1 = self.linear(p, f"mlps.{i}.dense_1", gelu(self.linear(p, f"mlps.{i}.dense_0", x1)))
            x = x1 + self.linear(p, f"skips.{i}", x)
            if i < last:
                x = gelu(x)
        return self.linear(p, "head.dense_1", self.linear(p, "head.dense_0", x))[..., 0]


def train(params0: Dict[str, Tensor], batches, cfg: dict, steps_per_epoch: int,
          tf32: bool = False, state: dict = None, betas=(0.9, 0.999), eps: float = 1e-8):
    """Adam over ``batches`` (a list of (normalised input frames, target
    frames)) from ``params0``.

    ``state`` is Adam's state to start from: ``exp_avg`` and ``exp_avg_sq``
    by leaf, ``step`` (the steps Adam has taken) and ``lr_step`` (the
    schedule's steps); none starts at zero. Returns ``(losses, grads,
    params)``: each step's loss, the first step's gradient by leaf, and the
    parameters after the last step.
    """
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _train(params0, batches, cfg, steps_per_epoch, tf32, state, betas, eps)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def _train(params0, batches, cfg, steps_per_epoch, tf32, state, betas, eps):
    model = Model(cfg, tf32)
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params0.items()}
    state = state or {"exp_avg": {}, "exp_avg_sq": {}, "step": 0, "lr_step": 0}
    m = {k: state["exp_avg"].get(k, torch.zeros_like(v)).to(v).clone() for k, v in p.items()}
    s = {k: state["exp_avg_sq"].get(k, torch.zeros_like(v)).to(v).clone()
         for k, v in p.items()}
    total = steps_per_epoch * cfg["epochs"]
    losses, first = [], None
    for j, (a, u) in enumerate(batches):
        t = state["step"] + j + 1
        loss = sobolev_loss(model(p, a), u)
        grads = torch.autograd.grad(loss, list(p.values()))
        losses.append(loss.item())
        lr = onecycle(state["lr_step"] + j, cfg["lr"], total, DIV_FACTOR, FINAL_DIV_FACTOR)
        if j == 0:
            first = {k: g.detach().clone() for k, g in zip(p, grads)}
        with torch.no_grad():
            for (k, v), g in zip(p.items(), grads):
                m[k].mul_(betas[0]).add_(g, alpha=1 - betas[0])
                s[k].mul_(betas[1]).add_(g * g, alpha=1 - betas[1])
                mh = m[k] / (1 - betas[0] ** t)
                vh = s[k] / (1 - betas[1] ** t)
                v.sub_(lr * mh / (vh.sqrt() + eps))
    return losses, first, {k: v.detach() for k, v in p.items()}

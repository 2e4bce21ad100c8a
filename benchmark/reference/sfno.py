"""Plain reference of the SFNO recipe's train step.

The spatiotemporal FNO (channels last, ``(b, x, y, t, c)``): positional
encoding, a LayerNorm over all non-batch dims, a dense layer, a temporal
spectral conv to the latent steps and a GELU (tanh) FFN with a residual on
the last input frame; ``num_layers - 1`` blocks of a space-time spectral
conv, an FFN and a 1x1 skip under GELU; a reduction to one channel; and a
temporally padded spectral conv with bias to the output steps, plus the last
input frame. Every spectral conv is ``rfftn`` over (x, y, t), the four
(x, y) corner blocks of modes times their weights, and ``irfftn``. Then the
relative Sobolev loss (order 0), autograd, and Adam under the one-cycle
cosine schedule.

Parameters are a dict by the port's ``state_dict`` names, spectral weights
as real pairs ``(*modes, ci, co, 2)``, dense weights ``(out, in)``.
``tf32=True`` rounds the operands of every product and transform to TF32:
the control.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.precision import rounder

Tensor = torch.Tensor


def param_spec(cfg: dict) -> List[Tuple[str, tuple, str, float]]:
    """(name, shape, init, scale) of every parameter, in the port's order.

    ``init``: ``normal`` (a dense weight, std ``scale``), ``uniform`` (a
    spectral weight on ``[0, scale)``), ``zeros`` or ``ones``.
    """
    w, e = cfg["width"], cfg["channel_expansion"] * cfg["width"]
    modes = (cfg["modes"], cfg["modes"], cfg["modes_t"])
    spec = []

    def dense(name, fan_in, fan_out):
        spec.append((f"{name}.weight", (fan_out, fan_in), "normal", math.sqrt(1.0 / fan_in)))
        spec.append((f"{name}.bias", (fan_out,), "zeros", 0.0))

    def spectral(name, ci, co, bias):
        for i in range(4):
            spec.append((f"{name}.weight_{i}", (*modes, ci, co, 2), "uniform",
                         0.5 / (ci * co)))
            if bias:
                spec.append((f"{name}.bias_{i}", (*modes, 2), "zeros", 0.0))

    def ffn(name):
        dense(f"{name}.dense_0", w, e)
        dense(f"{name}.dense_1", e, w)

    spec.append(("lifting.norm.scale", (w,), "ones", 1.0))
    spec.append(("lifting.norm.bias", (w,), "zeros", 0.0))
    dense("lifting.dense", w, w)
    spectral("lifting.conv", w, w, False)
    ffn("lifting.ffn")
    layers = range(cfg["num_layers"] - 1)
    for i in layers:
        spectral(f"convs.{i}", w, w, False)
    for i in layers:
        ffn(f"ffns.{i}")
    for i in layers:
        dense(f"skips.{i}", w, w)
    dense("reduce", w, 1)
    spectral("out_conv.conv", 1, 1, True)
    return spec


def positional_encoding(nx: int, ny: int, nt: int, channels: int, scale: float,
                        max_time_steps: int = 100) -> np.ndarray:
    """``(1, nx, ny, nt, channels)``: the x, y and t coordinates on [0, 1],
    then ``exp(scale t) sin(pi (k+1) t)`` for even k and ``cos`` for odd k."""
    t = np.linspace(0, 1, max_time_steps + 1)[1: nt + 1]
    gx, gy, gt = np.meshgrid(np.linspace(0, 1, nx), np.linspace(0, 1, ny), t,
                             indexing="ij")
    pe = [gx, gy, gt]
    for k in range(channels - 3):
        basis = np.sin if k % 2 == 0 else np.cos
        profile = np.exp(scale * t) * basis(np.pi * (k + 1) * t)
        pe.append(np.broadcast_to(profile, (nx, ny, nt)))
    return np.stack(pe, axis=-1)[None]


def gelu(x: Tensor) -> Tensor:
    return 0.5 * x * (1 + torch.tanh(math.sqrt(2 / math.pi) * (x + 0.044715 * x ** 3)))


class Model:
    """The SFNO's forward as plain tensor operations on ``params``."""

    def __init__(self, cfg: dict, tf32: bool = False):
        self.cfg, self.r = cfg, rounder(tf32)
        self.modes = (cfg["modes"], cfg["modes"], cfg["modes_t"])
        self._pe = {}

    def linear(self, p, name, x):
        return self.r(x) @ self.r(p[f"{name}.weight"]).T + p[f"{name}.bias"]

    def ffn(self, p, name, x):
        return self.linear(p, f"{name}.dense_1", gelu(self.linear(p, f"{name}.dense_0", x)))

    def spectral(self, p, name, v, out_t=None, t_pad=0, bias=False, delta=1.0):
        """rfftn over (x, y, t) -> corner blocks times weights -> irfftn to
        ``out_t`` steps (after a left zero padding of ``t_pad`` steps)."""
        b, nx, ny, nt, _ = v.shape
        mx, my, mt = self.modes
        if t_pad:
            v = F.pad(v, (0, 0, t_pad, 0))
        ntp = nt + t_pad
        out_t = nt if out_t is None else out_t
        vh = torch.fft.rfftn(self.r(v), dim=(1, 2, 3))
        kt = ntp // 2 + 1
        mt = min(mt, kt)
        co = p[f"{name}.weight_0"].shape[-2]
        out = vh.new_zeros((b, nx, ny, kt, co))
        for ix, sx in enumerate((slice(0, mx), slice(nx - mx, nx))):
            for iy, sy in enumerate((slice(0, my), slice(ny - my, ny))):
                i = ix + 2 * iy
                wgt = torch.view_as_complex(p[f"{name}.weight_{i}"].contiguous())[:, :, :mt]
                block = torch.einsum("bxyti,xytio->bxyto", self.r(vh[:, sx, sy, :mt]),
                                     self.r(wgt))
                if bias:
                    bc = torch.view_as_complex(p[f"{name}.bias_{i}"].contiguous())[:, :, :mt]
                    block = block + delta * bc[..., None]
                out[:, sx, sy, :mt] = block
        y = torch.fft.irfftn(self.r(out), s=(nx, ny, out_t + t_pad), dim=(1, 2, 3))
        return y[..., -out_t:, :] if t_pad else y

    def pe(self, v):
        key = (tuple(v.shape[1:4]), v.device, v.dtype)
        if key not in self._pe:
            _, nx, ny, nt, _ = v.shape
            self._pe[key] = torch.as_tensor(
                positional_encoding(nx, ny, nt, self.cfg["width"], self.cfg["beta"]),
                dtype=v.dtype, device=v.device)
        return self._pe[key]

    def __call__(self, p: Dict[str, Tensor], x: Tensor) -> Tensor:
        """``(b, n, n, t_in)`` -> ``(b, n, n, out_time_steps)``."""
        cfg = self.cfg
        out_steps = cfg["out_time_steps"]
        v = x[..., None] + self.pe(x[..., None])
        axes = tuple(range(1, v.ndim))
        mean = v.mean(dim=axes, keepdim=True)
        var = ((v - mean) ** 2).mean(dim=axes, keepdim=True)
        v = (v - mean) * torch.rsqrt(var + 1e-7) * p["lifting.norm.scale"] + p["lifting.norm.bias"]
        v = self.linear(p, "lifting.dense", v)
        w = self.ffn(p, "lifting.ffn", self.spectral(p, "lifting.conv", v,
                                                     out_t=cfg["latent_steps"]))
        v = gelu(v[..., -1:, :] + w)
        for i in range(cfg["num_layers"] - 1):
            v = gelu(self.ffn(p, f"ffns.{i}", self.spectral(p, f"convs.{i}", v))
                     + self.linear(p, f"skips.{i}", v))
        v = self.linear(p, "reduce", v)
        last = x[..., -1:, None]
        v = torch.cat([last, v], dim=-2)
        v = self.spectral(p, "out_conv.conv", v, out_t=out_steps + 1, t_pad=v.shape[-2],
                          bias=True, delta=cfg["delta"])
        return (last + v[..., -out_steps:, :])[..., 0]


def sobolev_loss(pred: Tensor, target: Tensor, alpha: float = 0.1) -> Tensor:
    """Relative Sobolev loss of order 0 on the unit square, time last: per
    sample ``||w (P - T)|| / ||w T|| / sqrt(nt)`` over the 2-D spectra and
    all steps, ``w = sqrt(alpha + 4 pi^2 |k|^2)``; the batch mean."""
    n, nt = pred.shape[1], pred.shape[-1]
    f = np.fft.fftfreq(n, d=1.0 / n)
    wgt = np.sqrt(alpha + 4 * np.pi ** 2 * (f[:, None] ** 2 + f[None, :] ** 2))
    wgt = torch.as_tensor(wgt[None, :, :, None], dtype=pred.dtype, device=pred.device)
    ph = torch.fft.fftn(pred, dim=(1, 2)) * wgt
    th = torch.fft.fftn(target, dim=(1, 2)) * wgt
    diff = torch.sqrt((torch.abs(ph - th) ** 2).sum(dim=(1, 2, 3)))
    ref = torch.sqrt((torch.abs(th) ** 2).sum(dim=(1, 2, 3)))
    return (diff / ref / math.sqrt(nt)).mean()


def onecycle(step: int, max_lr: float, total: int, div: float = 1e3,
             final_div: float = 1e4) -> float:
    """The learning rate of optimizer step ``step`` (from 0): cosine from
    ``max_lr/div`` up to ``max_lr`` over the first 30 % of ``total`` steps,
    then cosine down to ``max_lr/(div final_div)``, held there after."""
    if total < 5:
        return max_lr
    up = int(0.3 * total)
    lo, hi, end = max_lr / div, max_lr, max_lr / (div * final_div)
    if step < up:
        a, b, pct = lo, hi, step / up
    elif step < total:
        a, b, pct = hi, end, (step - up) / (total - up)
    else:
        return end
    return b + (a - b) / 2 * (math.cos(math.pi * pct) + 1)


def gather(data: Tensor, idx, starts, steps: int, out_steps: int):
    """Input and target windows of a batch from time-last ``(N, n, n, T)``
    trajectories: frames ``start .. start+steps`` and the next ``out_steps``."""
    xs, ys = [], []
    for i, s in zip(np.asarray(idx).tolist(), np.asarray(starts).tolist()):
        xs.append(data[i, ..., s: s + steps])
        ys.append(data[i, ..., s + steps: s + steps + out_steps])
    return torch.stack(xs), torch.stack(ys)


def train(params0: Dict[str, Tensor], batches, cfg: dict, steps_per_epoch: int,
          tf32: bool = False, state: dict = None, betas=(0.9, 0.999), eps: float = 1e-8):
    """Adam over ``batches`` (a list of (input, target)) from ``params0``.

    ``state`` is Adam's state to start from: ``exp_avg`` and ``exp_avg_sq``
    by leaf, ``step`` (the steps Adam has taken) and ``lr_step`` (the
    schedule's steps); none starts at zero. Returns ``(losses, grads,
    params)``: each step's loss, the first step's gradient by leaf, and the
    parameters after the last step. Products run in full float32 (TF32 off);
    the control rounds their operands instead.
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
    for j, (x, y) in enumerate(batches):
        t = state["step"] + j + 1
        loss = sobolev_loss(model(p, x), y)
        grads = torch.autograd.grad(loss, list(p.values()))
        losses.append(loss.item())
        lr = onecycle(state["lr_step"] + j, cfg["lr"], total)
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

"""Plain reference of Spectral-Refiner's fine-tune on the FNO data
(Cao, Browning & Li, ICLR 2025; torch-cfd's
``examples/ex2_SFNO_finetune_fnodata.ipynb`` and ``fno/finetune.py``).

A trained SFNO runs zero-shot on 10 frames at the evaluation mesh; the
reduced latent ``r`` (the input of its output conv) is kept. The output conv
is enlarged to more modes, the trained low-mode corners transplanted into a
fresh conv whose weights are its init draw times 1e-6 and whose biases are
0, and only that conv is refined by Adam, in two groups (the weights at
``lr_weight``, the biases at ``lr_bias``), against the NSE residual of its
output. The residual of a trajectory: each frame's rfft2; one
Crank-Nicolson IMEX solve at -dt and one at +dt (the 2/3 rule on the
convection), their BDF-weighted mean state and time derivative; the
residual ``w_t + (u . grad) w - nu lap w - f`` of those; and back. The loss
is the time-averaged norm of the residual under the weight
``(alpha + 4 pi^2 |k|^2)^(-1/4)`` on the 2-D spectrum, each sample's norm,
and the mean over the batch. The iteration with the least loss is kept
(the loss after the last update is taken too).

Everything is plain ``torch`` in the inputs' dtype: the SFNO's dense
layers and FFNs (ReLU, the class default the notebook builds with), its
spectral convs by ``rfftn`` and the corner blocks (``reference/sfno.py``'s
``Model.spectral`` and its positional encoding), the solver and the norm by
``torch.fft``, Adam by hand. Parameters are dicts by the port's
``state_dict`` names.

Departures from the notebook: the SFNO's weights are drawn from the seed,
not loaded from a trained checkpoint; a batch of trajectories is refined
together, one conv on the batch-mean loss (the notebook refines one); the
conv's fresh weights are drawn from ``torch.Generator`` seed 1 (the
notebook's are the global generator's).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Tuple

import torch

from benchmark.reference.sfno import Model

Tensor = torch.Tensor
FRESH_SEED = 1  # the generator of the enlarged conv's fresh draw
FRESH_GAIN = 1e-6  # its weights' scale; its biases start at 0


@contextlib.contextmanager
def no_tf32():
    """Full-precision products while open (TF32 off), as a reference runs."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def relu(x: Tensor) -> Tensor:
    return torch.clamp(x, min=0)


def _sfno_cfg(cfg: dict) -> dict:
    """``reference/sfno.py``'s configuration keys from this one's."""
    return dict(cfg, out_time_steps=cfg["out_steps"])


def _ft_cfg(cfg: dict) -> dict:
    mx, _, mt = cfg["modes_ft"]
    return dict(_sfno_cfg(cfg), modes=mx, modes_t=mt)


def zero_shot(p: Dict[str, Tensor], x: Tensor, cfg: dict) -> Tuple[Tensor, Tensor]:
    """The SFNO on ``x`` ``(b, n, n, steps)``: ``(prediction (b, n, n,
    out_steps), the reduced latent r (b, n, n, latent_steps, 1))``."""
    m = Model(_sfno_cfg(cfg))

    def ffn(name, v):
        return m.linear(p, f"{name}.dense_1", relu(m.linear(p, f"{name}.dense_0", v)))

    v = x[..., None] + m.pe(x[..., None])
    axes = tuple(range(1, v.ndim))
    mean = v.mean(dim=axes, keepdim=True)
    var = ((v - mean) ** 2).mean(dim=axes, keepdim=True)
    v = (v - mean) * torch.rsqrt(var + 1e-7) * p["lifting.norm.scale"] + p["lifting.norm.bias"]
    v = m.linear(p, "lifting.dense", v)
    w = ffn("lifting.ffn", m.spectral(p, "lifting.conv", v, out_t=cfg["latent_steps"]))
    v = relu(v[..., -1:, :] + w)
    for i in range(cfg["num_layers"] - 1):
        v = relu(ffn(f"ffns.{i}", m.spectral(p, f"convs.{i}", v))
                 + m.linear(p, f"skips.{i}", v))
    r = m.linear(p, "reduce", v)
    return out_conv(p, r, x, cfg, _sfno_cfg(cfg), cfg["delta"]), r


def out_conv(p: Dict[str, Tensor], r: Tensor, x: Tensor, cfg: dict, conv_cfg: dict = None,
             delta: float = None) -> Tensor:
    """The output conv on the latent ``r`` with the skip from ``x``'s last
    frame: the frame and the latent steps in time, padded on the left by as
    many zero steps, the conv with bias to ``out_steps + 1`` steps, the last
    ``out_steps`` kept and the frame added. ``conv_cfg`` and ``delta``
    default to the enlarged conv's."""
    conv_cfg = _ft_cfg(cfg) if conv_cfg is None else conv_cfg
    delta = cfg["delta_ft"] if delta is None else delta
    last = x[..., -1:, None]
    v = torch.cat([last, r], dim=-2)
    out_steps = cfg["out_steps"]
    y = Model(conv_cfg).spectral(p, "out_conv.conv", v, out_t=out_steps + 1,
                                 t_pad=v.shape[-2], bias=True, delta=delta)
    return (last + y[..., -out_steps:, :])[..., 0]


def initial_ft_params(sfno_p: Dict[str, Tensor], cfg: dict) -> Dict[str, Tensor]:
    """The enlarged conv's parameters before the refine: each corner block's
    fresh draw, uniform on [0, 0.5) in float32 from the generator
    ``FRESH_SEED`` (blocks 0 to 3 in turn) times ``FRESH_GAIN``, biases 0;
    then the SFNO's trained corner blocks in the low modes of each."""
    mx, my, mt = cfg["modes_ft"]
    m0, mt0 = cfg["modes"], cfg["modes_t"]
    ref = sfno_p["out_conv.conv.weight_0"]
    g = torch.Generator().manual_seed(FRESH_SEED)
    out = {}
    for i in range(4):
        w = torch.empty((mx, my, mt, 1, 1, 2), dtype=torch.float32).uniform_(0.0, 0.5,
                                                                          generator=g)
        out[f"out_conv.conv.weight_{i}"] = (w * FRESH_GAIN).to(ref)
        out[f"out_conv.conv.bias_{i}"] = torch.zeros((mx, my, mt, 2), dtype=ref.dtype,
                                                     device=ref.device)
    corners_x, corners_y = (slice(0, m0), slice(-m0, None)), (slice(0, m0), slice(-m0, None))
    for ix, sx in enumerate(corners_x):
        for iy, sy in enumerate(corners_y):
            for kind in ("weight", "bias"):
                name = f"out_conv.conv.{kind}_{ix + 2 * iy}"
                out[name][sx, sy, :mt0] = sfno_p[name].to(ref)
    return out


def forcing(n: int, cfg: dict, dtype, device) -> Tensor:
    """``scale (sin 2 pi k (x + y) + cos 2 pi k (x + y))`` on the cell
    corners of [0, 1)^2, ``(1, n, n)``."""
    x = torch.arange(n, dtype=torch.float64) / n
    s = 2 * math.pi * cfg["forcing_wave_number"] * (x[:, None] + x[None, :])
    f = cfg["forcing_scale"] * (torch.sin(s) + torch.cos(s))
    return f[None].to(dtype=dtype, device=device)


def post(w: Tensor, f: Tensor, cfg: dict) -> Dict[str, Tensor]:
    """``{w, w_t, residual}`` ``(b, n, n, T)`` of a trajectory ``w`` under
    the forcing ``f`` ``(1, n, n)``, by the +-dt Crank-Nicolson solves."""
    n = w.shape[1]
    dt, visc, (b_minus, b_plus) = cfg["ft_dt"], cfg["viscosity"], cfg["bdf_weight"]
    kx = torch.fft.fftfreq(n, d=1.0 / n, dtype=torch.float64)[:, None]
    ky = torch.fft.rfftfreq(n, d=1.0 / n, dtype=torch.float64)[None, :]
    keep = ((kx.abs() <= 2 / 3 * (n // 2)) & (ky <= 2 / 3 * (n // 2))).to(
        dtype=w.dtype, device=w.device)
    kx, ky = ((k / cfg["diam"]).to(dtype=w.dtype, device=w.device) for k in (kx, ky))
    lap = -4 * math.pi ** 2 * (kx ** 2 + ky ** 2)
    lap[0, 0] = 1.0  # the mean mode: psi's division stays finite
    ikx, iky = 2j * math.pi * kx, 2j * math.pi * ky

    def rfft2(z):
        return torch.fft.rfft2(z)

    def irfft2(z):
        return torch.fft.irfft2(z, s=(n, n))

    def convection(wh):
        psi = -wh / lap
        u, v = irfft2(iky * psi), irfft2(-ikx * psi)
        return keep * rfft2(u * irfft2(ikx * wh) + v * irfft2(iky * wh))

    wh = rfft2(w.movedim(-1, 1))
    fh = rfft2(f)[:, None]

    def crank_nicolson(h):
        half = 0.5 * h * visc * lap
        nxt = (-h * convection(wh) + h * fh + (1 + half) * wh) / (1 - half)
        return nxt, (nxt - wh) / h

    w_minus, wt_minus = crank_nicolson(-dt)
    w_plus, wt_plus = crank_nicolson(dt)
    w_bar = b_minus * w_minus + b_plus * w_plus
    wt_bar = b_minus * wt_minus + b_plus * wt_plus
    res = wt_bar + convection(w_bar) - visc * lap * w_bar - fh
    return {name: irfft2(z).movedim(1, -1)
            for name, z in (("w", w_bar), ("w_t", wt_bar), ("residual", res))}


def residual_norm(res: Tensor, cfg: dict) -> Tensor:
    """The batch mean of each sample's time-averaged weighted norm."""
    n, steps = res.shape[1], res.shape[-1]
    k = (torch.fft.fftfreq(n, d=1.0 / n, dtype=torch.float64) / cfg["diam"])
    wgt = (cfg["residual_alpha"] + 4 * math.pi ** 2 * (k[:, None] ** 2 + k[None, :] ** 2)
           ) ** -0.25
    wgt = wgt.to(dtype=res.dtype, device=res.device)[None, :, :, None]
    spec = torch.fft.fft2(res, dim=(1, 2)) * wgt
    per_sample = torch.sqrt((spec.abs() ** 2).sum(dim=(1, 2, 3)) / steps)
    return per_sample.mean()


def refine(p0: Dict[str, Tensor], r: Tensor, x: Tensor, cfg: dict,
           iters: int = None, keep_best: bool = True, betas=(0.9, 0.999), eps: float = 1e-8
           ) -> dict:
    """Adam on the enlarged conv's parameters ``p0`` against the residual
    norm of its output on the latent ``r`` and frames ``x``, ``iters``
    updates (default ``cfg``'s), keeping the best iterate (the last one
    without ``keep_best``). Returns ``history`` (the loss at each iterate:
    iters + 1 of them with ``keep_best``, iters without), ``refined`` (the
    trajectory of the iterate kept, ``(b, n, n, out_steps)``), ``first_w_t``
    (the post-process's time derivative at ``p0``), ``first_update`` (the
    L2 norm of the first update's change of the weights and of the biases)
    and ``change`` (the same of the last iterate's change from ``p0``)."""
    with no_tf32():
        return _refine(p0, r, x, cfg, cfg["iters"] if iters is None else iters, keep_best,
                       betas, eps)


def _refine(p0, r, x, cfg, iters, keep_best, betas, eps):
    f = forcing(x.shape[1], cfg, x.dtype, x.device)
    p = {k: v.detach().clone().requires_grad_(True) for k, v in p0.items()}
    lrs = {k: cfg["lr_bias"] if "bias" in k else cfg["lr_weight"] for k in p}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    s = {k: torch.zeros_like(v) for k, v in p.items()}
    out = {"history": [], "first_w_t": None, "first_update": None}

    def change():
        return [float(torch.sqrt(sum(((p[k] - p0[k].to(p[k])) ** 2).sum()
                                     for k in p if ("bias" in k) == group)))
                for group in (False, True)]

    def loss_of(params):
        fields = post(out_conv(params, r, x, cfg), f, cfg)
        if out["first_w_t"] is None:
            out["first_w_t"] = fields["w_t"].detach()
        return residual_norm(fields["residual"], cfg)

    history, best, kept = out["history"], math.inf, None
    for t in range(1, iters + 1):
        loss = loss_of(p)
        grads = torch.autograd.grad(loss, list(p.values()))
        history.append(loss.item())
        if history[-1] < best:
            best, kept = history[-1], {k: v.detach().clone() for k, v in p.items()}
        with torch.no_grad():
            for (k, v), g in zip(p.items(), grads):
                m[k].mul_(betas[0]).add_(g, alpha=1 - betas[0])
                s[k].mul_(betas[1]).add_(g * g, alpha=1 - betas[1])
                mh = m[k] / (1 - betas[0] ** t)
                vh = s[k] / (1 - betas[1] ** t)
                v.sub_(lrs[k] * mh / (vh.sqrt() + eps))
            if out["first_update"] is None:
                out["first_update"] = change()
    with torch.no_grad():
        out["change"] = change()
        if keep_best:
            history.append(loss_of(p).item())
            if history[-1] >= best:
                p = kept
        out["refined"] = out_conv(p, r, x, cfg)
    return out

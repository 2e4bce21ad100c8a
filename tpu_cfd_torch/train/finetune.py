"""A-posteriori fine-tuning (Spectral-Refiner): the output conv refined
against the PDE residual, differentiating through the CN-IMEX solver.

Counterpart of ``tpu_cfd/train/finetune.py``. ``OutConvFT`` runs the
trained SFNO's output conv (enlarged to the evaluation mesh's modes) on the
reduced latent ``r``, then ``fine_tune_post`` takes the temporal derivative
by ±dt Crank-Nicolson solves (``solvers/trajectories.imex_crank_nicolson_step``,
the step that the legacy rollout takes) and the spectral NSE residual, all
plain ``torch.fft`` and autograd. ``finetune_steps`` refines only that conv
with Adam, two parameter groups (bias fast, weight slow) where ``lr_bias``
is given; with a ``mesh`` it is data-parallel (the latents sharded on
``data``, the parameters replicated, the gradients averaged). No
hand-written kernel runs here: ``SpectralConvT`` takes its
DFT einsums or ``torch.fft`` in any dtype, and the examples' fine-tune runs
in fp64.

Spans (``utils.trace_annotation``): ``ft.forward`` around ``OutConvFT``'s
conv, ``ft.post`` around ``fine_tune_post``, and in each ``finetune_steps``
iteration ``ft.backward`` (autograd, and the gradients' average under a
mesh), ``ft.record`` (the loss's history entry, ``track``, the keep-best
copy) and ``ft.optimizer`` (Adam and the schedule). ``COUNTS`` counts the
iterations (Adam updates) and the keep-best copies (the latter when a
``finetune_steps`` call ends); ``reset_counts`` sets them to zero.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from tpu_cfd_torch.models.sfno import OutConv, SpectralConvT
from tpu_cfd_torch.solvers import trajectories
from tpu_cfd_torch.train.losses import BochnerNorm
from tpu_cfd_torch.utils.profiling import trace_annotation

Tensor = torch.Tensor

COUNTS = {"iterations": 0, "best_copies": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


class OutConvFT(nn.Module):
    """``OutConv`` + the differentiable solver post-process.

    ``forward(v, v_res, f=None, out_steps=None, original=False)`` runs the
    output conv on the latent ``v`` ``(b, x, y, t_latent, 1)`` with the skip
    from ``v_res`` ``(b, x, y, t_in)``, then (unless ``original`` or not
    ``finetune``) the temporal derivative by ±dt CN solves and the spectral
    residual under the forcing ``f`` ``(b or 1, x, y)``. Returns the tensor,
    or ``{"w", "w_t", "residual"}``, all ``(b, x, y, t)``.
    """

    def __init__(self, modes_x: int, modes_y: int, modes_t: int, delta: float = 5e-2,
                 diam: float = 1.0, out_steps: Optional[int] = None,
                 spatial_padding: int = 0, temporal_padding: bool = True,
                 norm: str = "backward", finetune: bool = True, dealias: bool = True,
                 visc: float = 1e-3, dt: float = 1e-6,
                 bdf_weight: Tuple[float, float] = (0.0, 1.0)):
        super().__init__()
        self.out_steps = out_steps
        self.finetune = finetune
        self.dealias = dealias
        self.visc, self.dt, self.diam, self.norm = visc, dt, diam, norm
        self.bdf_weight = tuple(bdf_weight)
        self.out_conv = OutConv(
            modes_x, modes_y, modes_t, delta=delta, out_steps=out_steps,
            spatial_padding=spatial_padding, temporal_padding=temporal_padding,
            norm=norm, diam=diam)

    @property
    def conv(self) -> SpectralConvT:
        return self.out_conv.conv

    def forward(self, v: Tensor, v_res: Tensor, f: Optional[Tensor] = None,
                out_steps: Optional[int] = None, original: bool = False):
        out_steps = out_steps if out_steps is not None else self.out_steps
        with trace_annotation("ft.forward"):
            v = self.out_conv(v, v_res, out_steps=out_steps)
        if not self.finetune or original:
            return v
        return self.post(v, f)

    def post(self, w: Tensor, f: Optional[Tensor]) -> Dict[str, Tensor]:
        """``fine_tune_post`` of a trajectory ``w`` under this module's
        solver settings."""
        return fine_tune_post(w, f, visc=self.visc, dt=self.dt, diam=self.diam,
                              bdf_weight=self.bdf_weight, dealias=self.dealias,
                              norm=self.norm)


def get_temporal_derivative(w_h: Tensor, f_h: Tensor, dt: float,
                            weight: Tuple[float, float] = (0.0, 1.0), **solver_kws
                            ) -> Tuple[Tensor, Tensor]:
    """BDF-weighted (ŵ, ∂ŵ/∂t) from CN-IMEX solves at -dt and +dt."""
    ws, w_ts = [], []
    for dt_ in (-dt, dt):
        w_, w_t_, *_ = trajectories.imex_crank_nicolson_step(
            w_h, f_h, delta_t=dt_, **solver_kws)
        ws.append(w_)
        w_ts.append(w_t_)
    w = weight[0] * ws[0] + weight[1] * ws[1]
    w_t = weight[0] * w_ts[0] + weight[1] * w_ts[1]
    return w, w_t


def fine_tune_post(w: Tensor, f: Optional[Tensor], visc: float = 1e-3,
                   dt: float = 1e-6, diam: float = 1.0,
                   bdf_weight: Tuple[float, float] = (0.0, 1.0),
                   dealias: bool = True, norm: str = "backward") -> Dict[str, Tensor]:
    """``{w, w_t, residual}`` of a trajectory ``w`` ``(b, x, y, t)``: each
    time slice to rfft2 space, one CN step each way for the derivative, the
    spectral residual, and back; differentiable."""
    with trace_annotation("ft.post"):
        b, nx, ny, _ = w.shape
        w_tfirst = torch.movedim(w, -1, 1)  # (b, t, x, y)
        if f is None:
            f = torch.zeros((b, nx, ny), dtype=w.dtype, device=w.device)
        w_h = torch.fft.rfftn(w_tfirst, s=(nx, ny), dim=(-2, -1), norm=norm)
        f_h = torch.fft.rfftn(f, s=(nx, ny), dim=(-2, -1), norm=norm)[:, None]

        rfftmesh = trajectories.default_rfft_mesh(nx, diam, dtype=w.dtype, device=w.device)
        laplacian = trajectories.spectral_laplacian_guarded(rfftmesh)
        dealias_filter = trajectories.default_dealias_filter(*rfftmesh, nx)
        solver_kws = dict(visc=visc, rfftmesh=rfftmesh, laplacian=laplacian,
                          dealias_filter=dealias_filter, dealias=dealias)
        w_h, w_h_t = get_temporal_derivative(w_h, f_h, dt, weight=bdf_weight, **solver_kws)
        res_h = trajectories.update_residual(w_h, w_h_t, f_h, **solver_kws)
        w_out, w_t, res = (
            torch.movedim(torch.fft.irfftn(z, s=(nx, ny), dim=(-2, -1), norm=norm), 1, -1)
            for z in (w_h, w_h_t, res_h))
        return dict(w=w_out, w_t=w_t, residual=res)


@torch.no_grad()
def transplant_spectral_weights(old_conv: Dict[str, Tensor], new_conv: Dict[str, Tensor],
                                old_modes: Sequence[int]) -> Dict[str, Tensor]:
    """``new_conv`` (a spectral conv's ``state_dict``) with the trained
    low-mode corner blocks of ``old_conv`` embedded, out of place.

    For each of the 4 corner blocks ``weight_i``/``bias_i`` (i = ix + 2·iy),
    the old (mx, my, mt) modes land in the matching corner of the new block;
    the rest keeps its (near-zero) fresh init.
    """
    mx, my, mt = old_modes
    slice_x = [slice(0, mx), slice(-mx, None)]
    slice_y = [slice(0, my), slice(-my, None)]
    new = {k: v.clone() for k, v in new_conv.items()}
    for ix, sx in enumerate(slice_x):
        for iy, sy in enumerate(slice_y):
            i = ix + 2 * iy
            for name in (f"weight_{i}", f"bias_{i}"):
                if name in old_conv and name in new:
                    new[name][sx, sy, :mt] = old_conv[name].to(new[name])
    return new


def build_finetune_outconv(trained_conv: nn.Module, old_modes: Sequence[int],
                           new_modes: Sequence[int], out_steps: int,
                           generator: Optional[torch.Generator] = None,
                           dtype: torch.dtype = torch.float32, device=None,
                           **ft_kwargs) -> OutConvFT:
    """An ``OutConvFT`` at the eval modes, seeded from a trained SFNO's
    output conv (``sfno.out_conv.conv``).

    A fresh init as the reference's ``conv._reset_parameters(gain=1e-6)``:
    every bias exactly zero and every weight at 1e-6 of its init draw, in
    ``dtype`` (fp64 keeps the fine-tune fp64 end to end); then the trained
    low-mode corners transplanted in, which carry all the signal.
    """
    model = OutConvFT(*new_modes, out_steps=out_steps, **ft_kwargs)
    model.conv.reset_parameters(generator)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.mul_(0.0 if "bias" in name else 1e-6)
    model.to(device=device, dtype=dtype)
    model.conv.load_state_dict(transplant_spectral_weights(
        trained_conv.state_dict(), model.conv.state_dict(), old_modes))
    return model


def groupwise_adam(lr_weight: float, lr_bias: float,
                   named_params) -> torch.optim.Adam:
    """Adam with separate learning rates for the parameters whose name holds
    ``"bias"`` and the rest: the bias is the learnable spectral correction,
    so it moves fast while the transplanted weights barely drift."""
    named = list(named_params)
    return torch.optim.Adam([
        {"params": [p for n, p in named if "bias" not in n], "lr": lr_weight},
        {"params": [p for n, p in named if "bias" in n], "lr": lr_bias},
    ])


def finetune_steps(model: OutConvFT, v_latent: Tensor, v_res: Tensor,
                   f: Optional[Tensor], out_steps: int, n_steps: int = 50,
                   lr: float = 1e-3, lr_bias: Optional[float] = None,
                   residual_norm: Optional[Callable] = None,
                   track: Optional[Callable] = None, keep_best: bool = True,
                   lr_decay: Optional[float] = None, mesh=None) -> List:
    """Adam refinement of ``model``'s parameters against the residual norm.

    Each step evaluates the loss (and ``track(out)``, extra metrics from the
    forward output) at the parameters before its update. ``lr_bias`` enables
    the two-group optimizer (``groupwise_adam``). ``lr_decay`` decays both
    rates exponentially to that end/start ratio over ``n_steps``
    (``optax.exponential_decay(lr, n_steps, lr_decay)``: the k-th update
    takes ``lr · lr_decay^(k/n_steps)``). Returns the history: one float per
    step, or a dict with ``"residual"`` and ``track``'s metrics.

    ``keep_best`` evaluates the parameters after the last update once more,
    appends that, and leaves the model at the best-residual parameters seen
    (a copy taken when they were): the Adam tail is non-monotonic at the
    discretization floor. Otherwise the model keeps its last parameters.

    The loop never waits for the device: each entry of the history stays a
    device scalar and the keep-best copy is a select on the device (the
    iterate's parameters where its residual is below the best so far), so
    the host queues the next iteration while the card runs this one. The
    history comes to the host once, after the loop, with the keep-best
    decision on the last evaluation.

    With a ``mesh`` (``parallel.make_mesh``), data parallelism as the JAX
    function's under a mesh: ``v_latent``, ``v_res`` (and a per-sample ``f``)
    are the rank's shards on ``data`` (``parallel.shard_batch``) and the
    model's parameters replicated (``parallel.replicate``). The gradients are
    averaged over ``data`` before each update, and each history entry
    (``track``'s metrics too) is the mean over ``data`` of the shards'
    values: the global value for a batch-mean ``residual_norm`` on equal
    shards, so ``keep_best`` decides alike on every rank.
    """
    if residual_norm is None:
        residual_norm = BochnerNorm(n_grid=v_res.shape[1], relative=False,
                                    time_last=True, mesh_weighted=True)
    opt = (groupwise_adam(lr, lr_bias, model.named_parameters()) if lr_bias is not None
           else torch.optim.Adam(model.parameters(), lr=lr))
    sched = None
    if lr_decay is not None:
        sched = torch.optim.lr_scheduler.LambdaLR(
            opt, lambda k: lr_decay ** (k / n_steps))

    def over_data(t) -> Tensor:
        t = torch.as_tensor(t, device=v_res.device).detach()
        if mesh is None:
            return t
        from tpu_cfd_torch.parallel import mean_over

        return mean_over(t, mesh)

    def record(loss: Tensor, out) -> None:
        value = over_data(loss)
        if track is None:
            history.append(value)
        else:
            with torch.no_grad():
                extras = track(out)
            history.append({"residual": value,
                            **{k: over_data(v) for k, v in extras.items()}})

    history: List = []
    best_loss = torch.full((), math.inf, dtype=torch.float64, device=v_res.device)
    best_state = copies = None
    if keep_best:
        best_state = {k: v.detach().clone() for k, v in model.state_dict().items()}
        copies = torch.zeros((), dtype=torch.int64, device=v_res.device)
    for _ in range(n_steps):
        opt.zero_grad(set_to_none=True)
        out = model(v_latent, v_res, f, out_steps=out_steps)
        loss = residual_norm(out["residual"])
        with trace_annotation("ft.backward"):
            loss.backward()
            if mesh is not None:
                from tpu_cfd_torch.parallel import average_gradients

                average_gradients(model.parameters(), mesh)
        with trace_annotation("ft.record"):
            record(loss, out)
            if keep_best:
                with torch.no_grad():
                    value = history_residual(history[-1]).to(best_loss)
                    better = value < best_loss
                    best_loss = torch.where(better, value, best_loss)
                    for k, v in model.state_dict().items():
                        best_state[k].copy_(torch.where(better, v, best_state[k]))
                    copies += better
        with trace_annotation("ft.optimizer"):
            opt.step()
            if sched is not None:
                sched.step()
        COUNTS["iterations"] += 1
    if keep_best:
        with torch.no_grad():
            out = model(v_latent, v_res, f, out_steps=out_steps)
            with trace_annotation("ft.record"):
                record(residual_norm(out["residual"]), out)
    history = _to_host(history)
    if keep_best:
        COUNTS["best_copies"] += int(copies)
        if history_residual(history[-1]) >= float(best_loss):
            model.load_state_dict(best_state)
    return history


def _to_host(history: List) -> List:
    """The history's device scalars as floats, in one copy to the host."""
    if not history:
        return history
    keys = list(history[0]) if isinstance(history[0], dict) else None
    rows = [[h[k] for k in keys] if keys else [h] for h in history]
    values = torch.stack([t.to(torch.float64) for row in rows for t in row]).tolist()
    width = len(rows[0])
    rows = [values[i: i + width] for i in range(0, len(values), width)]
    return [dict(zip(keys, row)) if keys else row[0] for row in rows]


def history_residual(entry) -> float:
    """The residual of one ``finetune_steps`` history entry."""
    return entry["residual"] if isinstance(entry, dict) else entry


def best_of(history: List) -> Tuple[int, float]:
    """(index, residual) of the least residual in a ``finetune_steps``
    history: index i is the residual after i Adam updates."""
    residuals = [history_residual(h) for h in history]
    i = int(np.argmin(residuals))
    return i, residuals[i]

"""Trajectory rollout, the CN-IMEX step and the spectral residual (PyTorch).

Counterpart of ``tpu_cfd/solvers/trajectories.py``. Records stay in the
frequency domain with time on axis -3. The target is one device, so the
chunked recorder has no device mesh. ``imex_crank_nicolson_step`` and
``update_residual`` are plain ``torch.fft`` arithmetic and differentiable:
the fine-tuning pipeline (``train/finetune.py``) differentiates through the
same step that ``get_trajectory_imex_crank_nicolson`` rolls out.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tpu_cfd_torch.ops.spectral import vorticity_to_velocity
from tpu_cfd_torch.solvers.equations import ImplicitExplicitODE
from tpu_cfd_torch.utils.profiling import trace_annotation

Tensor = torch.Tensor

_BDF_WEIGHTS = {
    1: [1, -1],
    2: [3 / 2, -2, 0.5],
    3: [11 / 6, -3, 3 / 2, -1 / 3],
    4: [25 / 12, -4, 3, -4 / 3, 1 / 4],
    5: [137 / 60, -5, 5, -10 / 3, 5 / 4, -1 / 5],
}


def backdiff(x: Tensor, order: int = 3) -> Tensor:
    """BDF(order) backward difference over the last axis."""
    if order > 5:
        raise NotImplementedError("only bdf order <= 5 is implemented")
    weights = torch.as_tensor(_BDF_WEIGHTS[order], dtype=x.real.dtype,
                              device=x.device)
    x_t = torch.flip(x[..., -(order + 1):], dims=(-1,)) * weights
    return x_t.sum(-1)


def default_rfft_mesh(n: int, diam: float = 1.0, dtype=torch.float32,
                      device=None) -> Tuple[Tensor, Tensor]:
    """The (kx, ky) wave numbers of an rfft2 spectrum ``(n, n//2+1)``,
    computed in float64 as ``jnp.fft.fftfreq`` does and cast to ``dtype``."""
    i = torch.arange(n, dtype=torch.float64, device=device)
    k = (((i + n // 2) % n - n // 2) / (diam / n * n)).to(dtype)
    kx, ky = torch.meshgrid(k, k, indexing="ij")
    k_max = n // 2
    return kx[..., : k_max + 1], ky[..., : k_max + 1]


def spectral_laplacian_guarded(rfftmesh: Tuple[Tensor, Tensor]) -> Tensor:
    """-4π²|k|², with the mean mode set to 1 so that it divides safely."""
    kx, ky = rfftmesh
    lap = -4 * (math.pi ** 2) * (kx ** 2 + ky ** 2)
    lap[..., 0, 0] = 1.0
    return lap


def default_dealias_filter(kx: Tensor, ky: Tensor, n: int) -> Tensor:
    """Boolean 2/3-rule mask of the CN kernels."""
    k_max = n // 2
    return (ky.abs() <= (2.0 / 3.0) * k_max) & (kx.abs() <= (2.0 / 3.0) * k_max)


def _convection(w_h: Tensor, psi_h: Tensor, kx: Tensor, ky: Tensor, n: int) -> Tensor:
    """(v·∇w)^ from ŵ and ψ̂, products taken on the physical grid."""
    specs = torch.stack([
        2 * math.pi * ky * 1j * psi_h,
        -2.0 * math.pi * kx * 1j * psi_h,
        2.0 * math.pi * kx * 1j * w_h,
        2.0 * math.pi * ky * 1j * w_h,
    ])
    u, v, w_x, w_y = torch.fft.irfft2(specs, s=(n, n)).unbind(0)
    return torch.fft.rfft2(u * w_x + v * w_y)


def update_residual(
    w_h: Tensor,
    w_h_t: Tensor,
    f_h: Tensor,
    visc: float,
    rfftmesh: Tuple[Tensor, Tensor],
    laplacian: Tensor,
    dealias_filter: Optional[Tensor] = None,
    dealias: bool = True,
) -> Tensor:
    """NSE residual in rfft2 space: ŵ_t + (v·∇w)^ - ν Δ̂ ŵ - f̂.

    Shapes: (..., n, n//2+1); differentiable.
    """
    kx, ky = rfftmesh
    convection_h = _convection(w_h, -w_h / laplacian, kx, ky, w_h.shape[-2])
    if dealias and dealias_filter is not None:
        convection_h = dealias_filter * convection_h
    return w_h_t + convection_h - visc * laplacian * w_h - f_h


def imex_crank_nicolson_step(
    w: Tensor,
    f: Tensor,
    visc: float,
    delta_t: float,
    diam: float = 1.0,
    rfftmesh: Optional[Tuple[Tensor, Tensor]] = None,
    laplacian: Optional[Tensor] = None,
    dealias_filter: Optional[Tensor] = None,
    dealias: bool = False,
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """One Crank-Nicolson IMEX update in rfft2 space.

    Inputs and outputs in the frequency domain, shapes (..., n, n//2+1).
    Returns (w_next, dw/dt, w, ψ̂, residual); differentiable.
    """
    size = w.shape
    if (size[-1] - 1) * 2 != size[-2]:
        raise ValueError(f"input must be an rfft2 spectrum, got shape {tuple(size)}")
    n = size[-2]
    if rfftmesh is None:
        rfftmesh = default_rfft_mesh(n, diam, dtype=w.real.dtype, device=w.device)
    kx, ky = rfftmesh
    if laplacian is None:
        laplacian = spectral_laplacian_guarded((kx, ky))
    if dealias_filter is None:
        dealias_filter = default_dealias_filter(kx, ky, n)

    psi_h = -w / laplacian
    convection_h = _convection(w, psi_h, kx, ky, n)
    if dealias:
        convection_h = dealias_filter * convection_h

    w_next = (
        -delta_t * convection_h
        + delta_t * f
        + (1.0 + 0.5 * delta_t * visc * laplacian) * w
    ) / (1.0 - 0.5 * delta_t * visc * laplacian)

    dwdt = (w_next - w) / delta_t
    res_h = dwdt + convection_h - visc * laplacian * w - f
    return w_next, dwdt, w, psi_h, res_h


_ALL_TRAJECTORY_FIELDS = ("vorticity", "stream", "vort_t", "residual")


def _stack_records(equation, ws, dwdts, fields) -> Dict[str, Tensor]:
    """Time-major (t, ..., kx, ky) records -> records dict, time at -3. One
    ``gen.extra_vars`` span (``utils.trace_annotation``) covers the fields
    beyond the vorticity, where any is asked for."""
    rec = {}
    if "vorticity" in fields:
        rec["vorticity"] = ws
    if set(fields) - {"vorticity"}:
        with trace_annotation("gen.extra_vars"):
            if "stream" in fields:
                _, psi = vorticity_to_velocity(equation.grid, ws)
                rec["stream"] = psi
            if "vort_t" in fields:
                rec["vort_t"] = dwdts
            if "residual" in fields:
                rec["residual"] = equation.residual(ws, dwdts)
    return {k: torch.movedim(v, 0, -3) for k, v in rec.items()}


def _check_fields(fields) -> None:
    unknown = set(fields) - set(_ALL_TRAJECTORY_FIELDS)
    if unknown:
        raise ValueError(f"unknown trajectory fields {sorted(unknown)}")


def get_trajectory_imex(
    equation: ImplicitExplicitODE,
    w0: Tensor,
    dt: float,
    num_steps: int = 1,
    record_every_steps: int = 1,
    fields: Tuple[str, ...] = _ALL_TRAJECTORY_FIELDS,
) -> Dict[str, Tensor]:
    """Rolls out ``equation`` from ŵ0 and records thinned spectral snapshots.

    The first record lands after 1 step, the next ones every
    ``record_every_steps``. Returns one ``(..., n_records, kx, ky)`` entry
    per field.
    """
    _check_fields(fields)
    num_records = -(-num_steps // record_every_steps)
    w, dwdt = equation.forward(w0, dt, steps=1)
    ws, dwdts = [w], [dwdt]
    for _ in range(num_records - 1):
        w, dwdt = equation.forward(w, dt, steps=record_every_steps)
        ws.append(w)
        dwdts.append(dwdt)
    return _stack_records(equation, torch.stack(ws), torch.stack(dwdts), fields)


@torch.no_grad()
def get_trajectory_imex_chunked(
    equation: ImplicitExplicitODE,
    w0: Tensor,
    dt: float,
    num_steps: int,
    record_every_steps: int = 1,
    fields: Tuple[str, ...] = _ALL_TRAJECTORY_FIELDS,
    records_per_chunk: Optional[int] = None,
    postprocess=None,
):
    """:func:`get_trajectory_imex` in chunks of ``records_per_chunk`` records.

    The record schedule is the same. ``postprocess`` (e.g. irfft2 + spatial
    subsample) runs on each chunk before it is copied to the host, so
    full-resolution spectral records never accumulate on the device. Spans
    (``utils.trace_annotation``): ``gen.record`` around a chunk's stacking,
    ``postprocess`` and host copy, ``gen.to_host`` around the copy alone.

    Returns (records dict of stacked host numpy arrays, final ŵ).
    """
    _check_fields(fields)
    num_records = -(-num_steps // record_every_steps)
    rpc = num_records if records_per_chunk is None else records_per_chunk
    chunks = []
    w = w0
    remaining = num_records
    lead_steps = 1
    while remaining > 0:
        n_recs = min(rpc, remaining)
        ws, dwdts = [], []
        for i in range(n_recs):
            w, dwdt = equation.forward(
                w, dt, steps=lead_steps if i == 0 else record_every_steps)
            ws.append(w)
            dwdts.append(dwdt)
        with trace_annotation("gen.record"):
            traj = _stack_records(equation, torch.stack(ws), torch.stack(dwdts), fields)
            if postprocess is not None:
                traj = postprocess(traj)
            with trace_annotation("gen.to_host"):
                chunks.append({k: v.cpu().numpy() for k, v in traj.items()})
        lead_steps = record_every_steps
        remaining -= n_recs
    out = {k: np.concatenate([c[k] for c in chunks], axis=-3) for k in chunks[0]}
    return out, w


def get_trajectory_imex_crank_nicolson(
    w0: Tensor,
    f: Tensor,
    visc: float = 1e-3,
    T: float = 10.0,
    delta_t: float = 1e-3,
    record_steps: int = 100,
    diam: float = 1.0,
    dealias: bool = True,
    subsample: int = 1,
) -> Dict[str, Tensor]:
    """Self-contained CN-IMEX rollout (the legacy path).

    ``w0``/``f`` are physical-space fields (..., n, n); outputs are
    physical-space records of vorticity, stream function, ∂w/∂t and the
    residual, with time on axis -3. Each record lands ``T/delta_t //
    record_steps`` steps after the one before.
    """
    n = w0.shape[-1]
    total_steps = math.ceil(T / delta_t)
    record_every = max(1, total_steps // record_steps)

    w_h = torch.fft.rfft2(w0)
    f_h = torch.fft.rfft2(f.to(w0.dtype))
    rfftmesh = default_rfft_mesh(n, diam, dtype=w0.dtype, device=w0.device)
    laplacian = spectral_laplacian_guarded(rfftmesh)
    dealias_filter = default_dealias_filter(*rfftmesh, n)

    def step(w):
        return imex_crank_nicolson_step(
            w, f_h, visc=visc, delta_t=delta_t, rfftmesh=rfftmesh,
            laplacian=laplacian, dealias_filter=dealias_filter, dealias=dealias)

    sl = (Ellipsis, slice(None, None, subsample), slice(None, None, subsample))
    recs = []
    for _ in range(record_steps):
        for _ in range(record_every - 1):
            w_h = step(w_h)[0]
        w_h, dwdt, _, psi_h, res_h = step(w_h)
        recs.append([torch.fft.irfft2(z, s=(n, n))[sl]
                     for z in (w_h, psi_h, dwdt, res_h)])
    out = (torch.stack(r, dim=-3) for r in zip(*recs))
    return dict(zip(["vorticity", "stream", "vort_t", "residual"], out))

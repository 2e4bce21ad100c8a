"""Trajectory rollout and the spectral residual (PyTorch).

Counterpart of ``tpu_cfd/solvers/trajectories.py``. Records stay in the
frequency domain with time on axis -3. The target is one device, so the
chunked recorder has no device mesh.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tpu_cfd_torch.ops.spectral import vorticity_to_velocity
from tpu_cfd_torch.solvers.equations import ImplicitExplicitODE

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
    n = w_h.shape[-2]
    kx, ky = rfftmesh
    psi_h = -w_h / laplacian
    specs = torch.stack([
        2 * math.pi * ky * 1j * psi_h,
        -2.0 * math.pi * kx * 1j * psi_h,
        2.0 * math.pi * kx * 1j * w_h,
        2.0 * math.pi * ky * 1j * w_h,
    ])
    u, v, w_x, w_y = torch.fft.irfft2(specs, s=(n, n)).unbind(0)
    convection_h = torch.fft.rfft2(u * w_x + v * w_y)
    if dealias and dealias_filter is not None:
        convection_h = dealias_filter * convection_h
    return w_h_t + convection_h - visc * laplacian * w_h - f_h


_ALL_TRAJECTORY_FIELDS = ("vorticity", "stream", "vort_t", "residual")


def _stack_records(equation, ws, dwdts, fields) -> Dict[str, Tensor]:
    """Time-major (t, ..., kx, ky) records -> records dict, time at -3."""
    rec = {}
    if "vorticity" in fields:
        rec["vorticity"] = ws
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
    full-resolution spectral records never accumulate on the device.

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
        traj = _stack_records(equation, torch.stack(ws), torch.stack(dwdts), fields)
        if postprocess is not None:
            traj = postprocess(traj)
        chunks.append({k: v.cpu().numpy() for k, v in traj.items()})
        lead_steps = record_every_steps
        remaining -= n_recs
    out = {k: np.concatenate([c[k] for c in chunks], axis=-3) for k in chunks[0]}
    return out, w

"""One explicit evaluation of the MAC-grid momentum equation: CUDA kernel and wrapper.

``explicit_rates(u, v, forcing, step, dt, viscosity, density, drag)`` returns
``(du/dt, dv/dt)`` for a batch ``(..., n0, n1)`` of periodic 2-D velocity
components on the standard staggered offsets, u at (1, 1/2) and v at (1/2, 1):
Van Leer convection (the TVD limiter on Lax-Wendroff), diffusion, the
forcing over the density and the drag, as
``solvers/fvm.py::NavierStokes2DFVMProjection._explicit_terms`` computes them
with its default ``convect``. ``forcing`` is a pair of ``(n0, n1)`` arrays
(the same for every sample) or None. On CUDA tensors it launches
``csrc/fvm_explicit.cu``, one launch for both components; on CPU tensors it
runs ``_explicit_plain``, the same arithmetic in plain PyTorch; on anything
else it raises. The solver decides where the kernel runs
(``NavierStokes2DFVMProjection._kernel_takes``); each launch is counted in
``LAUNCHES["explicit"]``.

Replaces no TPU kernel. The JAX package leaves these terms to XLA, which
fuses them; eager PyTorch runs them as about 300 elementwise kernels an
evaluation (rolls, wheres, divisions, adds), each a full pass over device
memory. The kernel is bound by bytes: u and v read and both rates written
once, 0.080 ms at b=512, 128², fp64 at 3.35 TB/s, with the fp64 arithmetic
close behind (about 8.4 divisions a cell). It stages a tile of both
components with a periodic halo of ``HALO`` in shared memory, computes each
face flux once and writes each rate once (the ``.cu`` header gives the
design). ``TILE`` and ``HALO`` are its block, for the tests' emulation of
its indexing.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from tpu_cfd_torch.ops.cuda import on_card

Tensor = torch.Tensor

# Kernel launches since the last reset_launch_counts().
LAUNCHES = {"explicit": 0}

TILE = (16, 32)  # rows and columns of a block's tile (csrc/fvm_explicit.cu TR, TC)
HALO = 2         # staged cells beyond the tile on every side
_ENTRY = {torch.float32: "fvm_explicit_f32", torch.float64: "fvm_explicit_f64"}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _face_fluxes(c: Tensor, w: Tensor, dim: int, courant: float) -> Tensor:
    """The flux through the face between i and i+1 along ``dim`` at every i:
    the Van Leer-limited Lax-Wendroff value of ``c`` times the face velocity
    ``w``, ``courant`` = dt / h."""
    cm, cp, cpp = (torch.roll(c, s, dim) for s in (1, -1, -2))
    pos = w > 0
    diff = cp - c
    low = torch.where(pos, c, cp)
    cw = courant * w
    high = torch.where(pos, c + 0.5 * (1 - cw) * diff, cp - 0.5 * (1 + cw) * diff)
    num = torch.where(pos, c - cm, cpp - cp)
    r = num / torch.where(diff != 0, diff, 1.0)
    one_r = 1 + r
    phi = torch.where(r > 0, 2 * r / torch.where(one_r != 0, one_r, 1.0), 0.0)
    return (low - (low - high) * phi) * w


def _explicit_plain(u: Tensor, v: Tensor, forcing: Optional[Sequence[Tensor]],
                    step: Sequence[float], dt: float, viscosity: float, density: float,
                    drag: float) -> Tuple[Tensor, Tensor]:
    """The kernel's arithmetic in plain PyTorch, on any device."""
    h0, h1 = step
    s0, s1 = 1 / h0**2, 1 / h1**2
    nu = viscosity / density
    rates = []
    for comp, c in enumerate((u, v)):
        own = comp - 2  # c's staggered axis, as a data dim
        adv = 0
        for a, (q, h) in enumerate(zip((u, v), step)):
            dim = a - 2
            w = 0.5 * q + 0.5 * torch.roll(q, -1, own)
            flux = _face_fluxes(c, w, dim, dt / h)
            adv = adv + (flux - torch.roll(flux, 1, dim)) * (1 / h)
        lap = (-2 * c * (s0 + s1) + (torch.roll(c, 1, -2) + torch.roll(c, -1, -2)) * s0
               + (torch.roll(c, 1, -1) + torch.roll(c, -1, -1)) * s1)
        rate = -adv + nu * lap
        if forcing is not None:
            rate = rate + forcing[comp] * (1 / density)
        if drag > 0.0:
            rate = rate + (-drag) * c
        rates.append(rate)
    return rates[0], rates[1]


# --------------------------------------------------------------- kernel ----

@functools.lru_cache(maxsize=None)
def _lib():
    from tpu_cfd_torch.ops.cuda import _build

    lib = _build.load("fvm_explicit")
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [P] * 6 + [I] * 3 + [D] * 7 + [P]
        fn.restype = I
    return lib


def _check(t: Tensor, like: Tensor, shape, name: str) -> None:
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, expected {like.device}")
    if t.dtype != like.dtype:
        raise ValueError(f"{name} is {t.dtype}, expected {like.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(u: Tensor, v: Tensor, forcing, step, dt, viscosity, density, drag):
    if u.dtype not in _ENTRY:
        raise ValueError(f"the fvm-explicit kernel takes float32 or float64, got {u.dtype}")
    if u.dim() < 2:
        raise ValueError(f"fields of shape (..., n0, n1) required, got {tuple(u.shape)}")
    if torch.is_grad_enabled() and (u.requires_grad or v.requires_grad):
        raise ValueError("the fvm-explicit kernel has no gradient")
    _check(u, u, u.shape, "u")
    _check(v, u, u.shape, "v")
    n0, n1 = u.shape[-2:]
    fu = fv = None
    if forcing is not None:
        for f, name in zip(forcing, ("forcing u", "forcing v")):
            _check(f, u, (n0, n1), name)
        fu, fv = (f.data_ptr() for f in forcing)
    du, dv = torch.empty_like(u), torch.empty_like(v)
    if u.numel() == 0:
        return du, dv
    lib = _lib()  # built at first use, before the device is made current
    with torch.cuda.device(u.device):
        err = getattr(lib, _ENTRY[u.dtype])(
            u.data_ptr(), v.data_ptr(), fu, fv, du.data_ptr(), dv.data_ptr(),
            u.numel() // (n0 * n1), n0, n1, dt / step[0], dt / step[1], step[0], step[1],
            viscosity / density, density, drag, torch.cuda.current_stream(u.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {_ENTRY[u.dtype]} failed with cudaError {err}")
    LAUNCHES["explicit"] += 1
    return du, dv


def explicit_rates(u: Tensor, v: Tensor, forcing: Optional[Sequence[Tensor]],
                   step: Sequence[float], dt: float, viscosity: float, density: float,
                   drag: float) -> Tuple[Tensor, Tensor]:
    """``(du/dt, dv/dt)``: the kernel on CUDA tensors, ``_explicit_plain`` on
    CPU tensors. ``step`` is the grid's (h0, h1); drag applies where it is
    above 0, as in the solver."""
    if on_card(u, "fvm-explicit"):
        return _launch(u, v, forcing, step, dt, viscosity, density, drag)
    return _explicit_plain(u, v, forcing, step, dt, viscosity, density, drag)

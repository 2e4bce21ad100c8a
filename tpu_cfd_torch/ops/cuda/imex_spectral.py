"""The pseudo-spectral IMEX-2 step's pointwise passes: CUDA kernels and wrappers.

Four passes over a batch of rfft2 half-spectra ``(..., n0, m)`` (or, for
``advect``, of physical planes ``(..., n0, n1)``), each one launch of
``csrc/imex_spectral.cu``, around the unchanged ``torch.fft`` transforms:

- ``spectra(w, c)``: the four spectra of an explicit evaluation, û and v̂
  from ψ̂ = -ŵ/Δ̂ and ∂ₓŵ, ∂ᵧŵ, in one fresh ``(4, ..., n0, m)`` buffer, as
  ``solvers/equations.py::NavierStokes2DSpectral._explicit_terms`` stacks
  them;
- ``advect(x, c)``: the advection term -(u ∂ₓω + v ∂ᵧω) from the four planes
  of ``torch.fft.irfft2(..., norm="forward")``, each first scaled by the
  normalisation that ``irfft2`` would have applied;
- ``finish(t, c)``: the 2/3 rule and the forcing's spectrum on the forward
  transform, in place;
- ``rk2_cn_stage(u, h, f, c, dt, alpha, beta)``: a stage of
  ``IMEXStepper``'s RK2 Crank-Nicolson update from the state ``u`` and the
  explicit terms ``h`` (and, in the second stage, ``f``), the right-hand
  side ``g = u + beta dt L u`` recomputed, not stored.

``c`` holds a solver's per-mode constants (``constants``), checked once.
On CUDA tensors each wrapper launches its kernel; on CPU tensors it runs its
plain version (``_spectra_plain``, ...), the solver's own torch operations in
the same order; on anything else it raises. The solver decides where they
run (``NavierStokes2DSpectral._kernel_takes``); each launch is counted in
``LAUNCHES``: an IMEX-2 step launches two of each.

Replaces no TPU kernel. The JAX package leaves this chain to XLA, which
fuses it; eager PyTorch runs it as about 85 kernels an IMEX-2 step, 45 of
them full passes over the batch. Each kernel is bound by bytes and moves each
value once, computing every operation as torch's kernel does, so the results
equal the composed path's on the card bit for bit (the ``.cu`` header gives
the design, the arithmetic and the bounds).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from tpu_cfd_torch.ops.cuda import on_card

Tensor = torch.Tensor

# Kernel launches since the last reset_launch_counts().
LAUNCHES = {"spectra": 0, "advect": 0, "finish": 0, "rk2_cn_stage": 0}

# the mode kernels' block and the most blocks a batch's samples spread over
# (csrc/imex_spectral.cu THREADS, SLICES), for the tests' emulation of the walk
THREADS, SLICES = 256, 32
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_COMPLEX = {torch.float32: torch.complex64, torch.float64: torch.complex128}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class Constants(NamedTuple):
    """A solver's per-mode constants on one device, in one real dtype, each
    contiguous of the half-spectrum's shape ``(n0, m)``: the symbols
    ``dx = 2πi kx``, ``dy = 2πi ky`` (complex), the Laplacian ``lap`` with 1
    at the zero mode, the linear term ``lin``, the 2/3-rule mask ``filt`` and
    the forcing's spectrum ``forcing`` (either may be None), the grid's
    ``shape`` ``(n0, n1)`` and ``scale``, the normalisation of its inverse
    transform."""

    dx: Tensor
    dy: Tensor
    lap: Tensor
    lin: Tensor
    filt: Optional[Tensor]
    forcing: Optional[Tensor]
    shape: Tuple[int, int]
    scale: float


def constants(dx: Tensor, dy: Tensor, lap: Tensor, lin: Tensor, filt: Optional[Tensor],
              forcing: Optional[Tensor], shape) -> Constants:
    """``Constants`` for a grid of ``shape`` ``(n0, n1)``; raises unless the
    tables are of one device and dtype, fp32 or fp64 (complex for the
    symbols and the forcing), contiguous and of the half-spectrum's shape."""
    real = lap.dtype
    if real not in _SUFFIX:
        raise ValueError(f"the IMEX-spectral kernels take float32 or float64, got {real}")
    n0, n1 = shape = tuple(shape)
    modes = (n0, n1 // 2 + 1)
    for name, t, dtype in (("dx", dx, _COMPLEX[real]), ("dy", dy, _COMPLEX[real]),
                           ("lap", lap, real), ("lin", lin, real), ("filt", filt, real),
                           ("forcing", forcing, _COMPLEX[real])):
        if t is None and name in ("filt", "forcing"):
            continue
        if (t.dtype != dtype or t.device != lap.device or tuple(t.shape) != modes
                or not t.is_contiguous()):
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on {t.device}, expected "
                             f"a contiguous {dtype} {modes} on {lap.device}")
    # torch.fft.irfft2's normalisation (ATen's _fft_normalization_scale)
    return Constants(dx, dy, lap, lin, filt, forcing, shape, 1.0 / float(n0 * n1))


# --------------------------------------------------------- plain versions ----

def _spectra_plain(w: Tensor, c: Constants) -> Tensor:
    psi = -w / c.lap
    return torch.stack([c.dy * psi, -(c.dx * psi), c.dx * w, c.dy * w])


def _advect_plain(x: Tensor, c: Constants) -> Tensor:
    vx, vy, grad_x, grad_y = (x * c.scale).unbind(0)
    return -(grad_x * vx + grad_y * vy)


def _finish_plain(t: Tensor, c: Constants) -> Tensor:
    if c.filt is not None:
        t = t * c.filt
    if c.forcing is not None:
        t = t + c.forcing
    return t


def _rk2_cn_stage_plain(u: Tensor, h: Tensor, f: Optional[Tensor], c: Constants, dt: float,
                        alpha: float, beta: float) -> Tensor:
    g = u + beta * dt * (c.lin * u)
    if f is not None:
        h = alpha * f + (1 - alpha) * h
    return 1 / (1 - beta * dt * c.lin) * (g + dt * h)


# -------------------------------------------------------------- kernels ----

@functools.lru_cache(maxsize=None)
def _lib():
    from tpu_cfd_torch.ops.cuda import _build

    lib = _build.load("imex_spectral")
    P, I, L, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
    signatures = {
        "spectra": [P, P, P, P, P, I, I, P],
        "advect": [P, P, L, D, P],
        "finish": [P, P, P, I, I, P],
        "rk2_cn_stage": [P, P, P, P, P, I, I, D, D, D, D, P],
    }
    for name, argtypes in signatures.items():
        for s in _SUFFIX.values():
            fn = getattr(lib, f"imex_{name}_{s}")
            fn.argtypes, fn.restype = argtypes, I
    return lib


def _check(c: Constants, kernel: str, *tensors: Tensor, spectral: bool = True) -> int:
    """The number of samples once ``tensors`` are what the kernel takes: of
    one shape ``(..., n0, m)`` (``(..., n0, n1)`` real where not
    ``spectral``), ``c``'s device and dtype (complex for spectra),
    contiguous, needing no gradient."""
    like = tensors[0]
    real = c.lap.dtype
    dtype = _COMPLEX[real] if spectral else real
    plane = tuple(c.lap.shape) if spectral else c.shape
    for t in tensors:
        if (t.device != c.lap.device or t.dtype != dtype or t.shape != like.shape
                or t.dim() < 2 or tuple(t.shape[-2:]) != plane):
            raise ValueError(f"the {kernel} kernel takes {dtype} fields (..., {plane[0]}, "
                             f"{plane[1]}) of one shape on {c.lap.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"the {kernel} kernel takes contiguous fields")
        if torch.is_grad_enabled() and t.requires_grad:
            raise ValueError(f"the {kernel} kernel has no gradient")
    return like.numel() // (plane[0] * plane[1])


def _run(name: str, c: Constants, *args) -> None:
    lib = _lib()  # built at first use, before the device is made current
    entry = f"imex_{name}_{_SUFFIX[c.lap.dtype]}"
    device = c.lap.device
    with torch.cuda.device(device):
        err = getattr(lib, entry)(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {entry} failed with cudaError {err}")
    LAUNCHES[name] += 1


def _spectra_launch(w: Tensor, c: Constants) -> Tensor:
    b = _check(c, "spectra", w)
    out = torch.empty((4, *w.shape), dtype=w.dtype, device=w.device)
    if b:
        _run("spectra", c, w.data_ptr(), c.dx.data_ptr(), c.dy.data_ptr(), c.lap.data_ptr(),
             out.data_ptr(), b, c.lap.numel())
    return out


def _advect_launch(x: Tensor, c: Constants) -> Tensor:
    if x.dim() < 3 or x.shape[0] != 4:
        raise ValueError(f"the advect kernel takes (4, ..., n0, n1), got {tuple(x.shape)}")
    _check(c, "advect", x, spectral=False)
    out = torch.empty(x.shape[1:], dtype=x.dtype, device=x.device)
    if out.numel():
        _run("advect", c, x.data_ptr(), out.data_ptr(), out.numel(), c.scale)
    return out


def _finish_launch(t: Tensor, c: Constants) -> Tensor:
    b = _check(c, "finish", t)
    if b and (c.filt is not None or c.forcing is not None):
        _run("finish", c, t.data_ptr(), None if c.filt is None else c.filt.data_ptr(),
             None if c.forcing is None else c.forcing.data_ptr(), b, c.lap.numel())
    return t


def _rk2_cn_stage_launch(u: Tensor, h: Tensor, f: Optional[Tensor], c: Constants,
                         dt: float, alpha: float, beta: float) -> Tensor:
    b = _check(c, "rk2_cn_stage", u, h, *(() if f is None else (f,)))
    out = torch.empty_like(u)
    if b:
        _run("rk2_cn_stage", c, u.data_ptr(), h.data_ptr(),
             None if f is None else f.data_ptr(), c.lin.data_ptr(), out.data_ptr(), b,
             c.lap.numel(), dt, beta * dt, alpha, 1 - alpha)
    return out


def spectra(w: Tensor, c: Constants) -> Tensor:
    """``[û, v̂, ∂ₓŵ, ∂ᵧŵ]`` of the vorticity spectra ``w`` ``(..., n0, m)`` as
    one ``(4, ..., n0, m)`` tensor: the kernel on CUDA tensors,
    ``_spectra_plain`` on CPU tensors."""
    if on_card(w, "imex-spectral"):
        return _spectra_launch(w, c)
    return _spectra_plain(w, c)


def advect(x: Tensor, c: Constants) -> Tensor:
    """-(u ∂ₓω + v ∂ᵧω) from the unnormalised inverse transforms ``x``
    ``(4, ..., n0, n1)`` of ``spectra``'s output: the kernel on CUDA tensors,
    ``_advect_plain`` on CPU tensors."""
    if on_card(x, "imex-spectral"):
        return _advect_launch(x, c)
    return _advect_plain(x, c)


def finish(t: Tensor, c: Constants) -> Tensor:
    """The advection spectrum ``t`` with the 2/3 rule and the forcing
    applied: the kernel, in place, on CUDA tensors, ``_finish_plain`` on CPU
    tensors."""
    if on_card(t, "imex-spectral"):
        return _finish_launch(t, c)
    return _finish_plain(t, c)


def rk2_cn_stage(u: Tensor, h: Tensor, f: Optional[Tensor], c: Constants, dt: float,
                 alpha: float, beta: float) -> Tensor:
    """A stage of the RK2 Crank-Nicolson update: with ``f`` None the first,
    ``(g + dt h) / (1 - beta dt L)``, else the step's result with
    ``alpha f + (1 - alpha) h`` for ``h``, where ``g = u + beta dt L u``: the
    kernel on CUDA tensors, ``_rk2_cn_stage_plain`` on CPU tensors."""
    if on_card(u, "imex-spectral"):
        return _rk2_cn_stage_launch(u, h, f, c, dt, alpha, beta)
    return _rk2_cn_stage_plain(u, h, f, c, dt, alpha, beta)

"""The FVM step's field passes around the pressure solve: CUDA kernels and wrappers.

Three passes over a batch ``(..., n0, n1)`` of periodic 2-D velocity
components on the standard staggered offsets, u at (1, 1/2) and v at
(1/2, 1), each one launch of ``csrc/fvm_projection.cu``:

- ``combine(u0, terms)``: ``u0 + c1 k1 + c2 k2 + ...`` for both components,
  summed in order, up to ``MAX_TERMS`` terms ``(c, (k_u, k_v))``: a
  Runge-Kutta stage state or step result as ``solvers/fvm.py::RKStepper``
  forms it;
- ``divergence(u, v, step)``: the MAC divergence
  ``(u - u[i-1])/h0 + (v - v[j-1])/h1``, the projection's right-hand side, as
  ``ops/finite_differences.py::divergence`` computes it;
- ``subtract_gradient(u, v, p, step)``: ``u - (p[i+1] - p)/h0`` and
  ``v - (p[j+1] - p)/h1``, the projected velocity, as
  ``solvers/pressure.py::PressureProjection`` forms it from the pressure.

On CUDA tensors each launches its kernel; on CPU tensors it runs its plain
version (``_combine_plain``, ``_divergence_plain``,
``_subtract_gradient_plain``), the solver's arithmetic in plain PyTorch, bit
for bit; on anything else it raises. The solver hands them the fields that
``fits_mac_kernels`` takes (the MAC-grid kernels' input contract, which
``solvers/fvm.py``'s explicit-terms kernel asks too), and on every device;
each launch is counted in ``LAUNCHES``.

Replaces no TPU kernel. The JAX package leaves these passes to XLA, which
fuses them; eager PyTorch runs them as about 116 elementwise kernels a
classic-RK4 step (rolls, negations, adds, scalar products), each a full
pass over device memory. Each kernel is bound by bytes and moves each value
once (the ``.cu`` header gives the design and the bounds); the Poisson solve
between the two stencils stays on cuFFT.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from tpu_cfd_torch import boundaries, grids
from tpu_cfd_torch.ops.cuda import on_card

Tensor = torch.Tensor
Pair = Tuple[Tensor, Tensor]

# Kernel launches since the last reset_launch_counts().
LAUNCHES = {"combine": 0, "divergence": 0, "subtract_gradient": 0}

MAX_TERMS = 4  # terms of one combine (csrc/fvm_projection.cu MAX_TERMS)
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def fits_mac_kernels(*vectors: grids.GridVariableVector) -> bool:
    """Whether ``vectors`` are velocities that the MAC-grid kernels of
    ``ops/cuda`` take: each two periodic components on the MAC offsets
    (``grid.cell_faces``) of one 2-D grid, the components' BCs the same in
    every vector, and fp32 or fp64 fields of one shape, device and dtype, on
    the CPU (their plain versions) or the card, that need no gradient."""
    if not all(len(v) == 2 and all(isinstance(u, grids.GridVariable) for u in v)
               for v in vectors):
        return False
    first = vectors[0]
    grid = first[0].grid
    if grid.ndim != 2:
        return False
    for v in vectors:
        if (any(u.grid != grid or u.bc != f.bc for u, f in zip(v, first))
                or tuple(u.offset for u in v) != grid.cell_faces
                or not boundaries.has_all_periodic_boundary_conditions(*v)):
            return False
    data = [u.data for v in vectors for u in v]
    a = data[0]
    if (a.dtype not in _SUFFIX or a.device.type not in ("cpu", "cuda")
            or tuple(a.shape[-2:]) != grid.shape):
        return False
    if any(t.dtype != a.dtype or t.device != a.device or t.shape != a.shape for t in data):
        return False
    return not (torch.is_grad_enabled() and any(t.requires_grad for t in data))


def _combine_plain(u0: Pair, terms: Sequence[Tuple[float, Pair]]) -> Pair:
    """The kernel's arithmetic in plain PyTorch, on any device."""
    u, v = u0
    for coef, (ku, kv) in terms:
        u, v = u + ku * coef, v + kv * coef
    return u, v


def _divergence_plain(u: Tensor, v: Tensor, step: Sequence[float]) -> Tensor:
    h0, h1 = step
    return (u - torch.roll(u, 1, -2)) / h0 + (v - torch.roll(v, 1, -1)) / h1


def _subtract_gradient_plain(u: Tensor, v: Tensor, p: Tensor, step: Sequence[float]) -> Pair:
    h0, h1 = step
    return u - (torch.roll(p, -1, -2) - p) / h0, v - (torch.roll(p, -1, -1) - p) / h1


# -------------------------------------------------------------- kernels ----

@functools.lru_cache(maxsize=None)
def _lib():
    from tpu_cfd_torch.ops.cuda import _build

    lib = _build.load("fvm_projection")
    P, I, L, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
    signatures = {
        "combine": [P, P, ctypes.POINTER(P), ctypes.POINTER(P), ctypes.POINTER(D), I, P, P, L, P],
        "divergence": [P, P, P, I, I, I, D, D, P],
        "subtract_gradient": [P, P, P, P, P, I, I, I, D, D, P],
    }
    for name, argtypes in signatures.items():
        for s in _SUFFIX.values():
            fn = getattr(lib, f"fvm_{name}_{s}")
            fn.argtypes, fn.restype = argtypes, I
    return lib


def _check(tensors: Sequence[Tensor], kernel: str) -> Tensor:
    """The first of ``tensors`` once all are fields this kernel takes: fp32
    or fp64, of one shape ``(..., n0, n1)``, device and dtype, contiguous,
    needing no gradient."""
    like = tensors[0]
    if like.dtype not in _SUFFIX:
        raise ValueError(f"the {kernel} kernel takes float32 or float64, got {like.dtype}")
    if like.dim() < 2:
        raise ValueError(f"fields of shape (..., n0, n1) required, got {tuple(like.shape)}")
    for t in tensors:
        if t.device != like.device or t.dtype != like.dtype or t.shape != like.shape:
            raise ValueError(f"the {kernel} kernel takes fields of one device, dtype and "
                             f"shape: {t.device}, {t.dtype}, {tuple(t.shape)} against "
                             f"{like.device}, {like.dtype}, {tuple(like.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"the {kernel} kernel takes contiguous fields")
        if torch.is_grad_enabled() and t.requires_grad:
            raise ValueError(f"the {kernel} kernel has no gradient")
    return like


def _run(name: str, like: Tensor, *args) -> None:
    lib = _lib()  # built at first use, before the device is made current
    entry = f"fvm_{name}_{_SUFFIX[like.dtype]}"
    with torch.cuda.device(like.device):
        err = getattr(lib, entry)(*args, torch.cuda.current_stream(like.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {entry} failed with cudaError {err}")
    LAUNCHES[name] += 1


def _plane(like: Tensor) -> Tuple[int, int, int]:
    n0, n1 = like.shape[-2:]
    return like.numel() // (n0 * n1), n0, n1


def _combine_launch(u0: Pair, terms: Sequence[Tuple[float, Pair]]) -> Pair:
    if not 1 <= len(terms) <= MAX_TERMS:
        raise ValueError(f"the combine kernel takes 1 to {MAX_TERMS} terms, got {len(terms)}")
    like = _check([*u0, *(k for _, pair in terms for k in pair)], "combine")
    out = torch.empty_like(u0[0]), torch.empty_like(u0[1])
    if like.numel() == 0:
        return out
    k0 = (ctypes.c_void_p * MAX_TERMS)(*(ku.data_ptr() for _, (ku, _) in terms))
    k1 = (ctypes.c_void_p * MAX_TERMS)(*(kv.data_ptr() for _, (_, kv) in terms))
    coef = (ctypes.c_double * MAX_TERMS)(*(float(c) for c, _ in terms))
    _run("combine", like, u0[0].data_ptr(), u0[1].data_ptr(), k0, k1, coef, len(terms),
         out[0].data_ptr(), out[1].data_ptr(), like.numel())
    return out


def _divergence_launch(u: Tensor, v: Tensor, step: Sequence[float]) -> Tensor:
    like = _check([u, v], "divergence")
    out = torch.empty_like(u)
    if like.numel() == 0:
        return out
    _run("divergence", like, u.data_ptr(), v.data_ptr(), out.data_ptr(), *_plane(like),
         *step)
    return out


def _subtract_gradient_launch(u: Tensor, v: Tensor, p: Tensor, step: Sequence[float]) -> Pair:
    like = _check([u, v, p], "subtract_gradient")
    out = torch.empty_like(u), torch.empty_like(v)
    if like.numel() == 0:
        return out
    _run("subtract_gradient", like, u.data_ptr(), v.data_ptr(), p.data_ptr(),
         out[0].data_ptr(), out[1].data_ptr(), *_plane(like), *step)
    return out


def combine(u0: Pair, terms: Sequence[Tuple[float, Pair]]) -> Pair:
    """``u0 + sum(c * k)`` over ``terms`` ``(c, (k_u, k_v))`` in order, each
    component: the kernel on CUDA tensors, ``_combine_plain`` on CPU tensors."""
    if on_card(u0[0], "fvm-projection"):
        return _combine_launch(u0, terms)
    return _combine_plain(u0, terms)


def divergence(u: Tensor, v: Tensor, step: Sequence[float]) -> Tensor:
    """The MAC divergence of ``(u, v)`` on a grid of step ``(h0, h1)``: the
    kernel on CUDA tensors, ``_divergence_plain`` on CPU tensors."""
    if on_card(u, "fvm-projection"):
        return _divergence_launch(u, v, step)
    return _divergence_plain(u, v, step)


def subtract_gradient(u: Tensor, v: Tensor, p: Tensor, step: Sequence[float]) -> Pair:
    """``(u, v)`` minus the forward-difference gradient of the cell-centred
    ``p``: the kernel on CUDA tensors, ``_subtract_gradient_plain`` on CPU
    tensors."""
    if on_card(u, "fvm-projection"):
        return _subtract_gradient_launch(u, v, p, step)
    return _subtract_gradient_plain(u, v, p, step)

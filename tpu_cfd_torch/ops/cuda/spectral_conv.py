"""Truncated 2-D DFT pair of the SFNO spectral conv: CUDA kernels and wrappers.

Replaces the TPU kernels of ``tpu_cfd/models/pallas_conv.py::make_dft2d_ops``
(``_modes_kernel`` and ``_inverse_kernel``):

- ``modes``:   real ``(b, P, nx, ny)`` -> complex ``(b, P, 2my, 2mx)``
  (y-modes before x-modes), modes ``[0..m-1, -m..-1]``;
- ``inverse``: complex ``(b, P, 2my, 2mx)`` -> ``scale · Re(Gx · g · Gyᵀ)``
  real ``(b, P, nx, ny)``.

Each is two passes of one batched complex GEMM in ``csrc/spectral_conv.cu``
(see its header for the design and the bound). The transform matrices come
in a dict ``c`` of ``FyT (ny, 2my)``, ``FxT (nx, 2mx)``, ``GxT (2mx, nx)``
and ``GyT (2my, ny)`` (``tpu_cfd_torch.models.fused_conv`` builds it).

Each wrapper dispatches on the device of its tensor: a CPU tensor runs the
plain PyTorch version (``_modes_plain``, ``_inverse_plain``), a CUDA tensor
launches the kernel or raises. ``dft2d_modes`` and ``dft2d_inverse`` are
``torch.autograd.Function``s whose backward is the partner transform. With
PyTorch's complex-gradient convention (the conjugate of JAX's cotangent)
the adjoints are the conjugate transposes, and ``conj(Fx)ᵀ = Gx`` for this
signed mode set, so both backwards reuse the forward matrices:
``dv = inverse(ḡ, 1)`` and ``ḡ = modes(scale · x̄)``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

Tensor = torch.Tensor

# Kernel launches per wrapper since the last reset_launch_counts().
LAUNCHES = {"modes": 0, "inverse": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------- plain ----

def _modes_plain(v: Tensor, c: dict) -> Tensor:
    """(b, P, nx, ny) real -> (b, P, 2my, 2mx) complex, the kernel's two products."""
    fy = c["FyT"]
    h = torch.complex(v @ fy.real, v @ fy.imag)      # (b, P, nx, 2my)
    return h.transpose(-1, -2) @ c["FxT"]


def _inverse_plain(g: Tensor, scale: float, c: dict) -> Tensor:
    """(b, P, 2my, 2mx) complex -> (b, P, nx, ny) real."""
    q = (g @ c["GxT"]).transpose(-1, -2)              # (b, P, nx, 2my)
    gy = c["GyT"]
    return scale * (q.real @ gy.real - q.imag @ gy.imag)


# --------------------------------------------------------------- kernels ----

@functools.lru_cache(maxsize=None)
def _lib():
    from tpu_cfd_torch.ops.cuda import _build

    lib = _build.load("spectral_conv")
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.dft2d_modes.argtypes = [P] * 5 + [L, I, I, I, I, P]
    lib.dft2d_inverse.argtypes = [P] * 5 + [L, I, I, I, I, F, P]
    lib.dft2d_modes.restype = lib.dft2d_inverse.restype = I
    return lib


def _check(t: Tensor, shape, dtype, device, name: str) -> None:
    if t.device != device or t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} on {device}, got {t.dtype} "
                         f"on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous() or t.is_conj():
        raise ValueError(f"{name} must be contiguous, with no lazy conjugate")


def _ok(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed with cudaError {err}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launch_modes(v: Tensor, c: dict) -> Tensor:
    b, P, nx, ny = v.shape
    my2, mx2 = c["FyT"].shape[1], c["FxT"].shape[1]
    _check(v, (b, P, nx, ny), torch.float32, v.device, "input")
    _check(c["FyT"], (ny, my2), torch.complex64, v.device, "FyT")
    _check(c["FxT"], (nx, mx2), torch.complex64, v.device, "FxT")
    h = torch.empty((b, P, nx, my2), dtype=torch.complex64, device=v.device)
    g = torch.empty((b, P, my2, mx2), dtype=torch.complex64, device=v.device)
    _ok(_lib().dft2d_modes(v.data_ptr(), c["FyT"].data_ptr(), c["FxT"].data_ptr(),
                           h.data_ptr(), g.data_ptr(), b * P, nx, ny, my2, mx2,
                           _stream(v.device)), "dft2d_modes")
    LAUNCHES["modes"] += 1
    return g


def _launch_inverse(g: Tensor, scale: float, c: dict) -> Tensor:
    b, P, my2, mx2 = g.shape
    nx, ny = c["GxT"].shape[1], c["GyT"].shape[1]
    _check(g, (b, P, my2, mx2), torch.complex64, g.device, "modes")
    _check(c["GxT"], (mx2, nx), torch.complex64, g.device, "GxT")
    _check(c["GyT"], (my2, ny), torch.complex64, g.device, "GyT")
    q = torch.empty((b, P, my2, nx), dtype=torch.complex64, device=g.device)
    out = torch.empty((b, P, nx, ny), dtype=torch.float32, device=g.device)
    _ok(_lib().dft2d_inverse(g.data_ptr(), c["GxT"].data_ptr(), c["GyT"].data_ptr(),
                             q.data_ptr(), out.data_ptr(), b * P, nx, ny, my2,
                             mx2, float(scale), _stream(g.device)), "dft2d_inverse")
    LAUNCHES["inverse"] += 1
    return out


def _dispatch(t: Tensor, plain, kernel):
    if t.device.type == "cpu":
        return plain
    if t.device.type == "cuda":
        return kernel
    raise ValueError(f"no spectral-conv kernel for device {t.device}")


def modes(v: Tensor, c: dict) -> Tensor:
    """Kernel ``dft2d_modes`` on CUDA tensors, its plain version on CPU tensors."""
    return _dispatch(v, _modes_plain, _launch_modes)(v, c)


def inverse(g: Tensor, scale: float, c: dict) -> Tensor:
    """Kernel ``dft2d_inverse`` on CUDA tensors, its plain version on CPU tensors."""
    return _dispatch(g, _inverse_plain, _launch_inverse)(g, scale, c)


def _dense(t: Tensor) -> Tensor:
    return t.resolve_conj().resolve_neg().contiguous()


class _Modes(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, c):
        ctx.c = c
        return modes(_dense(v), c)

    @staticmethod
    def backward(ctx, gbar):
        return inverse(_dense(gbar), 1.0, ctx.c), None


class _Inverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, scale, c):
        ctx.scale, ctx.c = scale, c
        return inverse(_dense(g), scale, c)

    @staticmethod
    def backward(ctx, xbar):
        return modes(_dense(xbar * ctx.scale), ctx.c), None, None


def dft2d_modes(v: Tensor, c: dict) -> Tensor:
    """Differentiable ``modes``; its backward is ``inverse`` with scale 1."""
    return _Modes.apply(v, c)


def dft2d_inverse(g: Tensor, scale: float, c: dict) -> Tensor:
    """Differentiable ``inverse``; its backward is ``modes`` of ``scale · x̄``."""
    return _Inverse.apply(g, scale, c)


def flops(planes: int, nx: int, ny: int, mx2: int, my2: int) -> float:
    """The fewest flops either transform needs on ``planes`` planes.

    The lesser of the dense truncated DFT (a real×complex and a complex
    contraction) and a real FFT of the whole plane, 2.5 N log2 N for
    N = nx·ny (half the 5 N log2 N of a complex FFT).
    """
    dense = planes * (4 * nx * ny * my2 + 8 * my2 * nx * mx2)
    fft = planes * 2.5 * nx * ny * math.log2(nx * ny)
    return min(dense, fft)

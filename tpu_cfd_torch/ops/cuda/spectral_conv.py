"""Truncated 2-D DFT pair of the SFNO spectral conv: CUDA kernels and wrappers.

Replaces the TPU kernels of ``tpu_cfd/models/pallas_conv.py::make_dft2d_ops``
(``_modes_kernel`` and ``_inverse_kernel``):

- ``modes``:   real ``(b, P, nx, ny)`` -> complex ``(b, P, 2my, 2mx)``
  (y-modes before x-modes), modes ``[0..m-1, -m..-1]``;
- ``inverse``: complex ``(b, P, 2my, 2mx)`` -> ``scale · Re(Gx · g · Gyᵀ)``
  real ``(b, P, nx, ny)``.

Each transform is one fused kernel on the tensor cores (3xTF32
``mma.sync`` on half of the modes: those a real input does not mirror for
``modes``, each mode folded with its mirror for ``inverse``, whose result
keeps only the real part) where a few planes, their intermediate and both
transform matrices fit in one SM's shared memory (``fused_modes_layout``,
``fused_inverse_layout``: 64² at m = 32 and m = 12 do, 256² does not), and
otherwise two passes of one batched complex GEMM in ``csrc/spectral_conv.cu``
(see its header for the designs and the bound). The shape alone picks the
route. The transform matrices come
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

from tpu_cfd_torch.ops.cuda import on_card

Tensor = torch.Tensor

# Kernel launches per wrapper since the last reset_launch_counts();
# "modes_fused" and "inverse_fused" count the launches that took the fused
# kernel.
LAUNCHES = {"modes": 0, "modes_fused": 0, "inverse": 0, "inverse_fused": 0}

# warps of a fused kernel's block (csrc/spectral_conv.cu FWARPS)
_WARPS = 8

# shared memory one block may use on an H100 (227 KB)
FUSED_SMEM_LIMIT = 232_448


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


# ---------------------------------------------------------- fused route ----

def _up(k: int, q: int) -> int:
    return -(-k // q) * q


def _stride(cols: int, r: int) -> int:
    """The least row stride >= ``cols`` words that is ``r`` mod 32."""
    return cols + (r - cols) % 32


@functools.lru_cache(maxsize=None)
def fused_modes_layout(nx: int, ny: int, my2: int, mx2: int):
    """The fused ``modes`` kernel's shared-memory layout for this shape, as
    ``(15 ints in the order of csrc/spectral_conv.cu's Layout, bytes)``, or
    ``None`` where the shape takes the two-pass route: rows of v not a whole
    number of 16-byte copies, or more than ``FUSED_SMEM_LIMIT`` bytes even
    for one plane at a time.

    A real input's transform mirrors itself, so the tensor cores compute
    H = v @ FyT for the ``my = my2 / 2`` modes y >= 0 and the ``my`` rows
    y >= 0 of g. Shared memory holds two v buffers of ``pp`` planes
    (m1 x sv each), the hi and lo TF32 parts of those ``my`` columns of FyT
    viewed as floats (k1 x sy) and of FxT (xr x sx), H of each plane
    (m1 x sh, its column n1 the mode y = -my), FyT's column of that mode and
    FxT's column of the mode x = -mx.
    The padding makes every tile whole; the strides are 4, 8 and 16 mod 32
    words, which keeps the fragment loads free of bank conflicts. ``pp`` is
    the fewest planes that give the 8 warps 8 tiles a contraction, as far as
    they fit.
    """
    if ny % 4 or my2 % 2 or mx2 % 2:
        return None
    my = my2 // 2
    k1, m1, n1 = _up(ny, 8), _up(nx, 32), _up(2 * my, 32)
    m2, n2, xr = _up(my, 32), _up(2 * mx2, 32), _up(nx, 4)
    sv, sy = _stride(k1, 4), _stride(n1, 8)
    sh, sx = _stride(max(n1 + 2, 2 * m2), 16), _stride(n2, 8)
    tiles = (m2 // 32) * (n2 // 32)
    layout = None
    for pp in range(1, max(1, -(-_WARPS // tiles)) + 1):
        nbytes = 4 * (2 * pp * m1 * sv + 2 * k1 * sy + 2 * xr * sx
                      + pp * m1 * sh + 2 * ny + 2 * nx)
        if nbytes > FUSED_SMEM_LIMIT:
            break
        layout = (nx, ny, my2, mx2, pp, k1, m1, n1, m2, n2, xr, sv, sy, sh, sx), nbytes
    return layout


@functools.lru_cache(maxsize=None)
def fused_inverse_layout(nx: int, ny: int, my2: int, mx2: int):
    """The fused ``inverse`` kernel's shared-memory layout for this shape, as
    ``(16 ints in the order of csrc/spectral_conv.cu's InvLayout, bytes)``,
    or ``None`` where the shape takes the two-pass route: an odd ``ny`` or
    mode count, a Q tile for more than one per warp, or more than
    ``FUSED_SMEM_LIMIT`` bytes even for one plane at a time.

    Only the real part is kept, so each mode is folded with its mirror as
    the planes are read, and the tensor cores take the ``my = my2 / 2`` rows
    y' >= 0 of the folded modes. Shared memory holds ``pp`` planes of g as
    they come (cp.async), one region for the folded modes (``r1 x sg``, the
    ``pp`` planes' rows stacked) and then Q^T (``pp`` planes of ``m2 x sq``),
    the hi and lo TF32 parts of GxT (``kr x sx``) and of B3 (``k2 x sy``,
    GyT's first ``my`` rows in real form), row -my's Q of each plane, the
    mirrors of column -mx, and Gx's column -mx and Gy's row -my. The strides
    are 4, 8, 4 and 8 mod 32 words. Each warp holds at most one tile of Q
    in registers while Q^T overwrites the folded modes, so ``pp`` stops at
    8 tiles of Q; up to 8 planes, it is the count with the fewest rounds of
    warp tiles per plane, the fewer planes on a tie.
    """
    if ny % 2 or my2 % 2 or mx2 % 2:
        return None
    my = my2 // 2
    kr, n1, m2 = _up(mx2, 4), _up(2 * nx, 32), _up(nx, 32)
    k2, n2 = _up(2 * my, 8), _up(ny, 32)
    sg, sx, sq, sy = _stride(2 * kr, 4), _stride(n1, 8), _stride(k2, 4), _stride(n2, 8)
    best = None
    for pp in range(1, _WARPS + 1):
        r1 = _up(pp * my, 32)
        tiles_x, tiles_y = (r1 // 32) * (n1 // 32), pp * (m2 // 32) * (n2 // 32)
        if tiles_x > _WARPS:
            break
        gsz = _up(max(r1 * sg, pp * m2 * sq), 4)
        nbytes = 4 * (pp * 2 * my2 * mx2 + gsz + 2 * kr * sx + 2 * k2 * sy
                      + 2 * (pp * nx + pp * my + nx + ny))
        if nbytes > FUSED_SMEM_LIMIT:
            break
        # rounds of 8 warp tiles, each as deep as its contraction, per plane
        cost = (-(-tiles_x // _WARPS) * 2 * kr + -(-tiles_y // _WARPS) * k2) / pp
        if best is None or cost < best[0]:
            ints = (nx, ny, my2, mx2, pp, r1, kr, n1, m2, k2, n2, sg, sx, sq, sy, gsz)
            best = cost, (ints, nbytes)
    return None if best is None else best[1]


# --------------------------------------------------------------- kernels ----

@functools.lru_cache(maxsize=None)
def _lib():
    from tpu_cfd_torch.ops.cuda import _build

    lib = _build.load("spectral_conv")
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.dft2d_modes.argtypes = [P] * 5 + [L, I, I, I, I, P]
    lib.dft2d_modes_fused.argtypes = [P] * 4 + [L, P, I, P]
    lib.dft2d_inverse.argtypes = [P] * 5 + [L, I, I, I, I, F, P]
    lib.dft2d_inverse_fused.argtypes = [P] * 4 + [L, F, P, I, P]
    for fn in (lib.dft2d_modes, lib.dft2d_modes_fused, lib.dft2d_inverse,
               lib.dft2d_inverse_fused):
        fn.restype = I
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
    """The current stream of ``device``. A launch (``<<<>>>``) goes to the
    host thread's current device, so each launch below runs under
    ``torch.cuda.device`` of its tensors."""
    return torch.cuda.current_stream(device).cuda_stream


def _check_modes(v: Tensor, c: dict):
    b, P, nx, ny = v.shape
    my2, mx2 = c["FyT"].shape[1], c["FxT"].shape[1]
    _check(v, (b, P, nx, ny), torch.float32, v.device, "input")
    _check(c["FyT"], (ny, my2), torch.complex64, v.device, "FyT")
    _check(c["FxT"], (nx, mx2), torch.complex64, v.device, "FxT")
    g = torch.empty((b, P, my2, mx2), dtype=torch.complex64, device=v.device)
    return b * P, nx, ny, my2, mx2, g


def _launch_modes_two_pass(v: Tensor, c: dict) -> Tensor:
    B, nx, ny, my2, mx2, g = _check_modes(v, c)
    h = torch.empty((B, nx, my2), dtype=torch.complex64, device=v.device)
    lib = _lib()  # built at first use, before the device is made current
    with torch.cuda.device(v.device):
        _ok(lib.dft2d_modes(v.data_ptr(), c["FyT"].data_ptr(), c["FxT"].data_ptr(),
                               h.data_ptr(), g.data_ptr(), B, nx, ny, my2, mx2,
                               _stream(v.device)), "dft2d_modes")
    LAUNCHES["modes"] += 1
    return g


def _launch_modes_fused(v: Tensor, c: dict, layout) -> Tensor:
    B, nx, ny, my2, mx2, g = _check_modes(v, c)
    if v.data_ptr() % 16:  # the kernel copies rows of v in 16-byte pieces
        v = v.clone()
    ints, nbytes = layout
    lib = _lib()  # built at first use, before the device is made current
    with torch.cuda.device(v.device):
        _ok(lib.dft2d_modes_fused(v.data_ptr(), c["FyT"].data_ptr(),
                                     c["FxT"].data_ptr(), g.data_ptr(), B,
                                     (ctypes.c_int * len(ints))(*ints), nbytes,
                                     _stream(v.device)), "dft2d_modes_fused")
    LAUNCHES["modes"] += 1
    LAUNCHES["modes_fused"] += 1
    return g


def _launch_modes(v: Tensor, c: dict) -> Tensor:
    """The fused kernel where the shape fits in shared memory, else two passes."""
    layout = fused_modes_layout(v.shape[-2], v.shape[-1], c["FyT"].shape[1],
                                c["FxT"].shape[1])
    if layout is None:
        return _launch_modes_two_pass(v, c)
    return _launch_modes_fused(v, c, layout)


def _check_inverse(g: Tensor, c: dict):
    b, P, my2, mx2 = g.shape
    nx, ny = c["GxT"].shape[1], c["GyT"].shape[1]
    _check(g, (b, P, my2, mx2), torch.complex64, g.device, "modes")
    _check(c["GxT"], (mx2, nx), torch.complex64, g.device, "GxT")
    _check(c["GyT"], (my2, ny), torch.complex64, g.device, "GyT")
    out = torch.empty((b, P, nx, ny), dtype=torch.float32, device=g.device)
    return b * P, nx, ny, my2, mx2, out


def _launch_inverse_two_pass(g: Tensor, scale: float, c: dict) -> Tensor:
    B, nx, ny, my2, mx2, out = _check_inverse(g, c)
    q = torch.empty((B, my2, nx), dtype=torch.complex64, device=g.device)
    lib = _lib()  # built at first use, before the device is made current
    with torch.cuda.device(g.device):
        _ok(lib.dft2d_inverse(g.data_ptr(), c["GxT"].data_ptr(), c["GyT"].data_ptr(),
                                 q.data_ptr(), out.data_ptr(), B, nx, ny, my2,
                                 mx2, float(scale), _stream(g.device)), "dft2d_inverse")
    LAUNCHES["inverse"] += 1
    return out


def _launch_inverse_fused(g: Tensor, scale: float, c: dict, layout) -> Tensor:
    B, nx, ny, my2, mx2, out = _check_inverse(g, c)
    if g.data_ptr() % 16:  # the kernel copies planes of g in 16-byte pieces
        g = g.clone()
    ints, nbytes = layout
    lib = _lib()  # built at first use, before the device is made current
    with torch.cuda.device(g.device):
        _ok(lib.dft2d_inverse_fused(g.data_ptr(), c["GxT"].data_ptr(),
                                       c["GyT"].data_ptr(), out.data_ptr(), B,
                                       float(scale), (ctypes.c_int * len(ints))(*ints),
                                       nbytes, _stream(g.device)), "dft2d_inverse_fused")
    LAUNCHES["inverse"] += 1
    LAUNCHES["inverse_fused"] += 1
    return out


def _launch_inverse(g: Tensor, scale: float, c: dict) -> Tensor:
    """The fused kernel where the shape fits in shared memory, else two passes."""
    layout = fused_inverse_layout(c["GxT"].shape[1], c["GyT"].shape[1], g.shape[-2],
                                  g.shape[-1])
    if layout is None:
        return _launch_inverse_two_pass(g, scale, c)
    return _launch_inverse_fused(g, scale, c, layout)


def modes(v: Tensor, c: dict) -> Tensor:
    """Kernel ``dft2d_modes`` on CUDA tensors, its plain version on CPU tensors."""
    if on_card(v, "spectral-conv"):
        return _launch_modes(v, c)
    return _modes_plain(v, c)


def inverse(g: Tensor, scale: float, c: dict) -> Tensor:
    """Kernel ``dft2d_inverse`` on CUDA tensors, its plain version on CPU tensors."""
    if on_card(g, "spectral-conv"):
        return _launch_inverse(g, scale, c)
    return _inverse_plain(g, scale, c)


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

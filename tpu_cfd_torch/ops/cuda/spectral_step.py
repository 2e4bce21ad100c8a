"""Fused low-storage RK4-CN pseudo-spectral stepper: CUDA kernels and wrappers.

Replaces the TPU kernel ``tpu_cfd/ops/pallas/spectral_step.py::_make_kernel``
(its ``pallas_call`` in ``_fused_rollout``), in both of its layouts:
``fused_rollout_galerkin`` marches a ``(..., R, m)`` spectrum on the 2/3-rule
Galerkin block, ``fused_rollout_aligned`` an ``(..., n, n//2)`` spectrum with
a brick-wall mask per stage. Both compute ``steps`` Carpenter-Kennedy steps
of five stages; each stage is three hand-written kernels in
``csrc/spectral_step.cu`` (see its header for the design and the bound):

- ``inverse_first``: multipliers fused into the first-axis inverse
  transforms, per tile of columns, as radix FFTs in shared memory;
- ``advect``: inverse last axis, advection product, forward last axis, per
  tile of whole physical rows, as radix FFTs in shared memory;
- ``forward_first``: forward first axis with the Crank-Nicolson update, per
  tile of columns, as radix FFTs in shared memory.

Every kernel has a wrapper that dispatches on the device of the tensor it
is given: a CPU tensor goes to the plain PyTorch version of the same
arithmetic (``_inverse_first_plain`` ...), a CUDA tensor launches the
kernel or raises. Each wrapper counts its launches in ``LAUNCHES``.
``_fused_rollout_plain`` is the whole rollout in plain PyTorch.

On the card every precision mode computes in fp32 FFMA, at least the
accuracy ``"highest"`` asks for: K1, K2 and K3 run Stockham passes in
registers and shared memory (the ``.cu`` header gives the design).
``constants`` lays the operands out for them (the FFTs' twiddle table
``tw``) beside the plain versions' matrices; ``inverse_layout``,
``advect_layout`` and ``forward_layout`` pick the kernels' blocks from the
shape and refuse an n the kernels do not take. The rollout is forward-only:
taking a gradient through it raises, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from tpu_cfd_torch.ops import dft2d
from tpu_cfd_torch.ops.cuda import on_card

Tensor = torch.Tensor

# Carpenter-Kennedy low-storage RK4 tables (solvers/equations.py)
_ALPHAS = (0.0, 0.1496590219993, 0.3704009573644, 0.6222557631345,
           0.9582821306748, 1.0)
_BETAS = (0.0, -0.4178904745, -1.192151694643, -1.697784692471,
          -1.514183444257)
_GAMMAS = (0.1496590219993, 0.3792103129999, 0.8229550293869,
           0.6994504559488, 0.1530572479681)

# Kernel launches per wrapper since the last reset_launch_counts().
LAUNCHES = {"inverse_first": 0, "advect": 0, "forward_first": 0}

# the grid sizes the kernels (csrc/spectral_step.cu inverse_fft_kernel,
# advect_fft_kernel, forward_fft_kernel) take
_K2_MIN_N, _K2_MAX_N = 16, 2048


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _mode_constants(n, step, viscosity, drag, dt, rows, m, filt):
    """Per-mode constants on the ``(len(rows), m)`` block, host numpy."""
    ridx = np.asarray(rows)
    fx = np.fft.fftfreq(n, d=step[0]).astype(np.float64)[ridx]
    fy = np.fft.fftfreq(n, d=step[1])[:m].astype(np.float64)
    kx = np.broadcast_to(fx[:, None], (len(rows), m)).copy()
    ky = np.broadcast_to(fy[None, :], (len(rows), m)).copy()
    lap = -4 * np.pi**2 * (kx**2 + ky**2)
    lap_g = lap.copy()
    lap_g[0, 0] = 1.0  # rows[0] is mode 0 in both layouts
    lin = viscosity * lap - drag
    mus = tuple(0.5 * dt * (_ALPHAS[k + 1] - _ALPHAS[k]) for k in range(5))
    dens = np.stack([1.0 / (1.0 - mu * lin) for mu in mus])
    f32 = np.float32
    return {
        "tkx": (2 * np.pi * kx).astype(f32),
        "tky": (2 * np.pi * ky).astype(f32),
        "ilap": (1.0 / lap_g).astype(f32),
        "filt": filt.astype(f32),
        "lin": lin.astype(f32),
        "dens": dens.astype(f32),
        "mus": mus,
    }


@functools.lru_cache(maxsize=None)
def _host_constants(n: int, step: Tuple[float, float], viscosity: float,
                    drag: float, dt: float):
    """Aligned ``(n, n//2)`` layout: all modes, 2/3-rule mask as ``filt``."""
    m = n // 2
    fx = np.fft.fftfreq(n, d=step[0]).astype(np.float64)
    kx_ord = np.round(fx * n * step[0]).astype(int)
    kmax_x = int(2 / 3 * n) // 2
    keep_x = (-kmax_x <= kx_ord) & (kx_ord < kmax_x)
    keep_y = np.arange(m) < int(2 / 3 * (n // 2 + 1))
    return _mode_constants(n, step, viscosity, drag, dt, tuple(range(n)), m,
                           np.outer(keep_x, keep_y))


@functools.lru_cache(maxsize=None)
def _host_constants_galerkin(n: int, step: Tuple[float, float],
                             viscosity: float, drag: float, dt: float):
    """Galerkin ``(R, m)`` block: the block is the filter support, filt ≡ 1."""
    rows, m = dft2d.galerkin_block(n)
    return _mode_constants(n, step, viscosity, drag, dt, rows, m,
                           np.ones((len(rows), m)))


def _cplx(re, im):
    return (re.astype(np.float64) + 1j * im.astype(np.float64)).astype(np.complex64)


@functools.lru_cache(maxsize=16)
def _constants(layout: str, n: int, step, viscosity, drag, dt, device: str):
    """Everything the three kernels read, as tensors on ``device``."""
    if layout == "galerkin":
        rows, m = dft2d.galerkin_block(n)
        hc = _host_constants_galerkin(n, step, viscosity, drag, dt)
        Rm = dft2d._mats_rows(n, rows, "float32")
        M = dft2d._mats(n, m, "float32")
        G, F = _cplx(Rm["inv_re"], Rm["inv_im"]), _cplx(Rm["fwd_re"], Rm["fwd_im"])
    else:
        m = n // 2
        hc = _host_constants(n, step, viscosity, drag, dt)
        M = dft2d._mats(n, m, "float32")
        G = _cplx(M["inv_first_re"], M["inv_first_im"])
        F = _cplx(M["fwd_first_re"], M["fwd_first_im"])
    tkx, tky, ilap = hc["tkx"], hc["tky"], hc["ilap"]
    # u = i(-tky·ilap)ŵ, v = i(tkx·ilap)ŵ, ∂ω/∂x = i·tkx·ŵ, ∂ω/∂y = i·tky·ŵ
    cf = np.stack([-tky * ilap, tkx * ilap, tkx, tky])
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    # the FFTs' twiddles, where the kernels take n; K1 reads the multipliers
    # ``cf`` as they are
    return {
        "n": n, "R": G.shape[1], "m": m,
        "G": t(G), "F": t(F), "cf": t(cf),
        "tw": t(_twiddles(n)) if advect_takes(n) else None,
        "il_re": t(M["inv_last_re"]), "il_im": t(M["inv_last_im"]),
        "fl": t(_cplx(M["fwd_last_re"], M["fwd_last_im"])),
        "filt": t(hc["filt"]), "lin": t(hc["lin"]), "dens": t(hc["dens"]),
        "mus": hc["mus"], "dt_gammas": tuple(g * dt for g in _GAMMAS),
    }


# ---------------------------------------------------------------- plain ----

def _inverse_first_plain(w: Tensor, c: dict) -> Tensor:
    """(b, R, m) spectrum -> (b, 4, n, m) first-axis inverse DFTs of u, v, ∇ω."""
    return torch.matmul(c["G"], w.unsqueeze(1) * (1j * c["cf"]))


def _advect_plain(A: Tensor, c: dict) -> Tensor:
    """(b, 4, n, m) -> (b, n, m) last-axis DFT of -(u ∂ω/∂x + v ∂ω/∂y)."""
    phys = torch.matmul(A.real, c["il_re"]) + torch.matmul(A.imag, c["il_im"])
    vx, vy, gx, gy = phys.unbind(1)
    adv = -(gx * vx + gy * vy)
    return torch.complex(torch.matmul(adv, c["fl"].real),
                         torch.matmul(adv, c["fl"].imag))


def _forward_first_plain(T: Tensor, w: Tensor, h: Tensor, c: dict, k: int):
    """First-axis forward DFT, filter, forcing and stage ``k``'s CN update."""
    e = torch.matmul(c["F"], T) * c["filt"] + c["forcing"]
    h = e if k == 0 else e + _BETAS[k] * h
    w = (w + c["dt_gammas"][k] * h + c["mus"][k] * (c["lin"] * w)) * c["dens"][k]
    return w, h


# --------------------------------------------------------------- kernels ----

@functools.lru_cache(maxsize=None)
def _lib():
    from tpu_cfd_torch.ops.cuda import _build

    lib = _build.load("spectral_step")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.spectral_inverse_first.argtypes = [P] * 4 + [I] * 7 + [P]
    lib.spectral_advect.argtypes = [P] * 3 + [I] * 5 + [P]
    lib.spectral_forward_first.argtypes = [P] * 8 + [I] * 7 + [F] * 3 + [P]
    for fn in (lib.spectral_inverse_first, lib.spectral_advect,
               lib.spectral_forward_first):
        fn.restype = I
    return lib


def _check(t: Tensor, shape, device, name: str) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.complex64:
        raise ValueError(f"{name} must be complex64, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(device) -> int:
    """The current stream of ``device``. A launch (``<<<>>>``) goes to the
    host thread's current device, so each launch below runs under
    ``torch.cuda.device`` of its tensors."""
    return torch.cuda.current_stream(device).cuda_stream


def _ok(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed with cudaError {err}")


def _out(out, shape, like: Tensor) -> Tensor:
    if out is not None and tuple(out.shape) == shape and out.device == like.device:
        return out
    return torch.empty(shape, dtype=torch.complex64, device=like.device)


# each kernel's ctypes arguments, for outputs and a stream already chosen

def _k1_args(w: Tensor, c: dict, A: Tensor, stream: int) -> tuple:
    b, n, R, m = w.shape[0], c["n"], c["R"], c["m"]
    tc, fb, threads = inverse_layout(n, R)
    return (w.data_ptr(), c["cf"].data_ptr(), c["tw"].data_ptr(), A.data_ptr(), b, R, m,
            n.bit_length() - 1, tc, fb, threads, stream)


def _k2_args(A: Tensor, c: dict, T: Tensor, stream: int) -> tuple:
    b, n, m = A.shape[0], c["n"], c["m"]
    _, threads, nbytes = advect_layout(n)
    return (A.data_ptr(), c["tw"].data_ptr(), T.data_ptr(), b, n.bit_length() - 1, m,
            threads, nbytes, stream)


def _k3_args(T: Tensor, w: Tensor, h: Tensor, c: dict, k: int, stream: int) -> tuple:
    b, n, R, m = w.shape[0], c["n"], c["R"], c["m"]
    tc, threads = forward_layout(n, R)
    return (T.data_ptr(), c["tw"].data_ptr(), c["filt"].data_ptr(),
            c["forcing"].data_ptr(), c["lin"].data_ptr(), c["dens"][k].data_ptr(),
            h.data_ptr(), w.data_ptr(), b, R, m, n.bit_length() - 1, tc, threads,
            int(k == 0), _BETAS[k], c["dt_gammas"][k], c["mus"][k], stream)


def _launch_inverse_first(w: Tensor, c: dict, out=None) -> Tensor:
    b, n, R, m = w.shape[0], c["n"], c["R"], c["m"]
    _check(w, (b, R, m), c["G"].device, "state")
    A = _out(out, (b, 4, n, m), w)
    lib = _lib()  # built at first use, before the device is made current
    with torch.cuda.device(w.device):
        _ok(lib.spectral_inverse_first(*_k1_args(w, c, A, _stream(w.device))),
            "spectral_inverse_first")
    LAUNCHES["inverse_first"] += 1
    return A


def _launch_advect(A: Tensor, c: dict, out=None) -> Tensor:
    b, n, m = A.shape[0], c["n"], c["m"]
    _check(A, (b, 4, n, m), c["G"].device, "first-axis output")
    T = _out(out, (b, n, m), A)
    lib = _lib()  # built at first use, before the device is made current
    with torch.cuda.device(A.device):
        _ok(lib.spectral_advect(*_k2_args(A, c, T, _stream(A.device))), "spectral_advect")
    LAUNCHES["advect"] += 1
    return T


def _check_stage(T: Tensor, w: Tensor, h: Tensor, c: dict) -> None:
    b, n, R, m = w.shape[0], c["n"], c["R"], c["m"]
    dev = c["G"].device
    _check(T, (b, n, m), dev, "advection spectrum")
    _check(w, (b, R, m), dev, "state")
    _check(h, (b, R, m), dev, "stage memory")
    _check(c["forcing"], (R, m), dev, "forcing")


def _launch_forward_first(T: Tensor, w: Tensor, h: Tensor, c: dict, k: int):
    _check_stage(T, w, h, c)
    lib = _lib()  # built at first use, before the device is made current
    with torch.cuda.device(w.device):
        _ok(lib.spectral_forward_first(*_k3_args(T, w, h, c, k, _stream(w.device))),
            "spectral_forward_first")
    LAUNCHES["forward_first"] += 1
    return w, h


def inverse_first(w: Tensor, c: dict, out=None) -> Tensor:
    """Kernel K1 on CUDA tensors, its plain version on CPU tensors."""
    if on_card(w, "spectral-step"):
        return _launch_inverse_first(w, c, out)
    return _inverse_first_plain(w, c)


def advect(A: Tensor, c: dict, block_cols: int, out=None) -> Tensor:
    """Kernel K2 on CUDA tensors, its plain version on CPU tensors; both
    take whole rows, whatever ``block_cols`` (the JAX signature's)."""
    if on_card(A, "spectral-step"):
        return _launch_advect(A, c, out)
    return _advect_plain(A, c)


def forward_first(T: Tensor, w: Tensor, h: Tensor, c: dict, k: int):
    """Kernel K3 on CUDA tensors (in place on w, h), plain on CPU tensors."""
    run = _launch_forward_first if on_card(T, "spectral-step") else _forward_first_plain
    return run(T, w, h, c, k)


# --------------------------------------------------------------- rollout ----

def _rollout_cuda(w: Tensor, c: dict, steps: int) -> Tensor:
    """The rollout on the card. The state, the stage memory, A, T and the
    stream stay the same through it, so each launch's arguments are built
    once and the loop only launches and counts: at 256², b=32 a step's 15
    launches take the card about 0.46 ms, and on the host of an NVIDIA H100
    machine a launch through its wrapper (checks, lookups, the device and
    stream) took ~22 µs, one here under 6."""
    b, n, R, m = w.shape[0], c["n"], c["R"], c["m"]
    w = w.clone(memory_format=torch.contiguous_format)
    h = torch.zeros_like(w)
    A = torch.empty((b, 4, n, m), dtype=torch.complex64, device=w.device)
    T = torch.empty((b, n, m), dtype=torch.complex64, device=w.device)
    _check_stage(T, w, h, c)
    lib = _lib()  # built at first use, before the device is made current
    with torch.cuda.device(w.device):
        s = _stream(w.device)
        k1 = ("inverse_first", lib.spectral_inverse_first, _k1_args(w, c, A, s))
        k2 = ("advect", lib.spectral_advect, _k2_args(A, c, T, s))
        stages = [(k1, k2, ("forward_first", lib.spectral_forward_first,
                            _k3_args(T, w, h, c, k, s))) for k in range(5)]
        for _ in range(steps):
            for stage in stages:
                for key, fn, args in stage:
                    err = fn(*args)
                    if err:
                        _ok(err, fn.__name__)
                    LAUNCHES[key] += 1
    return w


def _fused_rollout_plain(w: Tensor, c: dict, steps: int) -> Tensor:
    """The whole rollout in plain PyTorch, on any device."""
    w = w.clone(memory_format=torch.contiguous_format)
    h = torch.zeros_like(w)
    for _ in range(steps):
        for k in range(5):
            T = _advect_plain(_inverse_first_plain(w, c), c)
            w, h = _forward_first_plain(T, w, h, c, k)
    return w


class _ForwardOnly(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, run):
        return run(w)

    @staticmethod
    def backward(ctx, grad):
        raise RuntimeError(
            "the fused spectral rollout is forward-only (no VJP); "
            "differentiate through the unfused solver (fused=False)"
        )


def advect_takes(n: int) -> bool:
    """Whether K2 takes an n² grid: n a power of two from 16 to 2048."""
    return _K2_MIN_N <= n <= _K2_MAX_N and n & (n - 1) == 0


def _fft_passes(n: int):
    """K2's radices for n points: 16 each pass, the last 2, 4, 8 or 16."""
    log2n = n.bit_length() - 1
    passes = (log2n + 3) // 4
    return (16,) * (passes - 1) + (1 << (log2n - 4 * (passes - 1)),)


def _twiddles(n: int) -> np.ndarray:
    """K2's twiddle table: for each pass p >= 1 (radix R, NS = 16^p points
    already combined), exp(-2πi k r / (NS R)) at [r - 1][k], r < R, k < NS,
    in float64 rounded to complex64; one unused entry where n = 16."""
    parts = []
    for p, R in enumerate(_fft_passes(n)):
        if p:
            ns = 16 ** p
            r, k = np.arange(1, R)[:, None], np.arange(ns)[None, :]
            parts.append(np.exp(-2j * np.pi * r * k / (ns * R)).ravel())
    return (np.concatenate(parts) if parts else np.ones(1)).astype(np.complex64)


def _k2_row_floats(n: int) -> int:
    """float2 a physical row takes in K2's shared memory (its ``Fft::RS``):
    two rows of n points, one float2 of padding every 16, and below 256 points
    n/16 modulo 16, so that the rows sharing a half-warp meet no bank twice."""
    g, np_ = n // 16, n + n // 16
    return 2 * np_ if g >= 16 else 2 * np_ + (g - 2 * np_) % 16


@functools.lru_cache(maxsize=None)
def inverse_layout(n: int, R: int):
    """K1's blocks for an ``(R, m)`` spectrum on an n² grid, as ``(columns a
    block, fields a block, threads)``; raises ``ValueError`` for an n it does
    not take (``advect_takes``). The kernel sizes its shared memory from
    these (``k1_smem`` in ``csrc/spectral_step.cu``).

    n/16 threads hold a column's transform. A block takes 8 consecutive
    columns (4 from 1024²) of one sample, with all four fields up to 128²
    and one field from 256² up. Of 1 to 32 columns and 1 or 4 fields, by
    device time on an NVIDIA H100 80GB HBM3 (700 W) at n from 16 to 2048 and
    batches 1 to 128, that is the fastest at 256², b=32 and b=128, within
    6 % of it from 256² up on the Galerkin block and within 12 % elsewhere
    (the aligned layout at 256², which no default route takes, runs up to
    11 % faster with four fields). At 256², b=32 its 1,408 blocks of 128
    threads run in 1.33 waves of 1,056 (8 an SM at 60 registers a thread);
    no layout does better, as the 176,128 threads that hold the batch's
    transforms are 1.30 times what the SMs hold at once.
    """
    if not advect_takes(n):
        raise ValueError(
            f"the first-axis kernel takes n a power of two from {_K2_MIN_N} to "
            f"{_K2_MAX_N}, got n={n}; use fft_impl='fft' or another unfused route")
    tc, fb = (8 if n <= 512 else 4), (4 if n <= 128 else 1)
    return tc, fb, tc * fb * (n // 16)


@functools.lru_cache(maxsize=None)
def forward_layout(n: int, R: int):
    """K3's blocks for an ``(R, m)`` spectrum on an n² grid, as ``(columns a
    block, threads)``; raises ``ValueError`` for an n it does not take
    (``advect_takes``). The kernel sizes its shared memory from these
    (``k3_smem`` in ``csrc/spectral_step.cu``).

    n/16 threads hold a column's transform, and a block takes ``tc``
    consecutive columns of one sample: 16 up to 256² (32 at 16², a whole
    warp), 8 at 512² and 1024², 3 at 2048². Of 1 to 64 columns that make
    whole warps within 512 threads and the shared memory, by CUDA events
    over launches queued behind a device sleep on an NVIDIA H100 80GB HBM3
    (700 W) at n from 16 to 2048, batches 1 to 128 and both layouts, that
    is the fastest or within 11 % of it from b=8 up, and within 17 % at
    b = 1 and 4 but for 1024², b=1 (24 %). Wide tiles win at large
    batches, narrow ones at small: at 256², b=32 the Galerkin block took
    0.0101 ms a launch with 16 columns, 0.0096 with 24 (128 blocks, one an
    SM) and 0.0110 with 8; 16 columns divide the aligned layout's 128,
    where 24 ran 45 % slower.
    """
    if not advect_takes(n):
        raise ValueError(
            f"the first-axis kernel takes n a power of two from {_K2_MIN_N} to "
            f"{_K2_MAX_N}, got n={n}; use fft_impl='fft' or another unfused route")
    g = n // 16
    tc = 3 if n == 2048 else 8 if n >= 512 else max(16, 32 // g)
    return tc, tc * g


@functools.lru_cache(maxsize=None)
def advect_layout(n: int):
    """K2's blocks for an n² grid, as ``(rows a block, threads, bytes of
    shared memory)``; raises ``ValueError`` for an n it does not take
    (``advect_takes``).

    n/16 threads hold a row, and a block holds the fewest rows that pair up
    and make a whole warp: two rows from 256 points up, 32 threads below. A
    row takes ``_k2_row_floats(n)`` float2 of shared memory. The kernel's
    launch bounds hold 16 warps an SM whatever the block, so the smallest
    blocks fill the 132 SMs at least as evenly as larger ones at every batch
    (256², b=32: 4,096 blocks of one warp in two waves of 2,112, 97 %); on
    an H100 at 256² and b = 8, 32 and 128 blocks of 32 threads also ran
    8–34 % faster than blocks of 256 on the Galerkin block, 1–9 % on the
    aligned layout.
    """
    if not advect_takes(n):
        raise ValueError(
            f"the advection kernel takes n a power of two from {_K2_MIN_N} to "
            f"{_K2_MAX_N}, got n={n}; use fft_impl='fft' or another unfused route")
    threads = max(32, n // 8)
    tx = threads // (n // 16)
    return tx, threads, tx * _k2_row_floats(n) * 8


def resolve_block_cols(block_cols, n: int, m: int) -> int:
    """The JAX signature's physical-column chunk width, validated.

    ``"auto"`` takes the largest of 64, 32, ... dividing n; ``None`` takes
    whole rows (n); an int must divide n. The card's K2 takes whole rows
    whatever the value, as the plain version does.
    """
    if block_cols == "auto":
        block_cols = next(c for c in (64, 32, 16, 8, 4, 2, 1) if n % c == 0)
    elif block_cols is None:
        block_cols = n
    if n % block_cols:
        raise ValueError(f"block_cols={block_cols} must divide n={n}")
    return block_cols


def constants(layout: str, grid, viscosity, drag, dt, device,
              forcing_hat: Optional[Tensor] = None) -> dict:
    """Kernel inputs for ``layout`` ("galerkin" or "aligned") on ``device``."""
    c = dict(_constants(layout, grid.shape[-1],
                        tuple(float(s) for s in grid.step), float(viscosity),
                        float(drag), float(dt), str(device)))
    if forcing_hat is None:
        c["forcing"] = torch.zeros((c["R"], c["m"]), dtype=torch.complex64,
                                   device=device)
    else:
        c["forcing"] = forcing_hat.to(device=device, dtype=torch.complex64
                                      ).contiguous()
    return c


def _fused_rollout(w_hat: Tensor, *, layout: str, grid, viscosity, drag, dt,
                   steps: int, forcing_hat, precision: str, block_cols
                   ) -> Tensor:
    """Layout-agnostic core: state ``(..., rows, m)``, physical grid ``n²``."""
    if w_hat.dtype != torch.complex64:
        raise ValueError("fused rollout is fp32-only (complex64 state)")
    if precision not in dft2d.PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    c = constants(layout, grid, viscosity, drag, dt, w_hat.device, forcing_hat)
    if tuple(w_hat.shape[-2:]) != (c["R"], c["m"]):
        raise ValueError(
            f"expected {layout} spectrum (..., {c['R']}, {c['m']}), "
            f"got {tuple(w_hat.shape)}"
        )
    resolve_block_cols(block_cols, c["n"], c["m"])  # raises on a bad value
    lead = w_hat.shape[:-2]
    w = w_hat.reshape((math.prod(lead), c["R"], c["m"]))
    if w.device.type == "cpu":
        run = lambda x: _fused_rollout_plain(x, c, steps)  # noqa: E731
    elif w.device.type == "cuda":
        advect_layout(c["n"])  # raises where the kernels do not take n
        run = lambda x: _rollout_cuda(x, c, steps)  # noqa: E731
    else:
        raise ValueError(f"no fused rollout for device {w.device}")
    out = _ForwardOnly.apply(w, run) if w.requires_grad else run(w)
    return out.reshape(w_hat.shape)


def fused_rollout_galerkin(
    w_block: Tensor, *, grid, viscosity: float, drag: float, dt: float,
    steps: int, forcing_hat: Optional[Tensor] = None,
    precision: str = "high", block_cols="auto",
) -> Tensor:
    """March a Galerkin-block ``(..., R, m)`` complex64 spectrum ``steps`` steps.

    Same update rule as ``NavierStokes2DSpectral(fft_impl="dft_galerkin")``
    up to summation order. Forward-only.
    """
    return _fused_rollout(
        w_block, layout="galerkin", grid=grid, viscosity=viscosity, drag=drag,
        dt=dt, steps=steps, forcing_hat=forcing_hat, precision=precision,
        block_cols=block_cols)


def fused_rollout_aligned(
    w_hat: Tensor, *, grid, viscosity: float, drag: float, dt: float,
    steps: int, forcing_hat: Optional[Tensor] = None,
    precision: str = "high", block_cols="auto",
) -> Tensor:
    """March an aligned ``(..., n, n//2)`` complex64 spectrum ``steps`` steps.

    Same update rule as ``NavierStokes2DSpectral(fft_impl="dft_aligned")``
    up to summation order. Forward-only.
    """
    return _fused_rollout(
        w_hat, layout="aligned", grid=grid, viscosity=viscosity, drag=drag,
        dt=dt, steps=steps, forcing_hat=forcing_hat, precision=precision,
        block_cols=block_cols)


def flops_per_sample_step(layout: str, n: int) -> int:
    """Flops of one sample-step as the JAX kernel counts them: 5 stages of 4
    inverse + 1 forward 2-D DFT, each axis a dense product. None of the
    card's kernels does that work: all their transforms are FFTs (the
    ``.cu`` header counts them), so this over-counts the card's work."""
    if layout == "galerkin":
        rows, m = dft2d.galerkin_block(n)
        R = len(rows)
    else:
        R, m = n, n // 2
    return 5 * (40 * n * R * m + 20 * n * n * m)

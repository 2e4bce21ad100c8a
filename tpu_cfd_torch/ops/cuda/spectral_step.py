"""Fused low-storage RK4-CN pseudo-spectral stepper: CUDA kernels and wrappers.

Replaces the TPU kernel ``tpu_cfd/ops/pallas/spectral_step.py::_make_kernel``
(its ``pallas_call`` in ``_fused_rollout``), in both of its layouts:
``fused_rollout_galerkin`` marches a ``(..., R, m)`` spectrum on the 2/3-rule
Galerkin block, ``fused_rollout_aligned`` an ``(..., n, n//2)`` spectrum with
a brick-wall mask per stage. Both compute ``steps`` Carpenter-Kennedy steps
of five stages; each stage is three hand-written kernels in
``csrc/spectral_step.cu`` (see its header for the design and the bound):

- ``inverse_first``: multipliers fused into the first-axis inverse DFT;
- ``advect``: inverse last axis, advection product, forward last axis, per
  tile of physical rows, over chunks of ``block_cols`` physical columns;
- ``forward_first``: forward first axis with the Crank-Nicolson update.

Every kernel has a wrapper that dispatches on the device of the tensor it
is given: a CPU tensor goes to the plain PyTorch version of the same
arithmetic (``_inverse_first_plain`` ...), a CUDA tensor launches the
kernel or raises. Each wrapper counts its launches in ``LAUNCHES``.
``_fused_rollout_plain`` is the whole rollout in plain PyTorch.

On the card every precision mode computes in fp32 FFMA, at least the
accuracy ``"highest"`` asks for: each kernel is a register-tiled product on
the CUDA cores, its operands staged in shared memory by cp.async (the
``.cu`` header gives the tiles). ``constants`` lays the operands out for
them (``GT``, ``FT``, ``cf4``, ``il``) beside the plain versions' matrices;
``advect_layout`` picks K2's rows a block and shared-memory layout from the
shape. The rollout is forward-only: taking a gradient through it raises, as
in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from tpu_cfd_torch.ops import dft2d

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

# K2's template instances (csrc/spectral_step.cu advect_kernel): physical
# rows a block and the most passes of 4 x column-groups floats over the 2m
# columns of T that a thread holds; its 256 threads, the depth of an IL
# tile, the slots of its cp.async ring and their floats; the shared memory
# a block may use on an H100 (232,448 bytes).
_K2_INSTANCES = ((32, 4), (16, 8), (8, 12))
_K2_THREADS, _K2_KC, _K2_STAGES, _K2_SLOT = 256, 16, 3, 1024
_MAX_SMEM = 232448


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
    # the kernels' operand layouts: G and F transposed, the four fields'
    # multipliers of a mode side by side, IL's rows il_re and il_im interleaved
    il = np.stack([M["inv_last_re"], M["inv_last_im"]], axis=1).reshape(2 * m, n)
    return {
        "n": n, "R": G.shape[1], "m": m,
        "G": t(G), "F": t(F), "cf": t(cf),
        "GT": t(G.T), "FT": t(F.T), "cf4": t(np.moveaxis(cf, 0, -1)), "il": t(il),
        "il_re": t(M["inv_last_re"]), "il_im": t(M["inv_last_im"]),
        "fl": t(_cplx(M["fwd_last_re"], M["fwd_last_im"])),
        "filt": t(hc["filt"]), "lin": t(hc["lin"]), "dens": t(hc["dens"]),
        "mus": hc["mus"], "dt_gammas": tuple(g * dt for g in _GAMMAS),
    }


# ---------------------------------------------------------------- plain ----

def _inverse_first_plain(w: Tensor, c: dict, out=None) -> Tensor:
    """(b, R, m) spectrum -> (b, 4, n, m) first-axis inverse DFTs of u, v, ∇ω."""
    return torch.matmul(c["G"], w.unsqueeze(1) * (1j * c["cf"]))


def _advect_plain(A: Tensor, c: dict, block_cols=None, out=None) -> Tensor:
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
    lib.spectral_inverse_first.argtypes = [P, P, P, P, I, I, I, I, P]
    lib.spectral_advect.argtypes = [P] * 4 + [I] * 7 + [P]
    lib.spectral_forward_first.argtypes = (
        [P] * 8 + [I, I, I, I, I, F, F, F, P])
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
    return torch.cuda.current_stream(device).cuda_stream


def _ok(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed with cudaError {err}")


def _out(out, shape, like: Tensor) -> Tensor:
    if out is not None and tuple(out.shape) == shape and out.device == like.device:
        return out
    return torch.empty(shape, dtype=torch.complex64, device=like.device)


def _launch_inverse_first(w: Tensor, c: dict, out=None) -> Tensor:
    b, n, R, m = w.shape[0], c["n"], c["R"], c["m"]
    _check(w, (b, R, m), c["G"].device, "state")
    A = _out(out, (b, 4, n, m), w)
    _ok(_lib().spectral_inverse_first(
        w.data_ptr(), c["GT"].data_ptr(), c["cf4"].data_ptr(), A.data_ptr(),
        b, R, m, n, _stream(w.device)), "spectral_inverse_first")
    LAUNCHES["inverse_first"] += 1
    return A


def _launch_advect(A: Tensor, c: dict, block_cols: int, out=None) -> Tensor:
    b, n, m = A.shape[0], c["n"], c["m"]
    _check(A, (b, 4, n, m), c["G"].device, "first-axis output")
    layout = advect_layout(n, m, block_cols)
    if layout is None:
        raise ValueError(_smem_message(n, m, block_cols))
    T = _out(out, (b, n, m), A)
    _ok(_lib().spectral_advect(
        A.data_ptr(), c["il"].data_ptr(), c["fl"].data_ptr(), T.data_ptr(), b, n,
        m, block_cols, *layout, _stream(A.device)), "spectral_advect")
    LAUNCHES["advect"] += 1
    return T


def _launch_forward_first(T: Tensor, w: Tensor, h: Tensor, c: dict, k: int):
    b, n, R, m = w.shape[0], c["n"], c["R"], c["m"]
    dev = c["G"].device
    _check(T, (b, n, m), dev, "advection spectrum")
    _check(w, (b, R, m), dev, "state")
    _check(h, (b, R, m), dev, "stage memory")
    _check(c["forcing"], (R, m), dev, "forcing")
    _ok(_lib().spectral_forward_first(
        T.data_ptr(), c["FT"].data_ptr(), c["filt"].data_ptr(),
        c["forcing"].data_ptr(), c["lin"].data_ptr(), c["dens"][k].data_ptr(),
        h.data_ptr(), w.data_ptr(), b, R, m, n, int(k == 0), _BETAS[k],
        c["dt_gammas"][k], c["mus"][k], _stream(w.device)),
        "spectral_forward_first")
    LAUNCHES["forward_first"] += 1
    return w, h


def _dispatch(t: Tensor, plain, kernel):
    if t.device.type == "cpu":
        return plain
    if t.device.type == "cuda":
        return kernel
    raise ValueError(f"no spectral-step kernel for device {t.device}")


def inverse_first(w: Tensor, c: dict, out=None) -> Tensor:
    """Kernel K1 on CUDA tensors, its plain version on CPU tensors."""
    return _dispatch(w, _inverse_first_plain, _launch_inverse_first)(w, c, out)


def advect(A: Tensor, c: dict, block_cols: int, out=None) -> Tensor:
    """Kernel K2 on CUDA tensors, its plain version on CPU tensors."""
    return _dispatch(A, _advect_plain, _launch_advect)(A, c, block_cols, out)


def forward_first(T: Tensor, w: Tensor, h: Tensor, c: dict, k: int):
    """Kernel K3 on CUDA tensors (in place on w, h), plain on CPU tensors."""
    return _dispatch(T, _forward_first_plain, _launch_forward_first)(T, w, h, c, k)


# --------------------------------------------------------------- rollout ----

def _rollout(w: Tensor, c: dict, steps: int, block_cols: int, phases) -> Tensor:
    inv, adv, fwd = phases
    w = w.clone(memory_format=torch.contiguous_format)
    h = torch.zeros_like(w)
    A = T = None
    for _ in range(steps):
        for k in range(5):
            A = inv(w, c, A)
            T = adv(A, c, block_cols, T)
            w, h = fwd(T, w, h, c, k)
    return w


def _fused_rollout_plain(w: Tensor, c: dict, steps: int,
                         block_cols: Optional[int] = None) -> Tensor:
    """The whole rollout in plain PyTorch, on any device."""
    return _rollout(w, c, steps, block_cols,
                    (_inverse_first_plain, _advect_plain, _forward_first_plain))


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


@functools.lru_cache(maxsize=None)
def advect_layout(n: int, m: int, jc: int):
    """K2's instance and shared-memory size for this shape and column chunk,
    as ``(rows a block, passes, bytes)``, or ``None`` where no instance fits
    in one block's shared memory.

    A block keeps its rows of the four fields (``4 x rows x 2m`` floats, 2m
    padded to 16, row stride ``4 rows + 4``), a ring of 3 slots and the
    advection term of one chunk and ``fr`` zero rows (``(jc + fr) x (rows +
    1)``). A slot holds a 16 x 64 tile of IL or ``fr`` rows of FL padded to
    the passes' columns, ``fr`` the largest power of two up to 16 that keeps
    an FL tile within the slot's 1024 floats (or one row). The most rows a
    block whose thread's passes over T fit its instance and whose layout
    fits are taken; at 256² Galerkin two blocks share an SM.
    """
    m2 = 2 * m
    k1p = -(-m2 // _K2_KC) * _K2_KC
    for tx, npmax in _K2_INSTANCES:
        cols = 4 * (_K2_THREADS // min(tx, 16))  # columns of T a pass covers
        passes = -(-m2 // cols)
        if passes > npmax:
            continue
        w2 = passes * cols
        fr = 1
        while fr < 16 and 2 * fr * w2 <= _K2_SLOT:
            fr *= 2
        slot = max(_K2_SLOT, fr * w2)
        nbytes = 4 * (k1p * (4 * tx + 4) + _K2_STAGES * slot + (jc + fr) * (tx + 1))
        if nbytes <= _MAX_SMEM:
            return tx, passes, nbytes
    return None


def _smem_message(n: int, m: int, jc: int) -> str:
    return (f"spectrum width m={m} with block_cols={jc} at n={n} needs more than "
            f"{_MAX_SMEM} bytes of shared memory per block of the advection "
            "kernel, even at 8 rows a block")


def resolve_block_cols(block_cols, n: int, m: int) -> int:
    """Physical-column chunk width of K2 (``advect``).

    ``"auto"`` takes the largest of 64, 32, ... dividing n; ``None`` takes
    whole rows (n, the resident layout); an int must divide n. Raises where
    K2 has no layout for the shape (``advect_layout``).
    """
    if block_cols == "auto":
        block_cols = next(c for c in (64, 32, 16, 8, 4, 2, 1) if n % c == 0)
    elif block_cols is None:
        block_cols = n
    if n % block_cols:
        raise ValueError(f"block_cols={block_cols} must divide n={n}")
    if advect_layout(n, m, block_cols) is None:
        raise ValueError(_smem_message(n, m, block_cols))
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
    jc = resolve_block_cols(block_cols, c["n"], c["m"])
    lead = w_hat.shape[:-2]
    w = w_hat.reshape((math.prod(lead), c["R"], c["m"]))
    if w.device.type == "cpu":
        run = lambda x: _fused_rollout_plain(x, c, steps, jc)  # noqa: E731
    elif w.device.type == "cuda":
        run = lambda x: _rollout(  # noqa: E731
            x, c, steps, jc, (inverse_first, advect, forward_first))
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
    """Flops of one sample-step: 5 stages of 4 inverse + 1 forward 2-D DFT."""
    if layout == "galerkin":
        rows, m = dft2d.galerkin_block(n)
        R = len(rows)
    else:
        R, m = n, n // 2
    return 5 * (40 * n * R * m + 20 * n * n * m)

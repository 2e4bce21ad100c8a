"""Pseudo-spectral Navier-Stokes equations and IMEX time steppers (PyTorch).

Counterpart of ``tpu_cfd/solvers/equations.py``. The solver is a dataclass
whose spectral constants (frequency meshes, Laplacian symbol, 2/3-rule mask,
linear term) are tensors built once on an explicit ``device``. State is the
rfft2 half-spectrum of vorticity ``(..., n, n//2+1)``; leading dims are
batch. ``forward(..., steps=k)`` is a Python loop over the stepper, or, with
``fused=True``, one call of the hand-written CUDA rollout
(``ops/cuda/spectral_step.py``); a spectrum sharded on its rows over ranks
steps by pencil FFTs (``parallel/pencil.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from tpu_cfd_torch import grids
from tpu_cfd_torch.device import resolve_device
from tpu_cfd_torch.ops import dft2d
from tpu_cfd_torch.ops.cuda import imex_spectral
from tpu_cfd_torch.ops.spectral import (
    brick_wall_filter_2d,
    brick_wall_mask_2d,
    spectral_curl_2d,
    spectral_laplacian_2d,
    spectral_rot_2d,
)
from tpu_cfd_torch.utils.profiling import trace_annotation

Tensor = torch.Tensor
Grid = grids.Grid


def stable_time_step(
    dx: Optional[float] = None,
    dt: Optional[float] = None,
    max_velocity: float = 1.0,
    max_courant_number: float = 0.5,
    viscosity: float = 1e-3,
    implicit_diffusion: bool = True,
    ndim: int = 2,
) -> float:
    """CFL + (explicit) diffusion bound on the time step."""
    dt_diffusion = dx
    if not implicit_diffusion:
        dt_diffusion = dx**2 / (viscosity * 2 ** (ndim))
    dt_advection = max_courant_number * dx / max_velocity
    dt = dt_advection if dt is None else dt
    return min(dt_diffusion, dt_advection, dt)


class ImplicitExplicitODE:
    """∂u/∂t = explicit_terms(u) + implicit_terms(u).

    ``implicit_solve(f, eta)`` solves u - eta*implicit_terms(u) = f.
    """

    def explicit_terms(self, u: Tensor) -> Tensor:
        raise NotImplementedError

    def implicit_terms(self, u: Tensor) -> Tensor:
        raise NotImplementedError

    def implicit_solve(self, f: Tensor, step_size: float) -> Tensor:
        raise NotImplementedError

    def residual(self, u: Tensor, u_t: Tensor) -> Tensor:
        """PDE residual u_t - N(u) - L(u)."""
        return u_t - self.explicit_terms(u) - self.implicit_terms(u)

    def _kernel_takes(self, u: Tensor) -> bool:
        """Whether the IMEX-spectral kernels (``ops/cuda/imex_spectral.py``)
        step ``u``: an equation that has none says no."""
        return False


@dataclasses.dataclass
class IMEXStepper:
    """IMEX time stepping with configurable order.

    order=1: forward-backward Euler (alpha=1); order=1.5: Crank-Nicolson
    IMEX (alpha=0.5); order=2: RK2 Crank-Nicolson (Chandler & Kerswell 2013).
    Spans (``utils.trace_annotation``): ``solver.explicit`` around each
    evaluation of the explicit terms, ``solver.implicit`` around each
    implicit solve. Order 2 forms each stage in one ``rk2_cn_stage`` launch
    (``ops/cuda/imex_spectral.py``) where the equation's ``_kernel_takes``
    holds, inside the ``solver.implicit`` span; orders 1 and 1.5 keep their
    composed update.
    """

    order: float = 2
    alpha: float = 0.5
    beta: float = 0.5

    def __call__(self, u: Tensor, dt: float, equation: ImplicitExplicitODE) -> Tensor:
        if self.order in (1, 1.5):
            return self._imex(u, dt, equation)
        elif self.order == 2:
            return self._rk2_crank_nicolson(u, dt, equation)
        raise ValueError(f"unsupported IMEX order: {self.order}")

    def _imex(self, u: Tensor, dt: float, equation: ImplicitExplicitODE) -> Tensor:
        alpha = 1.0 if self.order == 1 else self.alpha
        F = equation.explicit_terms
        G = equation.implicit_terms
        with trace_annotation("solver.explicit"):
            f = F(u)
        g = u + dt * f + (1 - alpha) * dt * G(u)
        with trace_annotation("solver.implicit"):
            return equation.implicit_solve(g, alpha * dt)

    def _rk2_crank_nicolson(self, u: Tensor, dt: float,
                            equation: ImplicitExplicitODE) -> Tensor:
        alpha, beta = self.alpha, self.beta
        F = equation.explicit_terms
        if equation._kernel_takes(u):
            c = equation._kernel_constants()
            with trace_annotation("solver.explicit"):
                h = F(u)
            with trace_annotation("solver.implicit"):
                u1 = imex_spectral.rk2_cn_stage(u, h, None, c, dt, alpha, beta)
            with trace_annotation("solver.explicit"):
                f = F(u1)
            with trace_annotation("solver.implicit"):
                return imex_spectral.rk2_cn_stage(u, h, f, c, dt, alpha, beta)
        G = equation.implicit_terms
        G_inv = equation.implicit_solve
        g = u + beta * dt * G(u)
        with trace_annotation("solver.explicit"):
            h = F(u)
        with trace_annotation("solver.implicit"):
            u = G_inv(g + dt * h, beta * dt)
        with trace_annotation("solver.explicit"):
            f = F(u)
        h = alpha * f + (1 - alpha) * h
        with trace_annotation("solver.implicit"):
            return G_inv(g + dt * h, beta * dt)


# Carpenter-Kennedy low-storage coefficients
_CARPENTER_KENNEDY = dict(
    alphas=(0.0, 0.1496590219993, 0.3704009573644, 0.6222557631345,
            0.9582821306748, 1.0),
    betas=(0.0, -0.4178904745, -1.192151694643, -1.697784692471, -1.514183444257),
    gammas=(0.1496590219993, 0.3792103129999, 0.8229550293869, 0.6994504559488,
            0.1530572479681),
)

# classic 4-stage RK4
_CLASSIC_RK4 = dict(
    alphas=(0.0, 0.5, 0.5, 1.0, 1.0),
    betas=(0.0, 0.0, 0.0, 0.0),
    gammas=(1 / 6, 1 / 3, 1 / 3, 1 / 6),
)


@dataclasses.dataclass
class RK4CrankNicolsonStepper(IMEXStepper):
    """Low-storage RK4 (Carpenter-Kennedy) with Crank-Nicolson implicit part."""

    order: float = 4
    low_storage: bool = True

    def __call__(self, u: Tensor, dt: float, equation: ImplicitExplicitODE) -> Tensor:
        w = _CARPENTER_KENNEDY if self.low_storage else _CLASSIC_RK4
        alphas, betas, gammas = w["alphas"], w["betas"], w["gammas"]
        if len(alphas) - 1 != len(betas) or len(betas) != len(gammas):
            raise ValueError("number of RK coefficients does not match")
        F = equation.explicit_terms
        G = equation.implicit_terms
        G_inv = equation.implicit_solve
        h = 0
        for k in range(len(betas)):
            h = F(u) + betas[k] * h
            mu = 0.5 * dt * (alphas[k + 1] - alphas[k])
            u = G_inv(u + gammas[k] * dt * h + mu * G(u), mu)
        return u


def fused_refusal(solver: Optional[IMEXStepper], dtype: torch.dtype, smooth: bool,
                  fft_impl: Optional[str] = None) -> Optional[str]:
    """The first requirement of the fused RK4-CN kernel (``fused=True``) that
    a solver configuration breaks, as the message the solver raises, or
    ``None`` where the kernel can step it. ``solver=None`` is the default
    stepper (the low-storage RK4-CN); ``fft_impl`` is checked when given.
    The grid size is checked at launch (``spectral_step.advect_layout``):
    the plain version on the CPU steps any n."""
    if fft_impl is not None and fft_impl not in ("dft_aligned", "dft_galerkin"):
        return ("fused=True requires fft_impl='dft_aligned' or 'dft_galerkin' "
                "(the fused kernel bakes the truncated spectrum layout)")
    if not smooth:
        return "fused=True requires smooth=True"
    if dtype != torch.float32:
        return "fused=True is fp32-only"
    if solver is not None and not (
        isinstance(solver, RK4CrankNicolsonStepper)
        and solver.low_storage
        and solver.order == 4
    ):
        return ("fused=True implements the low-storage RK4-CN stepper only; "
                "pass solver=None")
    return None


def recommended_fft_impl(
    grid_size: int,
    batch_size: int = 8,
    double: bool = False,
    dealias: bool = True,
) -> str:
    """The solver transform the port uses by default on the card: the fused
    RK4-CN kernel on the Galerkin block (``dft_galerkin_fused``) wherever it
    can step the run (fp32, dealiased, an n its kernels take:
    ``spectral_step.advect_takes``), else ``torch.fft``.

    From ``python3 -m tpu_cfd_torch.ops.cuda.route_times --sweep solver`` on
    an NVIDIA H100 80GB HBM3 at 700 W, the mean of two sweeps in one call:
    at n 64–1024 and b 8–128 the Galerkin kernel was the fastest route or
    within 4 % of it (the aligned layout's kernel read 3.6 % faster at 128²,
    b=8, within the sweeps' drift), e.g. 0.4602 ms a step at 256², b=32
    against 2.5832 for ``torch.fft``; ``torch.fft`` was the fastest route
    without the kernel at every point (``dft_galerkin``, ``torch.matmul``,
    5.2425 ms there). ``batch_size`` is not consulted: the kernel won at
    every batch measured. The sweep lists the points where this answer is
    more than 5 % slower than the fastest; re-run it after a kernel change.
    With ``torch.fft``'s explicit terms on the IMEX-spectral kernels, one
    sweep (same card and limit) read 0.2474 ms a step at 256², b=32 against
    1.1725 for ``torch.fft`` and 4.2405 for ``dft_galerkin``: the same
    answer everywhere but 64², b=32, where the aligned layout's kernel read
    8 % faster (0.1065 against 0.1154 ms, a host-paced point that the
    Galerkin kernel wins at b=8 and b=128).
    """
    from tpu_cfd_torch.ops.cuda import spectral_step

    dtype = torch.float64 if double else torch.float32
    if fused_refusal(None, dtype, dealias) or not spectral_step.advect_takes(grid_size):
        return "fft"
    return "dft_galerkin_fused"


@dataclasses.dataclass
class NavierStokes2DSpectral(ImplicitExplicitODE):
    """2-D incompressible NSE in vorticity form, pseudo-spectral (rfft2).

    Explicit part: dealiased advection -(v·∇)ω (+ forcing); implicit part:
    viscous diffusion + drag, solved in closed form per mode.

    ``fft_impl``: "fft" (``torch.fft``), "dft" (dense DFT matrix products),
    "dft_aligned" (the same on ``n//2`` columns, Nyquist dropped) or
    "dft_galerkin" (on the 2/3-rule block only). The internal layout is
    converted once per ``forward``; public spectra stay ``(..., n, n//2+1)``.
    ``mxu_precision`` keeps the JAX package's name; on the card every mode
    computes in fp32. ``fused=True`` runs ``forward`` through the CUDA
    rollout (fp32, dealiased, low-storage RK4-CN, aligned or Galerkin:
    ``fused_refusal``).
    ``device=None`` means the card, and raises when there is none.
    """

    viscosity: float
    grid: Grid
    drag: float = 0.0
    smooth: bool = True
    forcing_fn: Optional[object] = None
    solver: Optional[IMEXStepper] = None
    dtype: torch.dtype = torch.float32
    fft_impl: str = "fft"
    mxu_precision: str = "highest"
    fused: bool = False
    fused_block_cols: object = "auto"
    device: object = None

    def _irfft2(self, x: Tensor) -> Tensor:
        if self.fft_impl == "dft_galerkin":
            return dft2d.irfft2_block(x, self.grid.shape[-1], self._rows,
                                      self.mxu_precision)
        if self.fft_impl in ("dft", "dft_aligned"):
            return dft2d.irfft2_matmul(x, self.mxu_precision)
        return torch.fft.irfft2(x, s=self.grid.shape)

    def _rfft2(self, x: Tensor) -> Tensor:
        if self.fft_impl == "dft_galerkin":
            return dft2d.rfft2_block(x, self._rows, self._m, self.mxu_precision)
        if self.fft_impl in ("dft", "dft_aligned"):
            return dft2d.rfft2_matmul(x, self.mxu_precision, m=self._m)
        return torch.fft.rfft2(x)

    def _align(self, w: Tensor) -> Tensor:
        """Public full-layout spectrum -> internal (truncated) layout."""
        if self._rows is not None and w.shape[-2] != len(self._rows):
            w = w.index_select(-2, self._row_index)
        return w[..., : self._m] if w.shape[-1] > self._m else w

    def _unalign(self, w: Tensor, shape_in: Tuple[int, int]) -> Tensor:
        """Internal layout -> the caller's spectral shape (zero-fill dropped)."""
        height, width = shape_in
        if w.shape[-2] != height:
            npos = len(self._rows) - len(self._rows) // 2
            gap = w.new_zeros((*w.shape[:-2], height - len(self._rows), w.shape[-1]))
            w = torch.cat([w[..., :npos, :], gap, w[..., npos:, :]], dim=-2)
        if w.shape[-1] == width:
            return w
        return torch.nn.functional.pad(w, (0, width - w.shape[-1]))

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._forcing_hat = None
        if self.solver is None:
            self.solver = RK4CrankNicolsonStepper()
        if self.fused:
            refusal = fused_refusal(self.solver, self.dtype, self.smooth, self.fft_impl)
            if refusal:
                raise ValueError(refusal)
        n = self.grid.shape[-1]
        self._m_full = n // 2 + 1
        self._rows = None
        if self.fft_impl not in ("fft", "dft", "dft_aligned", "dft_galerkin"):
            raise ValueError(
                f"unknown fft_impl {self.fft_impl!r}; expected one of "
                "'fft', 'dft', 'dft_aligned', 'dft_galerkin'"
            )
        if self.mxu_precision not in dft2d.PRECISIONS:
            raise ValueError(f"unknown precision {self.mxu_precision!r}")
        if self.fft_impl == "dft_galerkin":
            if not self.smooth:
                raise ValueError(
                    "fft_impl='dft_galerkin' steps on the 2/3-rule dealiasing "
                    "support and requires smooth=True"
                )
            self._rows, self._m = dft2d.galerkin_block(n)
            self._row_index = torch.as_tensor(self._rows, device=self.device)
        else:
            self._m = n // 2 if self.fft_impl == "dft_aligned" else self._m_full
        kx, ky = self.grid.rfft_mesh(dtype=self.dtype, device=self.device)
        kx, ky = kx[..., : self._m], ky[..., : self._m]
        if self._rows is not None:
            kx, ky = kx[self._row_index], ky[self._row_index]
        self.kx, self.ky = kx.contiguous(), ky.contiguous()
        # Laplacian symbol without the zero-mode guard; the stream-function
        # inversion in _stream applies the guard itself
        self.laplace = -4 * (math.pi**2) * (self.kx.abs() ** 2 + self.ky.abs() ** 2)
        self.linear_term = self.viscosity * self.laplace - self.drag
        if self._rows is not None:
            # the Galerkin block is the filter support: no per-step mask
            full = brick_wall_mask_2d(n)
            blk = full[np.asarray(self._rows), : self._m]
            if not (blk.all() and int(full.sum()) == blk.size):
                raise AssertionError(
                    "galerkin block does not match the brick-wall filter support"
                )
            self.filter = None
        else:
            self.filter = brick_wall_filter_2d(
                self.grid, dtype=self.dtype, device=self.device)[..., : self._m]
        self._imex_constants = None

    def _stream(self, vort_hat: Tensor) -> Tensor:
        """The stream function ψ̂ = -ŵ/Δ̂, the zero mode guarded."""
        return -vort_hat / spectral_laplacian_2d((self.kx, self.ky))

    def _explicit_terms(self, vort_hat: Tensor) -> Tensor:
        vhat = spectral_rot_2d(self._stream(vort_hat), (self.kx, self.ky))
        grad_x_hat = 2j * math.pi * self.kx * vort_hat
        grad_y_hat = 2j * math.pi * self.ky * vort_hat
        specs = torch.stack([vhat[0], vhat[1], grad_x_hat, grad_y_hat])
        vx, vy, grad_x, grad_y = self._irfft2(specs).unbind(0)

        advection = -(grad_x * vx + grad_y * vy)
        terms = self._rfft2(advection)
        if self.smooth and self.filter is not None:
            terms = terms * self.filter

        if self.forcing_fn is not None:
            terms = terms + self._forcing_term()
        return terms

    def _forcing_term(self) -> Tensor:
        """The forcing's spectrum in the internal layout and the solver dtype
        (fp64 runs need an fp64 forcing), evaluated at first use. Every
        ForcingFn is state-independent, and an evaluation builds its mesh on
        the host: its copy to the card would wait for the stream at every
        explicit step."""
        if self._forcing_hat is None:
            kw = dict(dtype=self.dtype, device=self.device)
            if not self.forcing_fn.vorticity:
                fx, fy = self.forcing_fn(self.grid, None, **kw)
                fx_hat = self._rfft2(fx.data.to(self.dtype))
                fy_hat = self._rfft2(fy.data.to(self.dtype))
                self._forcing_hat = spectral_curl_2d((fx_hat, fy_hat), (self.kx, self.ky))
            else:
                self._forcing_hat = self._rfft2(
                    self.forcing_fn(self.grid, None, **kw).data.to(self.dtype))
        return self._forcing_hat

    def _kernel_takes(self, vort_hat: Tensor) -> bool:
        """The route rule of the IMEX-spectral kernels
        (``ops/cuda/imex_spectral.py``), for ``explicit_terms`` and for
        ``IMEXStepper``'s order-2 update alike: ``fft_impl="fft"`` and a plain
        tensor of the solver's device and complex dtype, contiguous, of the
        half-spectrum's shape ``(..., n, n//2+1)``, that needs no gradient. The
        wrappers launch on the card and run their plain versions (the same
        torch operations) on the CPU; every other spectrum, and every other
        transform, takes the composed path."""
        complex_dtype = {torch.float32: torch.complex64, torch.float64: torch.complex128}
        return (self.fft_impl == "fft"
                and type(vort_hat) is torch.Tensor
                and vort_hat.dtype == complex_dtype.get(self.dtype)
                and vort_hat.device == self.kx.device
                and vort_hat.dim() >= 2
                and vort_hat.shape[-2:] == self.kx.shape
                and vort_hat.is_contiguous()
                and not (torch.is_grad_enabled() and vort_hat.requires_grad))

    def _kernel_constants(self) -> imex_spectral.Constants:
        """The kernels' per-mode constants, built once at first use by the
        composed path's own expressions, so to the same bits: the symbols
        2πi k, the guarded Laplacian, the linear term, the filter and the
        forcing's spectrum."""
        if self._imex_constants is None:
            self._imex_constants = imex_spectral.constants(
                (2j * math.pi * self.kx).contiguous(), (2j * math.pi * self.ky).contiguous(),
                spectral_laplacian_2d((self.kx, self.ky)).contiguous(),
                self.linear_term.contiguous(),
                self.filter.contiguous() if self.smooth else None,
                self._forcing_term().contiguous() if self.forcing_fn is not None else None,
                self.grid.shape)
        return self._imex_constants

    def _explicit_terms_kernels(self, vort_hat: Tensor) -> Tensor:
        """``_explicit_terms`` on the IMEX-spectral kernels around the
        ``torch.fft`` pair: the four spectra in one buffer, the inverse
        transform unnormalised (``advect`` applies its scale), the
        advection product, the forward transform, the 2/3 rule and the
        forcing."""
        c = self._kernel_constants()
        specs = imex_spectral.spectra(vort_hat, c)
        planes = torch.fft.irfft2(specs, s=self.grid.shape, norm="forward")
        terms = torch.fft.rfft2(imex_spectral.advect(planes, c))
        return imex_spectral.finish(terms, c)

    def explicit_terms(self, vort_hat: Tensor) -> Tensor:
        if self._kernel_takes(vort_hat):
            return self._explicit_terms_kernels(vort_hat)
        shape_in = tuple(vort_hat.shape[-2:])
        return self._unalign(self._explicit_terms(self._align(vort_hat)), shape_in)

    def implicit_terms(self, vort_hat: Tensor) -> Tensor:
        shape_in = tuple(vort_hat.shape[-2:])
        return self._unalign(self.linear_term * self._align(vort_hat), shape_in)

    def implicit_solve(self, vort_hat: Tensor, dt: float) -> Tensor:
        shape_in = tuple(vort_hat.shape[-2:])
        out = 1 / (1 - dt * self.linear_term) * self._align(vort_hat)
        return self._unalign(out, shape_in)

    def step(self, vort_hat: Tensor, dt: float, steps: int = 1):
        return self.forward(vort_hat, dt, steps)

    def forward(self, vort_hat: Tensor, dt: float, steps: int = 1
                ) -> Tuple[Tensor, Tensor]:
        """Marches ``steps`` steps; returns (ŵ_new, ∂ŵ/∂t estimate). A
        spectrum that ``parallel.shard_field_spatial`` sharded on its rows
        steps by pencil FFTs (``parallel/pencil.py``), sharded as it came.
        One ``solver.forward`` span (``utils.trace_annotation``) covers the
        call."""
        with trace_annotation("solver.forward"):
            if type(vort_hat) is not torch.Tensor:
                from torch.distributed.tensor import DTensor

                if isinstance(vort_hat, DTensor):
                    from tpu_cfd_torch.parallel import pencil

                    return pencil.forward(self, vort_hat, dt, steps)
            shape_in = tuple(vort_hat.shape[-2:])
            vort_hat = self._align(vort_hat)
            vort_old = vort_hat
            if self.fused:
                from tpu_cfd_torch.ops.cuda import spectral_step

                f_hat = self._forcing_term() if self.forcing_fn is not None else None
                rollout = (
                    spectral_step.fused_rollout_galerkin
                    if self.fft_impl == "dft_galerkin"
                    else spectral_step.fused_rollout_aligned
                )
                vort_hat = rollout(
                    vort_hat, grid=self.grid, viscosity=self.viscosity,
                    drag=self.drag, dt=dt, steps=steps, forcing_hat=f_hat,
                    precision=self.mxu_precision, block_cols=self.fused_block_cols,
                )
            else:
                for _ in range(steps):
                    vort_hat = self.solver(vort_hat, dt, self)
            dvortdt_hat = 1 / (steps * dt) * (vort_hat - vort_old)
            return (
                self._unalign(vort_hat, shape_in),
                self._unalign(dvortdt_hat, shape_in),
            )

    __call__ = forward

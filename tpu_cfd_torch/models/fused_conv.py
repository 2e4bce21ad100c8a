"""The SFNO spatial spectral conv through the truncated 2-D DFT kernels.

Counterpart of ``tpu_cfd/models/pallas_conv.py``: the two spatial
contractions of each direction run in the CUDA kernels of
``ops/cuda/spectral_conv.py`` (``modes`` and ``inverse``, each the other's
backward); the temporal DFTs and the weight/bias contraction on the mode
tensor stay plain einsums, as the JAX function keeps them in XLA.

Semantics are ``SpectralConv._dft_apply`` with ``t_pad=0`` and the output on
the input mesh (the SpectralConvS configuration), for float32 inputs and
``norm="backward"``. ``fused_spectral_conv_s`` is differentiable (each
kernel is the other's backward), so it is also what the JAX module's alias
``fused_spectral_conv_s_vjp`` names.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from tpu_cfd_torch.models.base import (
    _dft_fwd_c2c,
    _dft_fwd_low,
    _dft_inv_c2c,
    _dft_inv_low,
)
from tpu_cfd_torch.ops.cuda import spectral_conv as sc

Tensor = torch.Tensor


@functools.lru_cache(maxsize=32)
def _dft2d_constants(nx: int, ny: int, mx: int, my: int, device: str,
                     cdtype: str) -> dict:
    """The kernels' transform matrices (``sc`` docstring), on ``device``."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return {
        "FyT": t(_dft_fwd_c2c(ny, my, cdtype=cdtype).T),     # (ny, 2my)
        "FxT": t(_dft_fwd_c2c(nx, mx, cdtype=cdtype).T),     # (nx, 2mx)
        "GxT": t(_dft_inv_c2c(nx, mx, cdtype=cdtype).T),     # (2mx, nx)
        "GyT": t(_dft_inv_c2c(ny, my, cdtype=cdtype).T),     # (2my, ny)
    }


def make_dft2d_ops(nx: int, ny: int, mx: int, my: int, device="cpu",
                   dtype: torch.dtype = torch.float32):
    """Returns (modes, inverse): the truncated 2-D spatial DFT pair.

    modes:   (b, P, nx, ny) real -> (b, P, 2my, 2mx) complex
    inverse: (b, P, 2my, 2mx) complex, scale -> (b, P, nx, ny) real

    Each differentiates through the other. The kernels run on the card
    (their plain versions on the CPU) and are float32-only; float64 exists
    for gradient checks on the CPU.
    """
    cdtype = "complex128" if dtype == torch.float64 else "complex64"
    c = _dft2d_constants(nx, ny, mx, my, str(torch.device(device)), cdtype)

    def modes(v: Tensor) -> Tensor:
        return sc.dft2d_modes(v, c)

    def inverse(g: Tensor, scale: float) -> Tensor:
        return sc.dft2d_inverse(g, scale, c)

    return modes, inverse


@functools.lru_cache(maxsize=32)
def _t_mats(nt: int, mt: int, device: str):
    mt = min(mt, nt // 2 + 1)
    Ft = torch.from_numpy(_dft_fwd_low(nt, mt)).to(device)        # (mt, nt)
    Gt = torch.from_numpy(_dft_inv_low(nt, mt, nt)).to(device)    # (nt, mt)
    return Ft, Gt, mt


def _scale_for(norm: str, n_mesh: int) -> float:
    # The unnormalized forward DFT pairs with a 1/n_mesh inverse; another
    # norm would need its factor in the modes and in the bias, which is
    # added before the inverse.
    if norm == "backward":
        return 1.0 / n_mesh
    raise NotImplementedError(
        f"fused_spectral_conv_s supports norm='backward' only, got {norm!r}"
    )


# SpectralConvS forward + backward at 64², ms, fused kernel pair / torch.fft,
# on an NVIDIA H100 80GB HBM3 at a 700 W power limit (python3 -m
# tpu_cfd_torch.ops.cuda.route_times --sweep conv; medians of three rounds,
# two runs; PERF.md §6). Where all modes are kept (2m = n) the pair won
# at 800 to 3,200 planes and lost from 6,400 up; this is the geometric mean.
FULL_MODES_MAX_PLANES = 4525


def fused_pair_wins(nx: int, ny: int, mx: int, my: int, planes: int) -> bool:
    """Whether a same-mesh fp32 SpectralConvS runs faster through the fused
    DFT kernel pair than through the ``torch.fft`` arithmetic, from the shape
    alone: ``planes`` = b x t x channels planes of nx x ny, modes (mx, my).

    Measured at 64² on an NVIDIA H100 80GB HBM3 (700 W), forward plus
    backward, median ms (kernels / fft):
    - all modes kept (m = 32): 6,400 planes, the McWilliams recipe (b 64,
      t 10, c 10), 5.6710 / 4.9326 and 5.7064 / 4.9830 in two runs; 12,800
      planes 11.0249 / 9.4971; but 3,200 planes 3.0611 / 3.3804, 800 planes
      (the optimizer sweep's b 4, t 10, c 20) 2.8594 / 3.9302. So the pair
      wins up to ``FULL_MODES_MAX_PLANES``.
    - fewer modes (m ≤ 24): the pair won at every count measured, 800 to
      12,800 planes (m = 24, 12,800: 7.5493 / 8.2632; the sweep's m = 12:
      2.4156 / 3.5987).
    - where the fused kernels do not take the shape (a plane too large for
      an SM's shared memory, e.g. 256²), the pair runs on two passes of CUDA
      cores, 2× behind cuFFT at the recipe's planes (0.6702 ms against 0.3070
      for ``dft2d_modes``; PERF.md §6): no.
    The answer depends on the shape only, never on the device.
    """
    if (sc.fused_modes_layout(nx, ny, 2 * my, 2 * mx) is None
            or sc.fused_inverse_layout(nx, ny, 2 * my, 2 * mx) is None):
        return False
    if 2 * mx >= nx or 2 * my >= ny:
        return planes <= FULL_MODES_MAX_PLANES
    return True


def fused_spectral_conv_s(
    v: Tensor,
    weight: Tensor,
    bias: Optional[Tensor],
    modes: Tuple[int, int, int],
    delta: float = 1.0,
    norm: str = "backward",
) -> Tensor:
    """SpectralConvS through the DFT kernels (same-mesh output).

    v: (b, nx, ny, nt, ci) float32, channels-last; weight: compact complex
    (2mx, 2my, mt_w, ci, co) (``SpectralConv.compact_weight()``); bias:
    compact complex (2mx, 2my, mt_w) or None. Returns (b, nx, ny, nt, co).
    """
    if v.dtype != torch.float32:
        raise ValueError(f"fused_spectral_conv_s is float32-only, got {v.dtype}")
    b, nx, ny, nt, ci = v.shape
    mx, my, mt_req = modes
    co = weight.shape[-1]
    Ft, Gt, mt = _t_mats(nt, mt_req, str(v.device))
    dft_modes, dft_inverse = make_dft2d_ops(nx, ny, mx, my, v.device)
    scale = _scale_for(norm, nx * ny * nt)

    # spatial transform on (b, nt*ci, nx, ny): a contiguous copy of v
    vk = v.permute(0, 3, 4, 1, 2).reshape(b, nt * ci, nx, ny)
    g = dft_modes(vk).reshape(b, nt, ci, 2 * my, 2 * mx)

    # temporal DFT + weight/bias contraction + inverse temporal, on the mode
    # tensor, which is (nx*ny)/(4*mx*my) times smaller than the field
    g = torch.einsum("btiyx,Tt->bTiyx", g, Ft)
    w = weight[:, :, :mt].permute(2, 3, 4, 1, 0)            # (mt, ci, co, 2my, 2mx)
    o = torch.einsum("bTiyx,Tioyx->bToyx", g, w)
    if bias is not None:
        bc = bias[:, :, :mt].permute(2, 1, 0)                # (mt, 2my, 2mx)
        o = o + delta * bc[None, :, None]
    o = torch.einsum("bToyx,tT->btoyx", o, Gt)

    out = dft_inverse(o.reshape(b, nt * co, 2 * my, 2 * mx), scale)
    return out.reshape(b, nt, co, nx, ny).permute(0, 3, 4, 1, 2)

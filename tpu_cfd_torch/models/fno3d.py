"""FNO3d, the Li et al. Fourier Neural Operator baseline, as ``torch.nn`` modules.

Counterpart of ``tpu_cfd/models/fno3d.py``, channels-last ``(b, x, y, t, c)``:
the input carries ``input_channel`` solution steps broadcast in time plus the
(x, y, t) coordinate channels, and ``FNO3d.forward`` returns ``(out, None)``
with ``out`` ``(b, x, y, t)``, as the JAX model does. No hand-written kernel
lies on this model's path, as none does in the JAX package: ``MLP3d`` is two
``nn.Linear`` and ``SpectralConv3d`` is ``torch.fft.rfftn`` → corner blocks →
``irfftn`` (``SpectralConv.forward``). Module attributes follow
``tpu_cfd_torch.convert``, which maps them to the flax names.

Spans (``utils.trace_annotation``): in ``FNO3d.forward``, ``fno3d.conv``
around each spectral conv (``rfftn``, the corner blocks, ``irfftn``),
``fno3d.mlp`` around each block's ``MLP3d`` and ``fno3d.head`` around the
projection. ``COUNTS`` counts the forwards, the spectral conv calls and the
points they transform (b·x·y·t of each conv's input, summed);
``reset_counts`` sets them to zero.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpu_cfd_torch.models.base import (
    SpectralConv,
    as_dtype,
    dense,
    remat_block,
    view_as_complex,
)
from tpu_cfd_torch.utils.profiling import trace_annotation

Tensor = torch.Tensor

COUNTS = {"forwards": 0, "conv_calls": 0, "conv_points": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def _gelu(x: Tensor) -> Tensor:
    return F.gelu(x, approximate="tanh")  # flax's nn.gelu


class SpectralConv3d(SpectralConv):
    """3-D Fourier layer: 4 (x, y)-corner blocks × low t modes, no bias."""

    def spectral_conv(self, vh: Tensor, kx: int, ky: int, kt: int) -> Tensor:
        modes1, modes2, modes3 = self.modes
        out = vh.new_zeros((vh.shape[0], kx, ky, kt, self.out_channels))
        slice_x = [slice(0, modes1), slice(-modes1, None)]
        slice_y = [slice(0, modes2), slice(-modes2, None)]
        st = slice(0, modes3)
        for ix, sx in enumerate(slice_x):
            for iy, sy in enumerate(slice_y):
                w = view_as_complex(getattr(self, f"weight_{ix + 2 * iy}"))
                out[:, sx, sy, st, :] = self.complex_matmul(vh[:, sx, sy, st, :], w)
        return out


class MLP3d(nn.Module):
    """Pointwise 2-layer MLP; ``dtype`` is the computation dtype (parameters
    stay float32; None follows the input)."""

    def __init__(self, in_channels: int, out_channels: int, mid_channels: int,
                 activation: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.activation = activation
        self.dtype = dtype
        self.dense_0 = nn.Linear(in_channels, mid_channels)
        self.dense_1 = nn.Linear(mid_channels, out_channels)

    def forward(self, x: Tensor) -> Tensor:
        x = dense(self.dense_0, x, self.dtype)
        if self.activation:
            x = _gelu(x)
        return dense(self.dense_1, x, self.dtype)


class FNO3d(nn.Module):
    """Baseline FNO-3D.

    ``forward``: (b, x, y, t, input_channel + 3) -> ((b, x, y, t), None).
    ``compute_dtype="bfloat16"`` runs the lifting and the backbone's
    activations in bf16 (parameters and the output head stay in the input's
    dtype; each spectral conv transforms in float32); ``remat`` recomputes
    each backbone block in the backward pass. ``padding`` pads the spatial
    axes circularly, for non-periodic domains.
    """

    def __init__(self, modes1: int, modes2: int, modes3: int, width: int,
                 dim: int = 3, input_channel: int = 10,
                 num_spectral_layers: int = 4, last_activation: bool = False,
                 padding: int = 0, channel_expansion: int = 128,
                 compute_dtype: Optional[str] = None, remat: bool = False):
        super().__init__()
        self.last_activation = last_activation
        self.padding = padding
        self.dtype = as_dtype(compute_dtype)
        self.remat = remat
        layers = range(num_spectral_layers)
        self.lift = nn.Linear(input_channel + dim, width)
        self.convs = nn.ModuleList(
            SpectralConv3d(width, width, (modes1, modes2, modes3), impl="fft")
            for _ in layers)
        self.mlps = nn.ModuleList(
            MLP3d(width, width, width, dtype=self.dtype) for _ in layers)
        self.skips = nn.ModuleList(nn.Linear(width, width) for _ in layers)
        self.head = MLP3d(width, 1, channel_expansion, activation=last_activation)

    def forward(self, x: Tensor) -> Tuple[Tensor, None]:
        in_dtype = x.dtype
        COUNTS["forwards"] += 1
        x = dense(self.lift, x, self.dtype)
        p = self.padding
        if p != 0:
            x = torch.cat([x[:, -p:], x, x[:, :p]], dim=1)
            x = torch.cat([x[:, :, -p:], x, x[:, :, :p]], dim=2)
        last = len(self.convs) - 1
        for i, (conv, mlp, skip) in enumerate(zip(self.convs, self.mlps, self.skips)):
            COUNTS["conv_calls"] += 1
            COUNTS["conv_points"] += math.prod(x.shape[:4])
            with trace_annotation("fno3d.conv"):
                x1 = remat_block(conv, x, self.remat)
            with trace_annotation("fno3d.mlp"):
                x1 = remat_block(mlp, x1, self.remat)
            x = x1 + dense(skip, x, self.dtype)
            if i < last or self.last_activation:
                x = _gelu(x)
        if p != 0:
            x = x[:, p:-p, p:-p, :, :]
        with trace_annotation("fno3d.head"):
            return self.head(x.to(in_dtype))[..., 0], None


def add_grid_3d(x: Tensor) -> Tensor:
    """Appends the normalized (x, y, t) coordinate channels to (b, x, y, t, c)."""
    b, nx, ny, nt, _ = x.shape
    kw = dict(dtype=x.dtype, device=x.device)
    gx = torch.linspace(0, 1, nx, **kw)
    gy = torch.linspace(0, 1, ny, **kw)
    gt = torch.linspace(0, 1, nt + 1, **kw)[1:]
    grid = torch.stack(torch.meshgrid(gx, gy, gt, indexing="ij"), dim=-1)
    return torch.cat([x, grid[None].expand(b, nx, ny, nt, 3)], dim=-1)


def make_fno3d_input(a: Tensor, out_steps: int) -> Tensor:
    """(b, n, n, T_in) input frames -> (b, n, n, out_steps, T_in + 3): the
    frames broadcast along the output time axis plus the grid channels."""
    b, nx, ny, t_in = a.shape
    return add_grid_3d(a[..., None, :].expand(b, nx, ny, out_steps, t_in))

"""SFNO, the spatiotemporal Fourier Neural Operator, as ``torch.nn`` modules.

Counterpart of ``tpu_cfd/models/sfno.py``, channels-last ``(b, x, y, t, c)``:
``SFNO.forward`` takes ``(b, x, y, t_in)`` vorticity and returns
``(b, x, y, out_steps)`` (or ``(..., 2)`` for a Helmholtz-projected velocity
with ``out_dim=2``), at any space-time discretization. Module attributes
follow ``tpu_cfd_torch.convert``, which maps them to the flax names.

``SpectralConvS`` on a float32 input with ``impl="dft"`` and
``norm="backward"`` runs through the truncated 2-D DFT kernels
(``models/fused_conv.py``) where ``fused_pair_wins`` says they are faster on
the card than ``torch.fft`` (a choice by shape, measured on an H100), and
through the ``impl="fft"`` arithmetic where it says no; ``SpectralConvT``
runs ``SpectralConv._dft_apply``, as the whole JAX model does, or the FFT
path where ``dft_apply_wins`` says that is faster on the card (both answers
by shape, measured on an H100). A bfloat16 input (``compute_dtype``) goes up to float32 first,
so it takes the same route, and the result comes back down.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from tpu_cfd_torch.models.base import (
    LayerNormnd,
    PointwiseFFN,
    SpectralConv,
    as_dtype,
    dense,
    get_activation,
    remat_block,
    view_as_complex,
)
from tpu_cfd_torch.models.fused_conv import fused_pair_wins, fused_spectral_conv_s

Tensor = torch.Tensor


def _coords(nx: int, ny: int, nt: int, max_time_steps: int):
    gridt = np.linspace(0, 1, max_time_steps + 1)[1: nt + 1]
    return np.meshgrid(np.linspace(0, 1, nx), np.linspace(0, 1, ny), gridt,
                       indexing="ij")


@functools.lru_cache(maxsize=8)
def _pe_table(nx: int, ny: int, nt: int, num_channels: int, modes: tuple,
              expanded: bool, max_time_steps: int, scale: float,
              dtype: torch.dtype, device: str) -> Tensor:
    """The ``(1, x, y, t, C)`` encoding, computed in fp64 on the host."""
    gridx, gridy, gridt = _coords(nx, ny, nt, max_time_steps)
    pe = [gridx, gridy, gridt]
    if expanded:
        for i in range(1, modes[0] + 1):
            basis_x = np.sin if i % 2 == 0 else np.cos
            for j in range(1, modes[1] + 1):
                basis_y = np.sin if j % 2 == 0 else np.cos
                for k in range(1, modes[2] + 1):
                    basis_t = np.sin if k % 2 == 0 else np.cos
                    pe.append(1 / (i * j * k) * np.exp(scale * gridt)
                              * basis_x(np.pi * i * gridx)
                              * basis_y(np.pi * j * gridy)
                              * basis_t(np.pi * k * gridt))
    else:
        t = gridt[0, 0, :]
        for k in range(num_channels - 3):
            basis = np.sin if k % 2 == 0 else np.cos
            profile = np.exp(scale * t) * basis(np.pi * (k + 1) * t)
            pe.append(np.broadcast_to(profile[None, None, :], (nx, ny, nt)))
    pe = np.stack(pe, axis=-1)[None]
    return torch.from_numpy(np.ascontiguousarray(pe)).to(device=device, dtype=dtype)


class SpaceTimePositionalEncoding(nn.Module):
    """Sinusoidal space-time PE with exponential time scaling.

    Channels are the (x, y, t) coordinates plus ``num_channels - 3``
    temporal bases ``exp(beta*t) * sin/cos(pi*(k+1)*t)``; with
    ``spatial_random_feats`` the ``modes_x*modes_y*modes_t`` product basis is
    projected to ``num_channels`` by ``dense``. Adding the PE to a
    single-channel input broadcasts it to ``num_channels``.
    """

    def __init__(self, modes_x: int = 16, modes_y: int = 16, modes_t: int = 5,
                 num_channels: int = 20, spatial_random_feats: bool = False,
                 max_time_steps: int = 100, time_exponential_scale: float = 1e-2):
        super().__init__()
        self.modes_x, self.modes_y, self.modes_t = modes_x, modes_y, modes_t
        self.num_channels = num_channels
        self.spatial_random_feats = spatial_random_feats
        self.max_time_steps = max_time_steps
        self.time_exponential_scale = time_exponential_scale
        if spatial_random_feats:
            self.dense = nn.Linear(3 + modes_x * modes_y * modes_t, num_channels)

    def forward(self, v: Tensor) -> Tensor:
        """(b, x, y, t, 1) -> (b, x, y, t, num_channels)."""
        _, nx, ny, nt, _ = v.shape
        pe = _pe_table(nx, ny, nt, self.num_channels,
                       (self.modes_x, self.modes_y, self.modes_t),
                       self.spatial_random_feats, self.max_time_steps,
                       self.time_exponential_scale, v.dtype, str(v.device))
        if self.spatial_random_feats:
            pe = self.dense(pe)
        return v + pe


class HelmholtzProjection(nn.Module):
    """Frequency-domain Leray projection: û - ∇(∇·û)/Δ̂.

    Operates on the channels-last half spectrum ``(b, x, y, kt, 2)``; the
    (full) x/y frequency meshes come from the input's shape.
    """

    def __init__(self, diam: float = 2 * np.pi):
        super().__init__()
        self.diam = diam

    @staticmethod
    def _fft_mesh(nx: int, diam: float, dtype, device):
        k = torch.fft.fftfreq(nx, d=diam / nx, dtype=dtype, device=device)
        kx, ky = torch.meshgrid(k, k, indexing="ij")
        return kx[..., None], ky[..., None]

    @staticmethod
    def div(uhat: Tensor, fft_mesh) -> Tensor:
        kx, ky = fft_mesh
        return 2j * np.pi * (uhat[..., 0] * kx + uhat[..., 1] * ky)

    @staticmethod
    def grad(uhat: Tensor, fft_mesh) -> Tensor:
        kx, ky = fft_mesh
        return torch.stack([2j * np.pi * kx * uhat, 2j * np.pi * ky * uhat], dim=-1)

    def forward(self, uhat: Tensor, fft_mesh=None) -> Tensor:
        _, nx, ny, nt, d = uhat.shape
        if d != 2:
            raise ValueError("Helmholtz projection expects a 2-component field")
        if fft_mesh is not None:
            kx, ky = fft_mesh
        else:
            kx, ky = self._fft_mesh(nx, self.diam, uhat.real.dtype, uhat.device)
        lap = -4 * (np.pi ** 2) * (kx ** 2 + ky ** 2)
        lap = lap.clone()
        lap[0, 0] = 1.0
        grad_div_u = self.grad(self.div(uhat, (kx, ky)), (kx, ky))
        return uhat - grad_div_u / lap[..., None]


class SpectralConvS(SpectralConv):
    """Space-focused 3-D spectral conv: 4 (x,y)-corner blocks, low t modes."""

    def forward(self, v: Tensor, out_mesh_size=None) -> Tensor:
        if v.dtype == torch.bfloat16:  # mode-space math stays complex64
            return self.forward(v.float(), out_mesh_size).to(torch.bfloat16)
        if self.impl != "dft":
            return super().forward(v, out_mesh_size=out_mesh_size)
        same_mesh = out_mesh_size is None or tuple(out_mesh_size) == tuple(v.shape[1:4])
        if same_mesh and v.dtype == torch.float32 and self.norm == "backward":
            b, nx, ny, nt, ci = v.shape
            planes = b * nt * max(ci, self.out_channels)
            if not fused_pair_wins(nx, ny, self.modes[0], self.modes[1], planes):
                return super().forward(v, out_mesh_size=out_mesh_size)
            return fused_spectral_conv_s(
                v, self.compact_weight(),
                self.compact_bias() if self.bias else None,
                self.modes, self.delta, self.norm)
        return self._dft_apply(v, out_mesh_size=out_mesh_size)

    def spectral_conv(self, vh: Tensor, kx: int, ky: int, kt: int) -> Tensor:
        b = vh.shape[0]
        modes_x, modes_y, modes_t = self.modes
        out = vh.new_zeros((b, kx, ky, kt, self.out_channels))
        slice_x = [slice(0, modes_x), slice(-modes_x, None)]
        slice_y = [slice(0, modes_y), slice(-modes_y, None)]
        st = slice(0, modes_t)
        for ix, sx in enumerate(slice_x):
            for iy, sy in enumerate(slice_y):
                w = view_as_complex(getattr(self, f"weight_{ix + 2 * iy}"))
                block = self.complex_matmul(vh[:, sx, sy, st, :], w)
                if self.bias:
                    bias = view_as_complex(getattr(self, f"bias_{ix + 2 * iy}"))
                    block = block + self.delta * bias[..., None]
                out[:, sx, sy, st, :] = block
        return out


# SpectralConvT (the lifting's and the output's) forward + backward at 64²,
# ms, dense DFT einsums / torch.fft, on an NVIDIA H100 80GB HBM3 at a 700 W
# power limit (python3 -m tpu_cfd_torch.ops.cuda.route_times --sweep convt;
# PERF.md §6): up to these planes both are host-bound and neither wins.
DFT_APPLY_MAX_PLANES = 800


def dft_apply_wins(nx: int, ny: int, mx: int, my: int, planes: int) -> bool:
    """Whether a float32 SpectralConvT runs faster on its dense DFT einsums
    (``_dft_apply``, the JAX package's route) than on ``torch.fft``, from the
    shape alone: ``planes`` = b x t x channels planes of nx x ny, modes
    (mx, my).

    Measured on an NVIDIA H100 80GB HBM3 (700 W), forward plus backward, median
    ms (einsums / fft): the recipe's lifting (64², 6,400 planes) 2.6892 /
    3.7730 at m = 12 and 3.3139 / 4.5191 at m = 16, but 5.2172 / 4.3853 at
    m = 24 and 7.0842 / 5.1149 at m = 32 (the recipe). So the einsums win
    where the modes are at most a quarter of the mesh, and torch.fft above
    that. At up to ``DFT_APPLY_MAX_PLANES`` planes (the recipe's output conv,
    704 planes; the optimizer sweep's two, 800 and 44) both take 1.6-4.2 ms,
    bound by the host, and the sign of the difference flips between
    neighbouring m: the einsums stay, as in the JAX package.
    """
    return 4 * max(mx, my) <= min(nx, ny) or planes <= DFT_APPLY_MAX_PLANES


class SpectralConvT(SpectralConvS):
    """Time-focused spectral conv with output-steps resampling.

    The irfft output length sets the temporal resolution; left temporal
    zero-padding suppresses aliasing from the non-periodic time axis.
    Always ``_dft_apply`` (or the FFT path), never the fused kernels; with
    ``impl="dft"`` a float32 input takes the FFT path where
    ``dft_apply_wins`` says it is faster on the card.
    """

    def __init__(self, *args, out_steps: Optional[int] = None,
                 temporal_padding: bool = False,
                 postprocess: Optional[nn.Module] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.out_steps = out_steps
        self.temporal_padding = temporal_padding
        self.postprocess = postprocess

    def _compact_helmholtz(self, dtype, device):
        """Adapter: Helmholtz postprocess on the compact mode spectrum."""
        mx, my, _ = self.modes
        diam = getattr(self.postprocess, "diam", 2 * np.pi)
        rdtype = torch.float64 if dtype == torch.float64 else torch.float32
        k_signed = lambda m: torch.from_numpy(  # noqa: E731
            np.concatenate([np.arange(m), -np.arange(m, 0, -1)]) / diam
        ).to(device=device, dtype=rdtype)
        kx = k_signed(mx)[:, None, None]
        ky = k_signed(my)[None, :, None]
        post = lambda uhat, mesh: self.postprocess(uhat, fft_mesh=mesh)  # noqa: E731
        return post, (kx, ky)

    def forward(self, v: Tensor, out_steps: Optional[int] = None) -> Tensor:
        if v.dtype == torch.bfloat16:
            return self.forward(v.float(), out_steps).to(torch.bfloat16)
        if out_steps is None and self.out_steps is not None:
            out_steps = self.out_steps
        b, nx, ny, nt, ci = v.shape
        planes = b * nt * max(ci, self.out_channels)
        if self.impl == "dft" and (v.dtype != torch.float32 or dft_apply_wins(
                nx, ny, self.modes[0], self.modes[1], planes)):
            t_pad = nt if self.temporal_padding else 0
            if out_steps is None:
                out_steps = nt
            post = mesh = None
            if self.postprocess is not None:
                post, mesh = self._compact_helmholtz(v.dtype, v.device)
            return self._dft_apply(
                v, out_mesh_size=(nx, ny, out_steps + t_pad), t_pad=t_pad,
                keep_last=out_steps, postprocess=post, postprocess_mesh=mesh)
        if self.temporal_padding:
            t_pad = v.shape[-2]
            v = torch.nn.functional.pad(v, (0, 0, t_pad, 0))
        else:
            t_pad = 0
        _, nx, ny, ntp, _ = v.shape
        if out_steps is None:
            out_steps = ntp - t_pad
        axes = (-4, -3, -2)
        v_hat = torch.fft.rfftn(v, dim=axes, norm=self.norm)
        v_hat = self.spectral_conv(v_hat, nx, ny, ntp // 2 + 1)
        if self.postprocess is not None:
            v_hat = self.postprocess(v_hat)
        v = torch.fft.irfftn(v_hat, s=(nx, ny, out_steps + t_pad), dim=axes,
                             norm=self.norm)
        if self.temporal_padding:
            v = v[..., -out_steps:, :]
        return v


class LiftingOperator(nn.Module):
    """PE → LayerNorm → Dense → SpectralConvT to latent_steps (+FFN residual).

    The residual connection is on the last input frame.
    """

    def __init__(self, width: int, modes_x: int, modes_y: int, modes_t: int,
                 latent_steps: int = 10, norm: str = "backward",
                 activation: str = "GELU", beta: float = 0.1,
                 spatial_random_feats: bool = False, channel_expansion: int = 4,
                 nonlinear: bool = True, mxu_precision: str = "highest",
                 impl: str = "dft", compute_dtype: Optional[str] = None):
        super().__init__()
        self.latent_steps = latent_steps
        self.dtype = as_dtype(compute_dtype)
        self.activation = activation if nonlinear else "Identity"
        pe_modes_t = modes_t - 1 if modes_t % 2 != 0 else modes_t
        self.pe = SpaceTimePositionalEncoding(
            modes_x=modes_x // 2, modes_y=modes_y // 2, modes_t=pe_modes_t // 2,
            num_channels=width, time_exponential_scale=beta,
            spatial_random_feats=spatial_random_feats)
        self.norm = LayerNormnd(width)
        self.dense = nn.Linear(width, width)
        self.conv = SpectralConvT(
            width, width, (modes_x, modes_y, modes_t), out_steps=latent_steps,
            norm=norm, bias=False, mxu_precision=mxu_precision, impl=impl)
        if nonlinear:
            self.ffn = PointwiseFFN(width, width, channel_expansion * width,
                                    activation, dtype=self.dtype)
        else:
            self.linear = nn.Linear(width, width)

    def forward(self, v: Tensor) -> Tensor:
        """(b, x, y, t_in, 1) -> (b, x, y, latent_steps, width)."""
        if self.latent_steps > v.shape[-2]:
            raise ValueError("latent_steps must be <= input time steps")
        v = dense(self.dense, self.norm(self.pe(v)), self.dtype)
        w = self.conv(v)
        w = self.ffn(w) if hasattr(self, "ffn") else dense(self.linear, w, self.dtype)
        return get_activation(self.activation)(v[..., -1:, :] + w)


class OutConv(nn.Module):
    """Latent steps → out_steps via a temporally padded SpectralConvT.

    Skip connection from the last input frame; Helmholtz postprocessing for
    vector (out_dim=2) outputs.
    """

    def __init__(self, modes_x: int, modes_y: int, modes_t: int,
                 delta: float = 0.1, out_dim: int = 1, diam: float = 1.0,
                 out_steps: Optional[int] = None, spatial_padding: int = 0,
                 temporal_padding: bool = True, norm: str = "backward",
                 mxu_precision: str = "highest", impl: str = "dft"):
        super().__init__()
        self.spatial_padding = spatial_padding
        self.conv = SpectralConvT(
            out_dim, out_dim, (modes_x, modes_y, modes_t), norm=norm,
            delta=delta, out_steps=out_steps, bias=True,
            temporal_padding=temporal_padding,
            postprocess=HelmholtzProjection(diam=diam) if out_dim == 2 else None,
            mxu_precision=mxu_precision, impl=impl)

    def forward(self, v: Tensor, v_res: Tensor, out_steps: int) -> Tensor:
        """v: (b,x,y,t_latent,d), v_res: (b,x,y,t_in) → (b,x,y,out_steps[,d])."""
        d = v.shape[-1]
        v_res = v_res[..., None].expand(*v_res.shape, d)
        v = torch.cat([v_res[..., -1:, :], v], dim=-2)
        sp = self.spatial_padding
        if sp > 0:
            v = torch.nn.functional.pad(v, (0, 0, 0, 0, sp, sp, sp, sp))
        v = self.conv(v, out_steps=out_steps + 1)
        if sp > 0:
            v = v[:, sp:-sp, sp:-sp, :, :]
        v = v_res[..., -1:, :] + v[..., -out_steps:, :]
        return v[..., 0] if d == 1 else v


class SFNO(nn.Module):
    """Spatiotemporal FNO: lifting → (n-1)×[SpectralConvS + FFN + 1×1] → out.

    ``forward``: (b, x, y, t_in) -> (b, x, y, out_steps), or (..., 2) for
    ``out_dim=2``.

    ``compute_dtype="bfloat16"`` stores and computes the activations of the
    lifting and the backbone in bfloat16 (the lifting's Dense, every
    PointwiseFFN and the 1×1 skips); parameters stay float32, the mode-space
    math complex64, and the head and ``OutConv`` run in the input's dtype.
    ``remat`` recomputes the lifting, each SpectralConvS and each
    PointwiseFFN in the backward pass (``torch.utils.checkpoint``) instead of
    keeping their intermediates; the ``state_dict`` is the same either way,
    and the forward kernels of those blocks then launch twice a train step.
    """

    def __init__(self, modes_x: int, modes_y: int, modes_t: int, width: int,
                 out_dim: int = 1, beta: float = -1e-2, delta: float = 1e-1,
                 num_spectral_layers: int = 4, fft_norm: str = "backward",
                 activation: str = "ReLU", spatial_padding: int = 0,
                 temporal_padding: bool = True, channel_expansion: int = 4,
                 spatial_random_feats: bool = False, lift_activation: bool = True,
                 latent_steps: int = 10, output_steps: Optional[int] = None,
                 diam: float = 1.0, mxu_precision: str = "highest",
                 impl: str = "dft", compute_dtype: Optional[str] = None,
                 remat: bool = False):
        super().__init__()
        self.activation = activation
        self.output_steps = output_steps
        self.dtype = as_dtype(compute_dtype)
        self.remat = remat
        modes = (modes_x, modes_y, modes_t)
        self.lifting = LiftingOperator(
            width, modes_x, modes_y, modes_t, latent_steps=latent_steps,
            norm=fft_norm, activation=activation, beta=beta,
            spatial_random_feats=spatial_random_feats,
            channel_expansion=channel_expansion, nonlinear=lift_activation,
            mxu_precision=mxu_precision, impl=impl, compute_dtype=compute_dtype)
        layers = range(num_spectral_layers - 1)
        self.convs = nn.ModuleList(
            SpectralConvS(width, width, modes, norm=fft_norm,
                          mxu_precision=mxu_precision, impl=impl) for _ in layers)
        self.ffns = nn.ModuleList(
            PointwiseFFN(width, width, channel_expansion * width, activation,
                         dtype=self.dtype)
            for _ in layers)
        self.skips = nn.ModuleList(nn.Linear(width, width) for _ in layers)
        self.reduce = nn.Linear(width, out_dim)
        self.out_conv = OutConv(
            modes_x, modes_y, modes_t, out_dim=out_dim, delta=delta,
            out_steps=output_steps, spatial_padding=spatial_padding,
            temporal_padding=temporal_padding, norm=fft_norm, diam=diam,
            mxu_precision=mxu_precision, impl=impl)

    def latent_taps(self) -> dict:
        """The latents ``models.base.forward_with_latents`` records: the
        lifting's output, ``spectral_{i}`` the output of backbone layer i (the
        input of the next layer, or of the reduction), and ``r`` the reduced
        latent that feeds ``OutConv``, the fine-tune's input."""
        after = list(self.convs)[1:] + [self.reduce] if len(self.convs) else []
        return {"lifting": (self.lifting, "output"),
                **{f"spectral_{i}": (m, "input") for i, m in enumerate(after)},
                "r": (self.out_conv, "input")}

    def forward(self, v: Tensor, out_steps: Optional[int] = None) -> Tensor:
        if out_steps is None:
            out_steps = self.output_steps if self.output_steps is not None else v.shape[-1]
        v_res = v
        v = remat_block(self.lifting, v[..., None], self.remat)
        act = get_activation(self.activation)
        for conv, ffn, skip in zip(self.convs, self.ffns, self.skips):
            x1 = remat_block(ffn, remat_block(conv, v, self.remat), self.remat)
            v = act(x1 + dense(skip, v, self.dtype))
        v = self.reduce(v.to(v_res.dtype))
        return self.out_conv(v, v_res, out_steps=out_steps)


def num_parameters(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())

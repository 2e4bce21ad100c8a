"""FNO building blocks as ``torch.nn`` modules, channels-last.

Counterpart of ``tpu_cfd/models/base.py``. The layout stays the JAX
package's, ``(b, x, y, t, c)``: the 1×1 convolutions are ``nn.Linear`` over
the last axis, and a spectral weight is stored as real pairs
``(*modes, ci, co, 2)``, as the reference does. Parameter names follow
``tpu_cfd_torch.convert``, which carries flax parameters across.

``PointwiseFFN`` runs through the fused FFN kernel (``ops/cuda/ffn.py``)
on float32 and bfloat16 inputs. ``SpectralConv._dft_apply`` is the
mode-truncated transform as plain einsums; ``SpectralConvS``
(``models/sfno.py``) routes its float32 same-mesh case through the DFT
kernels instead.

A ``compute_dtype`` (``"bfloat16"``) is flax's computation dtype: the
activation and the weights are cast at the call (``dense``), parameters stay
float32, and the mode-space math stays complex64 (a bfloat16 input to a
spectral conv goes up to float32 and the result comes back down).
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from tpu_cfd_torch.ops.cuda import ffn as ffn_ops

Tensor = torch.Tensor

# flax's lecun_normal: a normal truncated at two standard deviations, whose
# std is divided by the std of the unit normal truncated there
_TRUNC_STD = 0.87962566103423978


def get_activation(name: str) -> Callable[[Tensor], Tensor]:
    """The reference's ``nn.<Name>`` activation strings as torch functions."""
    if name not in ffn_ops.ACTIVATIONS:
        raise ValueError(
            f"Unsupported activation {name!r}; available: "
            f"{sorted(ffn_ops.ACTIVATIONS)}"
        )
    return ffn_ops.ACTIVATIONS[name]


def as_dtype(compute_dtype: Optional[str]) -> Optional[torch.dtype]:
    """A ``compute_dtype`` string as a torch dtype; None stays None (the
    computation then follows the input's dtype)."""
    if compute_dtype is None:
        return None
    dtype = getattr(torch, str(compute_dtype), None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"unknown compute_dtype {compute_dtype!r}")
    return dtype


def dense(layer: nn.Linear, v: Tensor, dtype: Optional[torch.dtype] = None) -> Tensor:
    """``layer(v)`` computed in ``dtype``, as flax's ``nn.Dense(dtype=...)``:
    the input, the weight and the bias are cast at the call. A layer with
    hooks (``parallel.shard_params`` gathers a sharded layer's output in one)
    is called as a module on the cast parameters, so that they run."""
    if dtype is None:
        return layer(v)
    weight, bias = layer.weight.to(dtype), layer.bias.to(dtype)
    if layer._forward_hooks or layer._forward_pre_hooks:
        return torch.func.functional_call(layer, {"weight": weight, "bias": bias},
                                          (v.to(dtype),))
    return F.linear(v.to(dtype), weight, bias)


def remat_block(module: nn.Module, v: Tensor, remat: bool) -> Tensor:
    """``module(v)``; with ``remat``, and a graph being recorded, its
    intermediates are recomputed in the backward pass instead of kept
    (flax's ``nn.remat``)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(module, v, use_reentrant=False)
    return module(v)


class LayerNormnd(nn.Module):
    """GroupNorm(1, C) over all non-batch dims, channels-last."""

    def __init__(self, num_channels: int, epsilon: float = 1e-7):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, v: Tensor) -> Tensor:
        axes = tuple(range(1, v.ndim))
        mean = v.mean(dim=axes, keepdim=True)
        var = ((v - mean) ** 2).mean(dim=axes, keepdim=True)
        y = (v - mean) * torch.rsqrt(var + self.epsilon)
        return y * self.scale + self.bias


class PointwiseFFN(nn.Module):
    """Two-layer pointwise (1×1) FFN with channel expansion.

    A float32 or bfloat16 input goes through the fused FFN kernel (its plain
    version on the CPU), which keeps the weights and every sum in float32;
    float64 runs the same arithmetic as plain PyTorch, as no fp64 kernel
    exists. ``dtype`` is the computation dtype the input is cast to first
    (None: the input's own). ``reduce``, where ``parallel.shard_params`` sets
    it, sums the partial outputs of a model group's hidden units (Megatron's
    MLP): the layer then computes without its second bias, and the sum and
    the bias are taken in float32 (float64 rows: float64) before one cast to
    the rows' type.
    """

    reduce: Optional[Callable[[Tensor], Tensor]] = None

    def __init__(self, in_channels: int, out_channels: int, mid_channels: int,
                 activation: str = "ReLU", dtype: Optional[torch.dtype] = None):
        super().__init__()
        get_activation(activation)
        self.activation = activation
        self.dtype = dtype
        self.dense_0 = nn.Linear(in_channels, mid_channels)
        self.dense_1 = nn.Linear(mid_channels, out_channels)

    def forward(self, v: Tensor) -> Tensor:
        d0, d1 = self.dense_0, self.dense_1
        if self.dtype is not None:
            v = v.to(self.dtype)
        b2 = d1.bias if self.reduce is None else torch.zeros_like(d1.bias)
        if v.dtype in ffn_ops.ROW_DTYPES:
            out = ffn_ops.pointwise_ffn(
                v, d0.weight.float(), d0.bias.float(), d1.weight.float(),
                b2.float(), self.activation)
        else:
            out = F.linear(get_activation(self.activation)(d0(v)), d1.weight, b2)
        if self.reduce is None:
            return out
        total = self.reduce(out.to(torch.promote_types(out.dtype, torch.float32)))
        return (total + d1.bias.to(total.dtype)).to(out.dtype)


@functools.lru_cache(maxsize=None)
def _dft_fwd_c2c(n: int, m: int, t_offset: int = 0, length: int = None,
                 cdtype: str = "complex64"):
    """(2m, n) DFT rows for modes [0..m-1, -m..-1] sampled at positions
    t_offset..t_offset+n-1 of a length-`length` transform (host constant)."""
    length = n if length is None else length
    k = np.concatenate([np.arange(m), -np.arange(m, 0, -1)])
    x = t_offset + np.arange(n)
    return np.exp(-2j * np.pi * np.outer(k, x) / length).astype(cdtype)


@functools.lru_cache(maxsize=None)
def _dft_fwd_low(n: int, m: int, t_offset: int = 0, length: int = None,
                 cdtype: str = "complex64"):
    """(m, n) DFT rows for low modes 0..m-1 (the rfft'd axis)."""
    length = n if length is None else length
    k = np.arange(m)
    x = t_offset + np.arange(n)
    return np.exp(-2j * np.pi * np.outer(k, x) / length).astype(cdtype)


@functools.lru_cache(maxsize=None)
def _dft_inv_c2c(n_out: int, m: int, cdtype: str = "complex64"):
    """(n_out, 2m) inverse-DFT columns for signed modes [0..m-1, -m..-1]."""
    k = np.concatenate([np.arange(m), -np.arange(m, 0, -1)])
    x = np.arange(n_out)
    return np.exp(2j * np.pi * np.outer(x, k) / n_out).astype(cdtype)


@functools.lru_cache(maxsize=None)
def _dft_inv_low(length: int, m: int, keep_last: int, cdtype: str = "complex64"):
    """(keep_last, m) inverse rows reconstructing the LAST ``keep_last``
    positions of a length-`length` irfft from low modes 0..m-1, with the
    Hermitian multiplicities (1 at DC/Nyquist, 2 inside, 0 past Nyquist:
    irfftn's spectral truncation for short outputs)."""
    k = np.arange(m)
    c = np.full((m,), 2.0)
    c[0] = 1.0
    if length % 2 == 0 and m - 1 >= length // 2:
        c[length // 2] = 1.0
    c[k > length // 2] = 0.0
    t = np.arange(length - keep_last, length)
    return (c * np.exp(2j * np.pi * np.outer(t, k) / length)).astype(cdtype)


@functools.lru_cache(maxsize=64)
def _device_const(fn, args: tuple, device: str, scale: float = 1.0) -> Tensor:
    """A host DFT constant ``fn(*args)`` times ``scale``, as a tensor on ``device``."""
    a = np.asarray(fn(*args))
    return torch.from_numpy(np.ascontiguousarray(a * scale if scale != 1.0 else a)
                            ).to(device)


def spectral_weight_init(gain: float):
    """Uniform [0, gain) initializer (reference base.py:146-152)."""

    def init(t: Tensor, generator: Optional[torch.Generator] = None) -> Tensor:
        with torch.no_grad():
            return t.uniform_(0.0, gain, generator=generator)

    return init


def view_as_complex(w: Tensor) -> Tensor:
    """(..., 2) real pairs -> complex."""
    return torch.view_as_complex(w.contiguous())


def compact_blocks(blocks: Sequence[Tensor]) -> Tensor:
    """The 4 real-pair corner blocks as one complex (2mx, 2my, ...) array.

    Mode order matches the compact DFT matrices: x/y modes [0..m-1, -m..-1];
    block index is ix + 2*iy (reference sfno.py:374).
    """
    w = [view_as_complex(b) for b in blocks]
    low_x = torch.cat([w[0], w[2]], dim=1)
    high_x = torch.cat([w[1], w[3]], dim=1)
    return torch.cat([low_x, high_x], dim=0)


class SpectralConv(nn.Module):
    """N-D Fourier layer template: rfftn → mode-truncated matmul → irfftn.

    Weights are ``2**(dim-1)`` corner blocks ``weight_{i}``, real pairs
    ``(*modes, ci, co, 2)``; with ``bias``, ``bias_{i}`` ``(*modes, 2)``.
    Subclasses implement ``spectral_conv`` on the channels-last half
    spectrum ``(b, kx, ky, kt, c)``. ``mxu_precision`` is accepted for the
    JAX package's signature; every mode computes in fp32 (fp64 for fp64
    inputs).
    """

    def __init__(self, in_channels: int, out_channels: int,
                 modes: Tuple[int, ...], bias: bool = False,
                 norm: str = "backward", delta: float = 1.0, impl: str = "dft",
                 mxu_precision: str = "highest"):
        super().__init__()
        if impl not in ("dft", "fft"):
            raise ValueError(f"unknown impl {impl!r}")
        self.in_channels, self.out_channels = in_channels, out_channels
        self.modes = tuple(modes)
        self.bias = bias
        self.norm, self.delta, self.impl = norm, delta, impl
        self.mxu_precision = mxu_precision
        shape = (*self.modes, in_channels, out_channels, 2)
        for i in range(self.num_blocks):
            self.register_parameter(f"weight_{i}", nn.Parameter(torch.empty(shape)))
            if bias:
                self.register_parameter(
                    f"bias_{i}", nn.Parameter(torch.zeros((*self.modes, 2))))
        self.reset_parameters()

    @property
    def dim(self) -> int:
        return len(self.modes)

    @property
    def num_blocks(self) -> int:
        return 2 ** (self.dim - 1)

    def weights(self):
        return [getattr(self, f"weight_{i}") for i in range(self.num_blocks)]

    def biases(self):
        return [getattr(self, f"bias_{i}") for i in range(self.num_blocks)]

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        init = spectral_weight_init(0.5 / (self.in_channels * self.out_channels))
        for w in self.weights():
            init(w, generator)
        if self.bias:
            with torch.no_grad():
                for b in self.biases():
                    b.zero_()

    def compact_weight(self) -> Tensor:
        """The 4 corner blocks as one complex (2mx, 2my, mt, ci, co)."""
        return compact_blocks(self.weights())

    def compact_bias(self) -> Tensor:
        return compact_blocks(self.biases())

    def _dft_apply(
        self,
        v: Tensor,
        out_mesh_size: Optional[Sequence[int]] = None,
        t_pad: int = 0,
        keep_last: Optional[int] = None,
        postprocess=None,
        postprocess_mesh=None,
    ) -> Tensor:
        """Mode-truncated spectral conv as compact DFT einsums.

        rfftn → corner matmul (+bias) → (postprocess) → irfftn with the zero
        modes never materialized; the temporal zero-padding folds into the
        sample positions of the t matrices and the output sizes give the
        FFT-native super-resolution. Contraction order x→t→y forward and
        t→y→x inverse, as in the JAX package.
        """
        b, nx, ny, nt, ci = v.shape
        mx, my, mt = self.modes
        L_fwd = nt + t_pad
        # the FFT path can only touch modes that exist in the forward
        # half-spectrum (slice(0, mt) of kt = L_fwd//2+1)
        mt = min(mt, L_fwd // 2 + 1)
        if out_mesh_size is None:
            nx_out, ny_out, L_out = nx, ny, L_fwd
        else:
            nx_out, ny_out, L_out = out_mesh_size
        keep_last = L_out if keep_last is None else keep_last

        n_fwd = nx * ny * L_fwd
        n_out = nx_out * ny_out * L_out
        if self.norm == "backward":
            scale = 1.0 / n_out
        elif self.norm == "ortho":
            scale = 1.0 / (np.sqrt(n_fwd) * np.sqrt(n_out))
        elif self.norm == "forward":
            scale = 1.0 / n_fwd
        else:
            raise ValueError(f"unknown norm {self.norm}")

        cdtype = "complex128" if v.dtype == torch.float64 else "complex64"
        dev = str(v.device)
        Ft = _device_const(_dft_fwd_low, (nt, mt, t_pad, L_fwd, cdtype), dev)
        Fx = _device_const(_dft_fwd_c2c, (nx, mx, 0, None, cdtype), dev)
        Fy = _device_const(_dft_fwd_c2c, (ny, my, 0, None, cdtype), dev)
        h = torch.einsum("bxytc,Xx->bXytc", v.to(Ft.dtype), Fx)
        h = torch.einsum("bXytc,Tt->bXyTc", h, Ft)
        h = torch.einsum("bXyTc,Yy->bXYTc", h, Fy)

        w = self.compact_weight()[:, :, :mt]
        out_h = torch.einsum("bXYTi,XYTio->bXYTo", h, w.to(h.dtype))
        if self.bias:
            out_h = out_h + self.delta * self.compact_bias()[:, :, :mt, None]
        if postprocess is not None:
            out_h = postprocess(out_h, postprocess_mesh)

        Gx = _device_const(_dft_inv_c2c, (nx_out, mx, cdtype), dev)
        Gy = _device_const(_dft_inv_c2c, (ny_out, my, cdtype), dev)
        Gt = _device_const(_dft_inv_low, (L_out, mt, keep_last, cdtype), dev,
                           float(scale))
        out = torch.einsum("bXYTo,tT->bXYto", out_h, Gt)
        out = torch.einsum("bXYto,yY->bXyto", out, Gy)
        out = torch.einsum("bXyto,xX->bxyto", out, Gx)
        return out.real.to(v.dtype)

    @staticmethod
    def complex_matmul(x: Tensor, w: Tensor) -> Tensor:
        """(b, *modes, c_i) × (*modes, c_i, c_o) → (b, *modes, c_o)."""
        return torch.einsum("b...i,...io->b...o", x, w)

    def spectral_conv(self, vhat: Tensor, *fft_mesh_size: int) -> Tensor:
        raise NotImplementedError

    def forward(self, v: Tensor, out_mesh_size: Optional[Sequence[int]] = None
                ) -> Tensor:
        if v.dtype == torch.bfloat16:  # rfftn takes fp32/fp64 only
            return self.forward(v.float(), out_mesh_size).to(torch.bfloat16)
        mesh_size = v.shape[-self.dim - 1: -1]
        out_mesh_size = (tuple(mesh_size) if out_mesh_size is None
                         else tuple(out_mesh_size))
        fft_mesh_size = list(mesh_size)
        fft_mesh_size[-1] = mesh_size[-1] // 2 + 1
        axes = tuple(range(-self.dim - 1, -1))
        v_hat = torch.fft.rfftn(v, dim=axes, norm=self.norm)
        v_hat = self.spectral_conv(v_hat, *fft_mesh_size)
        return torch.fft.irfftn(v_hat, s=out_mesh_size, dim=axes, norm=self.norm)


def forward_with_latents(model: nn.Module, *args, **kwargs
                         ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """``model(*args, **kwargs)`` and its latents ``{name: tensor}``.

    The model names its tap points in ``latent_taps()``: ``{name: (module,
    where)}``, the input (``"input"``) or the output (``"output"``) of a
    submodule. A forward (pre-)hook on each records the first tensor it sees
    in this call, so a checkpointed block that runs again records once; the
    hooks are removed on return. The counterpart of the JAX package's
    ``apply_with_latents`` (its ``sow``n intermediates), as the reference
    taps with ``add_latent_hook``.
    """
    latents: Dict[str, Tensor] = {}

    def record(key: str, module, args, out=None) -> None:  # returns None: no change
        latents.setdefault(key, args[0] if out is None else out)

    handles = []
    for name, (module, where) in model.latent_taps().items():
        hook = functools.partial(record, name)
        handles.append(module.register_forward_pre_hook(hook) if where == "input"
                       else module.register_forward_hook(hook))
    try:
        out = model(*args, **kwargs)
    finally:
        for h in handles:
            h.remove()
    return out, latents


@torch.no_grad()
def init_like_flax(model: nn.Module, generator: Optional[torch.Generator] = None
                   ) -> nn.Module:
    """Draws every parameter from flax's initializer distributions.

    Dense kernels ``lecun_normal`` (truncated normal, std √(1/fan_in)/0.8796),
    Dense biases zeros, LayerNorm ones and zeros, spectral weights uniform
    [0, 0.5/(ci·co)) and spectral biases zeros, in module order from
    ``generator``.
    """
    for m in model.modules():
        if isinstance(m, nn.Linear):
            std = math.sqrt(1.0 / m.in_features) / _TRUNC_STD
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            nn.init.zeros_(m.bias)
        elif isinstance(m, LayerNormnd):
            nn.init.ones_(m.scale)
            nn.init.zeros_(m.bias)
        elif isinstance(m, SpectralConv):
            m.reset_parameters(generator)
    return model

"""The pseudo-spectral solver on a spectrum sharded on its rows (pencils).

The port's counterpart of what XLA does for ``jnp.fft`` on an array that
``tpu_cfd/parallel/mesh.py::shard_field_spatial`` sharded: each rank of the
``model`` group holds a slab of rows of the rfft2 half-spectrum
``(..., n / mp, n // 2 + 1)`` (``parallel.shard_field_spatial``), and
``NavierStokes2DSpectral.forward`` on such a field steps it here:

- ``irfft2``: the columns padded to a multiple of ``mp``, an all-to-all that
  gives each rank every row of ``(n//2 + 1) / mp`` columns, the inverse FFT
  along the rows, an all-to-all back to row slabs, the inverse real FFT
  along the rows' own axis: a physical slab ``(..., n / mp, n)``;
- ``rfft2``: the same in reverse;
- every precomputed spectral array (wavenumbers, Laplacian, dealiasing
  filter, a forcing's spectrum) sliced to the rank's rows; the stream
  function's guard at the zero mode lies on the first rank's first row;
- the composed explicit terms and IMEX update: the IMEX-spectral kernels
  (``ops/cuda/imex_spectral.py``) take whole spectra.

Complex tensors cross the all-to-all as real pairs. Only ``fft_impl="fft"``
takes a pencil field: the matmul layouts and the fused CUDA rollout work on
whole spectra (JAX's fused path, too, splits only the batch).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Shard

from tpu_cfd_torch.solvers.equations import NavierStokes2DSpectral

Tensor = torch.Tensor


def all_to_all(x: Tensor, group, split_dim: int, cat_dim: int) -> Tensor:
    """Splits ``x`` into equal chunks along ``split_dim``, sends chunk j to
    rank j of ``group`` and concatenates what arrives along ``cat_dim`` in
    rank order."""
    n = dist.get_world_size(group)
    send = torch.stack(torch.chunk(x, n, dim=split_dim))
    if send.is_complex():
        send = torch.view_as_real(send)
    send = send.contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    if x.is_complex():
        recv = torch.view_as_complex(recv)
    return torch.cat(recv.unbind(0), dim=cat_dim)


def _padded(m: int, n_ranks: int) -> int:
    return -(-m // n_ranks) * n_ranks


def irfft2(x: Tensor, n: int, group) -> Tensor:
    """``torch.fft.irfft2(·, s=(n, n))`` of a row slab ``(..., n/mp, n//2+1)``
    of the half-spectrum: the rank's physical rows ``(..., n/mp, n)``."""
    m = x.shape[-1]
    x = F.pad(x, (0, _padded(m, dist.get_world_size(group)) - m))
    cols = all_to_all(x, group, split_dim=-1, cat_dim=-2)        # (..., n, m_pad/mp)
    cols = torch.fft.ifft(cols, dim=-2)
    rows = all_to_all(cols, group, split_dim=-2, cat_dim=-1)     # (..., n/mp, m_pad)
    return torch.fft.irfft(rows[..., :m], n=n, dim=-1)


def rfft2(x: Tensor, group) -> Tensor:
    """``torch.fft.rfft2`` of a physical row slab ``(..., n/mp, n)``: the
    rank's rows of the half-spectrum ``(..., n/mp, n//2+1)``."""
    rows = torch.fft.rfft(x, dim=-1)
    m = rows.shape[-1]
    rows = F.pad(rows, (0, _padded(m, dist.get_world_size(group)) - m))
    cols = all_to_all(rows, group, split_dim=-1, cat_dim=-2)
    cols = torch.fft.fft(cols, dim=-2)
    return all_to_all(cols, group, split_dim=-2, cat_dim=-1)[..., :m]


class PencilEquation(NavierStokes2DSpectral):
    """``NavierStokes2DSpectral`` (``fft_impl="fft"``) on the rank's rows of
    its spectrum, for its stepper to march: the solver's own terms, with its
    spectral arrays sliced to the rows, the pencil FFT pair, and the
    zero-mode guard on the first rank only."""

    def __init__(self, ns: NavierStokes2DSpectral, group):
        self.__dict__.update(ns.__dict__)
        n_ranks, rank = dist.get_world_size(group), dist.get_rank(group)
        n = ns.grid.shape[-1]
        rows = slice(rank * n // n_ranks, (rank + 1) * n // n_ranks)
        self.group = group
        self.kx, self.ky = ns.kx[rows], ns.ky[rows]
        lap = ns.laplace[rows].clone()
        if rank == 0:  # the zero mode: mean-free vorticity, no division by 0
            lap[0, 0] = 1.0
        self.laplace_guarded = lap
        self.laplace, self.linear_term = ns.laplace[rows], ns.linear_term[rows]
        self.filter = None if ns.filter is None else ns.filter[rows]
        self._forcing_hat = ns._forcing_term()[rows] if ns.forcing_fn is not None else None

    def _kernel_takes(self, w: Tensor) -> bool:
        """A row slab steps on the composed path: the IMEX-spectral kernels
        take whole spectra."""
        return False

    def _stream(self, w: Tensor) -> Tensor:
        return -w / self.laplace_guarded

    def _irfft2(self, x: Tensor) -> Tensor:
        return irfft2(x, self.grid.shape[-1], self.group)

    def _rfft2(self, x: Tensor) -> Tensor:
        return rfft2(x, self.group)


def forward(ns, field: DTensor, dt: float, steps: int) -> Tuple[DTensor, DTensor]:
    """``ns.forward`` on a spectrum that ``shard_field_spatial`` sharded on
    its rows: (ŵ_new, ∂ŵ/∂t estimate), sharded as ``field``."""
    if ns.fused or ns.fft_impl != "fft":
        raise ValueError(
            f"a pencil-sharded field steps on fft_impl='fft' only, not "
            f"fft_impl={ns.fft_impl!r}{', fused' if ns.fused else ''}: the fused "
            "rollout and the matmul layouts take whole spectra (shard the batch "
            "with shard_batch instead)")
    mesh = field.device_mesh
    split = [(i, p.dim) for i, p in enumerate(field.placements) if isinstance(p, Shard)]
    if len(split) != 1 or split[0][1] != field.ndim - 2:
        raise ValueError(f"a pencil field is sharded on its rows (dim -2) over one mesh "
                         f"axis, not {field.placements}")
    eq = PencilEquation(ns, mesh.get_group(split[0][0]))
    w = w_old = field.to_local()
    for _ in range(steps):
        w = ns.solver(w, dt, eq)
    dwdt = 1 / (steps * dt) * (w - w_old)
    wrap = lambda t: DTensor.from_local(t, mesh, field.placements, run_check=False)  # noqa: E731
    return wrap(w), wrap(dwdt)

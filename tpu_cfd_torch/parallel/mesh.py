"""Device meshes and data parallelism over ``torch.distributed``.

Counterpart of ``tpu_cfd/parallel/mesh.py``. Where JAX lays one program over
a ``Mesh`` of devices and XLA inserts the collectives, the port runs one
process a card (``parallel.launch``) and each process holds its share: a
``DeviceMesh`` named ``("data", "model")`` over the process group (NCCL on
the card, gloo on the CPU), the rank's slice of each batch
(``shard_batch``), parameters broadcast from rank 0 (``replicate``) and
results gathered to rank 0 (``gather_batch``). The CLIs' gradient
all-reduce is ``DistributedDataParallel``'s; ``average_gradients`` is the
explicit one of a model whose parameters are sharded on ``model``.

Tensor parallelism: ``model_parallel`` ranks next to each other form a
``model`` group. ``sfno_param_spec`` places each SFNO or FNO3d parameter
(``Shard`` of its output channels, or ``Replicate``), and ``shard_params``
leaves each rank its shard and makes the model compute with it
(``parallel/tensor_parallel.py``). ``shard_field_spatial`` splits a solver
field's rows over ``model`` (pencil FFTs, ``parallel/pencil.py``).
"""

from __future__ import annotations

import re
from typing import Any, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.placement_types import Placement


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              axis_names: Tuple[str, str] = ("data", "model")) -> DeviceMesh:
    """A ``(world // model_parallel, model_parallel)`` mesh over the whole
    process group, named ``axis_names``. The model axis is the fast one:
    ranks ``d·mp … d·mp + mp - 1`` form one model group, as JAX's
    ``reshape(n // mp, mp)`` of the device list. The group must be up
    (``parallel.launch``, or ``torch.distributed.run``); ``n_devices``, where
    given, must be its size."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: launch through "
                           "tpu_cfd_torch.parallel.launch or torch.distributed.run")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"requested n_devices={n_devices} but the process "
                         f"group has {world} rank(s)")
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide {world} "
                         "devices")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (world // model_parallel, model_parallel),
                            mesh_dim_names=tuple(axis_names))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def _split(x, mesh: DeviceMesh, axis: str):
    n, r = axis_size(mesh, axis), mesh.get_local_rank(axis)
    if isinstance(x, torch.Tensor):
        return torch.tensor_split(x, n)[r]
    return np.array_split(np.asarray(x), n)[r]


def shard_batch(batch: Any, mesh: DeviceMesh, axis: str = "data") -> Any:
    """The rank's slice of the leading axis of a tensor, an array, or each
    entry of a dict of them: ``np.array_split`` over the ranks of ``axis``,
    so a rank may hold none."""
    if isinstance(batch, dict):
        return {k: _split(v, mesh, axis) for k, v in batch.items()}
    return _split(batch, mesh, axis)


def replicate(obj, mesh: DeviceMesh):
    """Broadcasts a tensor, or a module's parameters and buffers, from rank
    0 to every rank of the mesh, in place; returns ``obj``."""
    del mesh  # the mesh spans the whole process group (make_mesh)
    tensors = ([*obj.parameters(), *obj.buffers()] if isinstance(obj, nn.Module)
               else [obj])
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=0)
    return obj


def gather_batch(batch, mesh: DeviceMesh, dst: int = 0):
    """Host arrays (or a dict of them) from every rank, concatenated along
    the leading axis in rank order on rank ``dst``; None elsewhere. A rank
    that holds none passes None and still joins the collective."""
    del mesh  # the mesh spans the whole process group (make_mesh)
    parts = [None] * dist.get_world_size() if dist.get_rank() == dst else None
    dist.gather_object(batch, parts, dst=dst)
    if parts is None:
        return None
    parts = [p for p in parts if p is not None]
    if not parts:
        return None
    if isinstance(parts[0], dict):
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    return np.concatenate(parts)


def all_ranks(ok: bool, mesh: DeviceMesh) -> bool:
    """Whether ``ok`` holds on every rank: one all-reduce, so that all ranks
    take the same branch (a check that raises on one rank alone would leave
    the others waiting in their next collective)."""
    device = "cuda" if mesh.device_type == "cuda" else "cpu"
    flag = torch.tensor([int(bool(ok))], device=device)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return bool(flag.item())


def mean_over(t: torch.Tensor, mesh: DeviceMesh, axis: str = "data") -> torch.Tensor:
    """The mean of ``t`` over the ranks of ``axis`` (SUM then divide: gloo
    has no AVG), out of place."""
    t = t.detach().clone()
    dist.all_reduce(t, group=mesh.get_group(axis))
    return t / axis_size(mesh, axis)


def average_gradients(params: Iterable[torch.Tensor], mesh: DeviceMesh,
                      axis: str = "data") -> None:
    """Each gradient replaced by its mean over the ranks of ``axis``, in
    place: what DDP does, for a model DDP does not take (parameters sharded
    on ``model``). The gradients of one dtype go flat into one all-reduce, in
    the order given (the same on every rank); a parameter without a gradient
    joins with zeros."""
    group, n = mesh.get_group(axis), axis_size(mesh, axis)
    by_dtype: dict = {}
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        flat.div_(n)
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))


def sfno_layout(name: str, param: torch.Tensor, n_model: int) -> Placement:
    """Where the tensor-parallel SFNO or FNO3d splits ``param`` over
    ``n_model`` ranks, by the port's names (``convert.py``): JAX's rule
    (``tpu_cfd/parallel/mesh.py::sfno_param_spec``) in the port's layouts.

    - A spectral block ``weight_{i}`` ``(*modes, c_i, c_o, 2)``: ``Shard`` of
      ``c_o`` (dim −2) where ``n_model`` divides it.
    - An ``nn.Linear``: ``Shard(0)`` of ``weight`` ``(out, in)`` and of its
      bias where ``n_model`` divides ``out``. JAX shards the Dense kernel
      ``(in, out)`` on ``out`` and replicates the bias; the port shards the
      bias with its output channels, so that each rank adds its own. This
      covers FNO3d's lifting, skips and both layers of each ``MLP3d``
      (``mlps.{i}``, ``head``: column layout, as JAX's), so the head's
      ``dense_1`` (128 → 1) stays replicated.
    - A ``PointwiseFFN`` (``dense_0``, ``dense_1``), Megatron's MLP: ``dense_0``
      sharded on its output (the hidden units), ``dense_1``'s ``weight`` on its
      input (the same units, ``Shard(1)``) and its bias replicated, added once
      after the partial outputs are summed. JAX shards ``dense_1``'s output
      and gathers the weights for its unsplittable FFN kernel; here each rank
      runs the kernel on its hidden units.
    - Everything else is replicated: the LayerNorm (``norm``), the spectral
      biases, and the output conv (``out_conv``), whose Helmholtz projection
      mixes its output channels in mode space.
    """
    *owner, leaf = name.split(".")
    shape = tuple(param.shape)
    if not owner or owner[0] == "out_conv" or owner[-1] == "norm":
        return Replicate()
    if re.fullmatch(r"weight_\d+", leaf) and len(shape) >= 3:
        return Shard(len(shape) - 2) if shape[-2] % n_model == 0 else Replicate()
    if owner[-1] == "dense_1" and any(o.startswith("ffn") for o in owner):
        if leaf == "weight" and shape[1] % n_model == 0:
            return Shard(1)
        return Replicate()
    if leaf in ("weight", "bias") and shape[0] % n_model == 0:
        return Shard(0)
    return Replicate()


def sfno_param_spec(name: str, param: torch.Tensor, mesh: DeviceMesh) -> Placement:
    """The placement of an SFNO or FNO3d parameter on the ``model`` axis:
    ``Replicate()`` for every parameter where that axis has one rank, else
    ``sfno_layout``."""
    n_model = axis_size(mesh, "model")
    return Replicate() if n_model == 1 else sfno_layout(name, param, n_model)


def shard_params(model: nn.Module, mesh: DeviceMesh, spec_fn=sfno_param_spec) -> nn.Module:
    """Places ``model``'s parameters on the ``model`` axis by ``spec_fn(name,
    param, mesh)``, in place: each rank keeps only its shard of a sharded
    parameter, and the model computes with its shards (collectives over the
    model group, ``parallel/tensor_parallel.py``). Replicated parameters stay
    as they are. The SFNO and FNO3d are known (``tensor_parallel.MODELS``);
    another module raises ``TypeError``. Returns ``model``."""
    from tpu_cfd_torch.parallel import tensor_parallel

    return tensor_parallel.shard_model(model, mesh, spec_fn)


def sharded_parameters(model: nn.Module) -> dict:
    """``{name: DTensor}`` of a model that ``shard_params`` placed: each rank's
    tensor (no copy, no gradient) with its placement on the ``model`` axis.
    ``full_tensor()`` assembles a parameter on every rank."""
    mesh = model.tp_mesh["model"]
    return {name: DTensor.from_local(p.detach(), mesh, [model.tp_placements[name]],
                                     run_check=False)
            for name, p in model.named_parameters()}


def gather_parameters(model: nn.Module) -> dict:
    """The full ``state_dict``-shaped parameters of a model that
    ``shard_params`` placed, on every rank of its model group."""
    return {k: d.full_tensor() for k, d in sharded_parameters(model).items()}


def shard_field_spatial(field: torch.Tensor, mesh: DeviceMesh, spatial_axis: int = -2,
                        axis: str = "model") -> DTensor:
    """The rank's slab of ``field`` along ``spatial_axis`` over the mesh axis
    ``axis``, as a ``DTensor`` (``Shard`` there, ``Replicate`` on the other
    axes). A ``NavierStokes2DSpectral`` with ``fft_impl="fft"`` steps a
    spectrum sharded on its rows (``spatial_axis=-2``) by pencil FFTs
    (``parallel/pencil.py``)."""
    dim = spatial_axis % field.ndim
    n, r = axis_size(mesh, axis), mesh.get_local_rank(axis)
    if field.shape[dim] % n:
        raise ValueError(f"{n} ranks on {axis!r} do not divide axis {spatial_axis} of "
                         f"size {field.shape[dim]}")
    local = torch.chunk(field, n, dim=dim)[r].contiguous()
    placements = [Shard(dim) if a == axis else Replicate() for a in mesh.mesh_dim_names]
    return DTensor.from_local(local, mesh, placements, run_check=False)

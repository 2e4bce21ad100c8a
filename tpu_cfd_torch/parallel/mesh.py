"""Device meshes and data parallelism over ``torch.distributed``.

Counterpart of ``tpu_cfd/parallel/mesh.py``. Where JAX lays one program over
a ``Mesh`` of devices and XLA inserts the collectives, the port runs one
process a card (``parallel.launch``) and each process holds its share: a
``DeviceMesh`` named ``("data", "model")`` over the process group (NCCL on
the card, gloo on the CPU), the rank's slice of each batch
(``shard_batch``), parameters broadcast from rank 0 (``replicate``) and
results gathered to rank 0 (``gather_batch``). The gradient all-reduce is
``DistributedDataParallel``'s.

Tensor parallelism (``model_parallel > 1``, ``sfno_param_spec``,
``shard_params``) and ``shard_field_spatial`` wait for ROADMAP.md Queue A
item 7 and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

_QUEUE_A_7 = ("waits for ROADMAP.md Queue A item 7 (tensor parallelism on "
              "DTensor); not ported to PyTorch yet")


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              axis_names: Tuple[str, str] = ("data", "model")) -> DeviceMesh:
    """A (data, model) mesh over the whole process group: every rank on the
    data axis. The group must be up (``parallel.launch``, or
    ``torch.distributed.run``); ``n_devices``, where given, must be its size."""
    if model_parallel != 1:
        raise NotImplementedError(f"model_parallel={model_parallel}: {_QUEUE_A_7}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: launch through "
                           "tpu_cfd_torch.parallel.launch or torch.distributed.run")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"requested n_devices={n_devices} but the process "
                         f"group has {world} rank(s)")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (world, 1), mesh_dim_names=tuple(axis_names))


def _split(x, mesh: DeviceMesh, axis: str):
    n, r = mesh.size(mesh.mesh_dim_names.index(axis)), mesh.get_local_rank(axis)
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


def sfno_param_spec(*args, **kwargs):
    """Tensor-parallel placement of SFNO/FNO parameters: not ported."""
    raise NotImplementedError(f"sfno_param_spec {_QUEUE_A_7}")


def shard_params(*args, **kwargs):
    """Places parameters on the mesh by ``sfno_param_spec``: not ported."""
    raise NotImplementedError(f"shard_params {_QUEUE_A_7}")


def shard_field_spatial(*args, **kwargs):
    """Shards a spatial axis of a solver field (pencil FFTs): not ported."""
    raise NotImplementedError(f"shard_field_spatial {_QUEUE_A_7}")

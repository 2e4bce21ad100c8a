"""Tensor parallelism of the SFNO and of FNO3d over the ``model`` axis of a mesh.

The port's counterpart of what XLA does for ``tpu_cfd``'s sharded SFNO and
FNO3d parameters (``tpu_cfd/parallel/mesh.py::shard_params``): JAX places
the arrays and XLA inserts the collectives; here each rank keeps its shard
of a parameter (``shard_model``, through ``parallel.shard_params``) and the
layers that hold shards run their collectives over the model group:

- a spectral conv (``SpectralConvS``, ``SpectralConvT``, ``SpectralConv3d``)
  or an ``nn.Linear`` sharded on its output channels takes its replicated input
  through ``copy_to_model``, computes its channels with its own forward
  (the DFT kernel pair, ``torch.fft`` or the einsums, by the route its local
  shape names) and ``gather_channels`` assembles the output. FNO3d's layers
  are all of this kind: its ``MLP3d`` is two such ``nn.Linear``, each
  sharded on its output as in JAX, since no kernel runs on its hidden units;
- a ``PointwiseFFN`` is Megatron's MLP: each rank runs the fused FFN kernel
  on its hidden units, ``reduce_partial`` sums the partial outputs in
  float32, and the second bias is added once, after the sum (with bfloat16
  rows the output is rounded twice: each rank's partial by the kernel, the
  sum once more, where the unsharded kernel rounds once);
- the LayerNorm, the positional encoding, the activations, FNO3d's padding
  and everything between the sharded layers run replicated on every rank of
  the group.

So every rank of a model group holds the same activations and the same
gradients of its replicated parameters. The data axis is not DDP's (DDP
takes no parameters of differing shapes a rank): a train step averages the
gradients over ``data`` after ``backward`` (``parallel.average_gradients``).
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import Replicate, Shard

from tpu_cfd_torch.models.base import PointwiseFFN, SpectralConv
from tpu_cfd_torch.models.fno3d import FNO3d
from tpu_cfd_torch.models.sfno import SFNO
from tpu_cfd_torch.parallel.mesh import axis_size

Tensor = torch.Tensor
# the models whose layers shard_model knows
MODELS = (SFNO, FNO3d)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherChannels(torch.autograd.Function):
    """All-gather along the last axis in group-rank order; the backward
    keeps the rank's slice."""

    @staticmethod
    def forward(ctx, x, group):
        n = dist.get_world_size(group)
        ctx.rank, ctx.n = dist.get_rank(group), n
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return torch.chunk(g, ctx.n, dim=-1)[ctx.rank].contiguous(), None


class _ReducePartial(torch.autograd.Function):
    """All-reduce (sum) forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: Tensor, group) -> Tensor:
    return _CopyToModel.apply(x, group)


def gather_channels(x: Tensor, group) -> Tensor:
    return _GatherChannels.apply(x, group)


def reduce_partial(x: Tensor, group) -> Tensor:
    return _ReducePartial.apply(x, group)


def _column_parallel(module: nn.Module, group) -> None:
    """The module computes its output channels on its replicated input, and
    the channels of the group are gathered after it."""
    module.register_forward_pre_hook(
        lambda m, args: (copy_to_model(args[0], group), *args[1:]))
    module.register_forward_hook(lambda m, args, out: gather_channels(out, group))


def _megatron(ffn: PointwiseFFN, group) -> None:
    """The FFN computes on the rank's hidden units, its replicated input
    copied into the group, and its partial outputs summed over the group
    (``PointwiseFFN.reduce``) before its second bias."""
    ffn.register_forward_pre_hook(
        lambda m, args: (copy_to_model(args[0], group), *args[1:]))
    ffn.reduce = functools.partial(reduce_partial, group=group)


def _ffn_sharded(p: dict, n: int) -> bool:
    """Whether a PointwiseFFN's placements are Megatron's (True) or all
    replicated (False); anything else raises."""
    megatron = {"dense_0.weight": Shard(0), "dense_0.bias": Shard(0),
                "dense_1.weight": Shard(1), "dense_1.bias": Replicate()}
    if all(isinstance(v, Replicate) for v in p.values()):
        return False
    if p == megatron:
        return True
    raise ValueError(f"shard_params: a PointwiseFFN computes sharded as {megatron} or "
                     f"replicated, not {p}")


def _column_sharded(p: dict, dims: dict) -> bool:
    """Whether a layer's placements shard its output channels (``dims``:
    each parameter's output-channel axis, None for one replicated with
    them), all replicated (False), or anything else (raises)."""
    if all(isinstance(v, Replicate) for v in p.values()):
        return False
    want = {k: Replicate() if d is None else Shard(d) for k, d in dims.items()}
    if p == want:
        return True
    raise ValueError(f"shard_params: this layer computes sharded as {want} or "
                     f"replicated, not {p}")


def shard_model(model: nn.Module, mesh, spec_fn) -> nn.Module:
    """``parallel.shard_params`` for the SFNO and FNO3d: places each
    parameter by ``spec_fn(name, param, mesh)``, keeps the rank's shard of
    each sharded one, and sets up each sharded layer's collectives (module
    docstring). A layer may stay replicated beside sharded ones (FNO3d of
    width 10 on a model axis of 4 shards only its head's hidden units).
    Records the placements in ``model.tp_placements`` and the mesh in
    ``model.tp_mesh``."""
    if not isinstance(model, MODELS):
        raise TypeError(
            f"shard_params knows the layers of {', '.join(m.__name__ for m in MODELS)}, "
            f"not {type(model).__name__}'s")
    if getattr(model, "tp_mesh", None) is not None:
        raise ValueError("shard_params: the model is sharded already")
    n, r = axis_size(mesh, "model"), mesh.get_local_rank("model")
    group = mesh.get_group("model")
    params = dict(model.named_parameters())
    placements = {k: spec_fn(k, p, mesh) for k, p in params.items()}
    for k, pl in placements.items():
        if isinstance(pl, Shard) and params[k].shape[pl.dim] % n:
            raise ValueError(f"shard_params: {n} ranks do not divide dim {pl.dim} of {k} "
                             f"{tuple(params[k].shape)}")

    def own(prefix: str, module: nn.Module) -> dict:
        return {k: placements[prefix + k] for k, _ in module.named_parameters()}

    placed = set()
    for name, module in model.named_modules():
        prefix = name + "." if name else ""
        if any(prefix.startswith(q) for q in placed):
            continue
        p = own(prefix, module)
        if isinstance(module, PointwiseFFN):
            placed.add(prefix)
            if _ffn_sharded(p, n):
                _megatron(module, group)
        elif isinstance(module, SpectralConv):
            placed.add(prefix)
            dims = {k: (w.ndim - 2 if k.startswith("weight_") else None)
                    for k, w in module.named_parameters()}
            if _column_sharded(p, dims):
                if module.bias:
                    raise ValueError(f"shard_params: {name} has a spectral bias, which "
                                     "would need its gradient summed over the group")
                module.out_channels //= n
                _column_parallel(module, group)
        elif isinstance(module, nn.Linear):
            placed.add(prefix)
            if _column_sharded(p, {"weight": 0, "bias": 0}):
                module.out_features //= n
                _column_parallel(module, group)
        elif list(module.parameters(recurse=False)):
            local = {k: v for k, v in p.items() if "." not in k}
            if not all(isinstance(v, Replicate) for v in local.values()):
                raise ValueError(f"shard_params: {name} ({type(module).__name__}) computes "
                                 f"replicated only, not {local}")
    with torch.no_grad():
        for k, pl in placements.items():
            if isinstance(pl, Shard):
                params[k].data = torch.chunk(params[k].data, n, dim=pl.dim)[r].contiguous()
    model.tp_mesh, model.tp_placements = mesh, placements
    return model

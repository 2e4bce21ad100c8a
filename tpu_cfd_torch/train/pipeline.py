"""Training/eval pipeline: train step, eval loop, device-resident epochs, checkpoints.

Counterpart of ``tpu_cfd/train/pipeline.py``. The jitted optax step becomes
forward → loss → backward → (clip) → ``torch.optim`` step → schedule step.
The device-resident epoch (counterpart of ``make_scan_epoch`` and
``make_scan_eval``) puts the dataset on the card once, gathers each batch's
windows there from ``(idx, starts)`` arrays, and keeps the losses on the
card until one synchronisation per epoch. Checkpoints are ``torch.save`` of
the ``state_dict``.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Optional

import numpy as np
import torch

from tpu_cfd_torch.utils.profiling import trace_annotation

Tensor = torch.Tensor

SRC_ROOT = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(SRC_ROOT))
# run artifacts default to the repo-root models/, logs/, data/ and figures/
MODEL_PATH = os.environ.get("MODEL_PATH", os.path.join(ROOT, "models"))
LOG_PATH = os.environ.get("LOG_PATH", os.path.join(ROOT, "logs"))
DATA_PATH = os.environ.get("DATA_PATH", os.path.join(ROOT, "data"))
FIG_PATH = os.environ.get("FIG_PATH", os.path.join(ROOT, "figures"))


def ensure_paths():
    for p in (MODEL_PATH, LOG_PATH, DATA_PATH, FIG_PATH):
        os.makedirs(p, exist_ok=True)


class Lion(torch.optim.Optimizer):
    """``optax.lion`` with its defaults, as plain tensor ops.

    ``p <- p - lr (sign((1 - b1) g + b1 m) + weight_decay p)``, then
    ``m <- b2 m + (1 - b2) g`` (Chen et al., "Symbolic Discovery of
    Optimization Algorithms", 2023).
    """

    def __init__(self, params, lr: float = 1e-3, b1: float = 0.9,
                 b2: float = 0.99, weight_decay: float = 1e-3):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["b1"], group["b2"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if "exp_avg" not in state:
                    state["exp_avg"] = torch.zeros_like(p)
                m, g = state["exp_avg"], p.grad
                update = torch.sign((1.0 - b1) * g + b1 * m)
                m.mul_(b2).add_(g, alpha=1.0 - b2)
                p.add_(update + group["weight_decay"] * p, alpha=-group["lr"])
        return loss


def get_optimizer(name: str, params, learning_rate: float = 1e-3
                  ) -> torch.optim.Optimizer:
    """The optimizer by the reference's names, with optax's defaults."""
    name = name.lower()
    if name == "lion":
        return Lion(params, lr=learning_rate)
    if name == "adam":
        return torch.optim.Adam(params, lr=learning_rate)
    if name == "adamw":
        # optax.adamw's default weight decay
        return torch.optim.AdamW(params, lr=learning_rate, weight_decay=1e-4)
    if name == "sgd":
        return torch.optim.SGD(params, lr=learning_rate)
    raise ValueError(f"unknown optimizer {name}; available: "
                     f"['adam', 'adamw', 'lion', 'sgd']")


def onecycle_lr(optimizer: torch.optim.Optimizer, max_lr: float,
                steps_per_epoch: int, epochs: int, div_factor: float = 1e3,
                final_div_factor: float = 1e4) -> torch.optim.lr_scheduler.LambdaLR:
    """optax's ``cosine_onecycle_schedule`` as a ``LambdaLR`` on ``max_lr``.

    Cosine from max_lr/div_factor up to max_lr over the first 30 % of the
    steps, then down to max_lr/(div_factor·final_div_factor). Fewer than 5
    steps in all keep max_lr constant (the optax schedule has collapsed
    phases there). Step the scheduler once after each optimizer step.
    """
    total = steps_per_epoch * epochs
    for group in optimizer.param_groups:
        group["lr"] = group["initial_lr"] = max_lr
    if total < 5:
        return torch.optim.lr_scheduler.LambdaLR(optimizer, lambda step: 1.0)
    bounds = (0, int(0.3 * total), int(total))
    values = np.cumprod([max_lr / div_factor, div_factor,
                         1.0 / (div_factor * final_div_factor)])

    def schedule(step: int) -> float:
        for i in range(2):
            if bounds[i] <= step < bounds[i + 1]:
                pct = (step - bounds[i]) / (bounds[i + 1] - bounds[i])
                start, end = values[i], values[i + 1]
                return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1)
        return values[-1]

    return torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda step: schedule(step) / max_lr)


def make_train_step(model: torch.nn.Module, loss_fn: Callable,
                    optimizer: torch.optim.Optimizer, scheduler=None,
                    grad_clip: float = 0.0):
    """Returns ``step(inp, target) -> loss`` (a 0-d tensor; no host sync).

    Spans (``utils.trace_annotation``): ``train.step`` around the step,
    holding ``train.forward`` (model and loss), ``train.backward`` (autograd
    launches the backward's kernels from its own thread while this span is
    open) and ``train.optimizer`` (clipping, optimizer and schedule)."""

    def step(inp: Tensor, target: Tensor) -> Tensor:
        with trace_annotation("train.step"):
            optimizer.zero_grad(set_to_none=True)
            with trace_annotation("train.forward"):
                loss = loss_fn(model(inp), target)
            with trace_annotation("train.backward"):
                loss.backward()
            with trace_annotation("train.optimizer"):
                if grad_clip and grad_clip > 0:
                    torch.nn.utils.clip_grad_norm_(model.parameters(), grad_clip)
                optimizer.step()
                if scheduler is not None:
                    scheduler.step()
            return loss.detach()

    return step


def make_eval_step(model: torch.nn.Module, metric_fn: Callable,
                   out_steps: Optional[int] = None):
    """Returns ``step(inp, target) -> metric`` under ``torch.no_grad``, in a
    ``train.eval`` span."""

    @torch.no_grad()
    def step(inp: Tensor, target: Tensor) -> Tensor:
        with trace_annotation("train.eval"):
            return metric_fn(model(inp, out_steps=out_steps), target)

    return step


def eval_epoch(eval_step, dataset, batch_size: int, device,
               field: str = "vorticity",
               rng: Optional[np.random.Generator] = None, mesh=None) -> float:
    """Eval over a dataset, host-sliced batches (one sync per batch). With a
    ``mesh``, each rank evaluates its slice of each batch and the mean is
    reduced over the ranks."""
    rng = np.random.default_rng(0) if rng is None else rng
    metrics = []
    for inp, out in dataset.batches(batch_size, rng, shuffle=False):
        a, u = (shard_host(x[field], mesh) for x in (inp, out))
        metrics.append(float(eval_step(torch.from_numpy(a).to(device),
                                       torch.from_numpy(u).to(device))))
    if not metrics:
        raise ValueError(f"eval dataset yielded no batches (n={len(dataset)}, "
                         f"batch_size={batch_size})")
    mean = float(np.mean(metrics))
    if mesh is not None:
        mean = float(mean_over_ranks(torch.tensor(mean, dtype=torch.float64,
                                                   device=device)))
    return mean


def shard_host(x: np.ndarray, mesh) -> np.ndarray:
    """``x``, or with a mesh the rank's slice of its leading axis."""
    if mesh is None:
        return x
    from tpu_cfd_torch.parallel import shard_batch

    return np.ascontiguousarray(shard_batch(x, mesh))


def _window_gather(data: Tensor, steps: int, out_steps: int):
    """On-card counterpart of ``SpatioTemporalDataset.sample_at``."""
    window = torch.arange(steps + out_steps, device=data.device)

    def gather(idx: Tensor, starts: Tensor):
        batch = data[idx]                                          # (b, n, n, T)
        t = (starts[:, None] + window)[:, None, None, :]
        win = torch.take_along_dim(batch, t, dim=-1)
        return win[..., :steps], win[..., steps:]

    return gather


def _epoch_arrays(idx: np.ndarray, starts: np.ndarray, device, mesh):
    """The epoch's ``(n_batches, batch)`` arrays on ``device``; with a mesh,
    the rank's columns: its slice of every global batch."""
    idx, starts = (np.asarray(a, dtype=np.int64) for a in (idx, starts))
    if mesh is not None:
        from tpu_cfd_torch.parallel import shard_batch

        idx, starts = (shard_batch(a.T, mesh).T for a in (idx, starts))
    return (torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (idx, starts))


def mean_over_ranks(t: Tensor) -> Tensor:
    """The mean of ``t`` over the ranks (SUM then divide: gloo has no AVG)."""
    import torch.distributed as dist

    dist.all_reduce(t)
    return t / dist.get_world_size()


def make_device_epoch(model, loss_fn: Callable, optimizer, data: Tensor,
                      steps: int, out_steps: int, scheduler=None,
                      grad_clip: float = 0.0, mesh=None):
    """One training epoch over card-resident ``data`` ``(N, n, n, T)``.

    Returns ``run(idx, starts) -> losses``: ``idx`` and ``starts`` are the
    epoch's ``(n_batches, batch)`` arrays (``epoch_indices``), and the
    per-step losses come back as one tensor on the card. With a ``mesh``
    (data parallelism, the model wrapped in ``DistributedDataParallel``),
    every rank is given the same arrays, gathers its slice of each batch,
    and the losses come back as their mean over the ranks: the global
    batch's mean where the batch divides evenly. Each step's window gather
    is a ``train.gather`` span.
    """
    gather = _window_gather(data, steps, out_steps)
    step = make_train_step(model, loss_fn, optimizer, scheduler, grad_clip)

    def gathered(i: Tensor, s: Tensor):
        with trace_annotation("train.gather"):
            return gather(i, s)

    def run(idx: np.ndarray, starts: np.ndarray) -> Tensor:
        idx_d, starts_d = _epoch_arrays(idx, starts, data.device, mesh)
        # a step's windows are freed as it returns, before the next gather
        losses = [step(*gathered(i, s)) for i, s in zip(idx_d, starts_d)]
        losses = torch.stack(losses) if losses else data.new_zeros((0,))
        return losses if mesh is None else mean_over_ranks(losses)

    return run


def make_device_eval(model, metric_fn: Callable, data: Tensor, steps: int,
                     out_steps: int, model_out_steps: Optional[int] = None,
                     mesh=None):
    """Whole-set eval over card-resident ``data``: ``run(idx, starts) -> mean``
    of the batches' metrics. With a ``mesh``, each rank takes its slice of
    each batch and the sum of the metrics is reduced over the ranks."""
    gather = _window_gather(data, steps, out_steps)
    step = make_eval_step(model, metric_fn, model_out_steps)

    def run(idx: np.ndarray, starts: np.ndarray) -> Tensor:
        idx_d, starts_d = _epoch_arrays(idx, starts, data.device, mesh)
        metrics = torch.stack([step(*gather(i, s)) for i, s in zip(idx_d, starts_d)])
        return metrics.mean() if mesh is None else mean_over_ranks(metrics.mean())

    return run


def save_checkpoint(model: torch.nn.Module, path: os.PathLike) -> str:
    """Saves ``model.state_dict()`` to ``<path>.pt``; returns the file name."""
    path = os.fspath(path) + ".pt"
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, path)
    return path


def load_checkpoint(path: os.PathLike, model: torch.nn.Module) -> torch.nn.Module:
    """Loads a checkpoint of :func:`save_checkpoint` into ``model`` in place."""
    state = torch.load(os.fspath(path) + ".pt", map_location="cpu", weights_only=True)
    model.load_state_dict(state)
    return model

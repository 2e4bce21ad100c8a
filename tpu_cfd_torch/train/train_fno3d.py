"""FNO3d baseline training with dataset normalization (PyTorch).

Counterpart of ``examples/ex2_fno3d_train.py``, with the same flags plus
``--no-cuda`` and ``--out-steps``: a fixed-window dataset (``--t-start``,
spatial Gaussian normalizer) or an FNO-paper-format file (``--mat-file``,
field ``u`` shaped ``(N, n, n, T)``), ``FNO3d(modes, modes, modes_t, width,
input_channel=T)`` on ``--time-steps`` (T) input frames and ``--out-steps``
output frames (by default T), the relative Sobolev loss of order 0 on
denormalised fields, and Adam on the one-cycle schedule
(``div_factor=1e4``, ``final_div_factor=1e3``). As in the example, each
fixed-window set is normalised with its own statistics when it is built,
and the loss denormalises both with the **train** statistics; the
``--mat-file`` test inputs are normalised with the train normalizer.

The FNO3d input is the input frames broadcast along the output time axis
plus the (x, y, t) grid channels. Both dataset kinds have static windows, so
all of them live on the device and an epoch takes a permutation: no
per-batch host slicing, and one synchronisation an epoch. Eval runs one
sample at a time; on the card the whole test pass is one CUDA graph,
replayed each epoch (the same kernels, so the same numbers): launched op
by op, a sample's ~100 small kernels take the host longer than the card.
It runs on the card unless ``--no-cuda`` is given.

``build`` makes the model, the optimizer, the schedule, the loss and the
train step from the arguments; ``epoch_order``, ``train_epoch`` and
``evaluate`` are an epoch's batches, steps and test pass. ``main`` and the
benchmark (``benchmark/drivers/train_fno3d.py``) both run these. An
``fno3d.input`` span (``utils.trace_annotation``) covers each train step's
input building.

Run (after generating the McWilliams dataset):
  python -m tpu_cfd_torch.train.train_fno3d --epochs 10 --num-samples 1024
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Callable, Optional

import numpy as np
import torch

from tpu_cfd_torch.data.datasets import (
    NavierStokesDataset,
    SpatioTemporalDatasetFixedTime,
)
from tpu_cfd_torch.device import resolve_device
from tpu_cfd_torch.models import FNO3d, init_like_flax, make_fno3d_input, num_parameters
from tpu_cfd_torch.train import losses, pipeline
from tpu_cfd_torch.utils.profiling import trace_annotation

Tensor = torch.Tensor

FIELD = "vorticity"


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train the FNO3d baseline (PyTorch port)")
    p.add_argument("--data-file", type=str, default=None)
    p.add_argument("--mat-file", type=str, default=None,
                   help="train on an FNO-paper-format .mat/.pt/.npz file (field "
                        "'u', shape (N, n, n, T)) via NavierStokesDataset "
                        "instead of the trajectory format")
    p.add_argument("--num-samples", type=int, default=1024)
    p.add_argument("--num-test-samples", type=int, default=32)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--modes", type=int, default=32)
    p.add_argument("--modes-t", type=int, default=5)
    p.add_argument("--width", type=int, default=10)
    p.add_argument("--time-steps", type=int, default=10, help="input frames")
    p.add_argument("--out-steps", type=int, default=None,
                   help="output frames (default: --time-steps)")
    p.add_argument("--t-start", type=int, default=10)
    p.add_argument("--res", type=int, default=64)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--no-cuda", default=False, action="store_true",
                   help="run on the CPU")
    return p


def to_device(x: np.ndarray, device) -> Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)


def out_steps(args) -> int:
    return args.time_steps if args.out_steps is None else args.out_steps


def load_windows(args, mat: Optional[np.ndarray] = None):
    """The static (input, target) windows of the train and the test set as
    numpy arrays, and the normalizer of the targets (None for raw targets).
    ``mat``, an ``(N, n, n, T)`` array, stands in for ``--mat-file``'s."""
    T_in, T_out = args.time_steps, out_steps(args)
    if mat is not None or args.mat_file:
        # FNO-paper workflow: inputs normalized with the train normalizer,
        # targets raw frames
        source = args.mat_file if mat is None else mat
        train_ds = NavierStokesDataset(
            source, n_samples=args.num_samples, time_steps_input=T_in,
            time_steps_output=T_out, normalize=True)
        test_ds = NavierStokesDataset(
            source, n_samples=args.num_test_samples, train=False,
            time_steps_input=T_in, time_steps_output=T_out, normalize=False)
        test_a = train_ds.normalizer.transform(test_ds.a)
        return (train_ds.a, train_ds.u), (test_a, test_ds.u), None
    data_path = args.data_file or os.path.join(
        pipeline.DATA_PATH, "McWilliams2d_64x64_N1152_v1e-3_T10_steps100.npz")
    kw = dict(fields=[FIELD], steps=T_in, out_steps=T_out, T_start=args.t_start)
    train_ds = SpatioTemporalDatasetFixedTime(
        data_path, n_samples=args.num_samples, **kw)
    test_ds = SpatioTemporalDatasetFixedTime(
        data_path, n_samples=args.num_test_samples, train=False, **kw)
    # the loss denormalises with the train statistics, on the test set too
    normalizer = train_ds.normalizers[FIELD]
    if train_ds.total_steps < args.t_start + T_in + T_out:
        raise ValueError(
            f"{data_path} holds {train_ds.total_steps} records, fewer than "
            f"--t-start {args.t_start} plus {T_in} input and {T_out} output steps")
    windows = []
    for ds in (train_ds, test_ds):
        inp, out = ds.sample(np.arange(len(ds)))
        windows.append((inp[FIELD], out[FIELD]))
    return windows[0], windows[1], normalizer


@dataclasses.dataclass
class Built:
    """What ``build`` makes: ``step(inp, target)`` is one optimizer step
    (``pipeline.make_train_step``) and ``loss_fn(model_out, target)`` the
    relative Sobolev loss on denormalised fields."""
    model: FNO3d
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    loss_fn: Callable
    step: Callable
    steps_per_epoch: int
    out_steps: int
    test_graph: Optional["GraphedTestPass"] = None


def build(args, n_train: int, normalizer=None, device=None) -> Built:
    """The model (``init_like_flax`` from ``--seed``), Adam on the one-cycle
    schedule over ``--epochs`` epochs of ``n_train // --batch-size`` steps,
    the loss and the train step, on ``device``."""
    model = FNO3d(args.modes, args.modes, args.modes_t, width=args.width,
                  input_channel=args.time_steps)
    init_like_flax(model, torch.Generator().manual_seed(args.seed))
    model.to(device)
    nb = max(1, n_train // args.batch_size)
    optimizer = pipeline.get_optimizer("Adam", model.parameters(), args.lr)
    scheduler = pipeline.onecycle_lr(optimizer, args.lr, nb, args.epochs,
                                     div_factor=1e4, final_div_factor=1e3)
    sobolev = losses.SobolevLoss(n_grid=args.res, norm_order=0, relative=True)

    if normalizer is not None:
        # SpatialGaussianNormalizer's statistics are per (x, y) location
        mean = to_device(normalizer.mean, device)
        std = to_device(normalizer.std, device) + normalizer.eps

        def denorm(u):
            return u * std + mean
    else:
        def denorm(u):  # .mat targets are raw solution frames
            return u

    def loss_fn(out, u):
        return sobolev(denorm(out[0]), denorm(u))

    step = pipeline.make_train_step(model, loss_fn, optimizer, scheduler)
    return Built(model, optimizer, scheduler, loss_fn, step, nb, out_steps(args))


def epoch_order(rng: np.random.Generator, n_train: int, batch_size: int,
                device) -> Tensor:
    """One epoch's sample indices, ``(n_train // batch_size, batch_size)``:
    one permutation, from the same rng stream as a host loop."""
    nb = max(1, n_train // batch_size)
    order = rng.permutation(n_train)[: nb * batch_size]
    return torch.from_numpy(order.reshape(nb, batch_size)).to(device)


def train_epoch(built: Built, A: Tensor, U: Tensor, order: Tensor) -> Tensor:
    """A train step on each row of ``order``; the steps' losses, on the
    device (no host sync)."""
    built.model.train()
    step_losses = []
    for idx in order:
        with trace_annotation("fno3d.input"):
            inp = make_fno3d_input(A[idx], built.out_steps)
        step_losses.append(built.step(inp, U[idx]))
    return torch.stack(step_losses)


def sample_loss(built: Built, a: Tensor, u: Tensor) -> Tensor:
    return built.loss_fn(built.model(make_fno3d_input(a, built.out_steps)), u)


class GraphedTestPass:
    """The test pass as one CUDA graph: each sample's ``sample_loss``, one at
    a time, and their mean, captured on ``At`` and ``Ut`` where they live
    after two eager calls on a side stream (which make the FFT plans, the
    loss's weights and the allocator's blocks). The model's parameters are
    read in place, so a replay follows the optimizer's updates. A replay
    opens no span and moves no counter of the model."""

    def __init__(self, built: Built, At: Tensor, Ut: Tensor):
        self.key = _test_key(At, Ut)
        current = torch.cuda.current_stream(At.device)
        side = torch.cuda.Stream(At.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for _ in range(2):
                sample_loss(built, At[:1], Ut[:1])
        current.wait_stream(side)
        self.losses = At.new_empty(At.shape[0])
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            for i in range(At.shape[0]):
                self.losses[i] = sample_loss(built, At[i:i + 1], Ut[i:i + 1])
            self.mean = self.losses.mean()

    def __call__(self) -> Tensor:
        self.graph.replay()
        return self.mean.clone()


def _test_key(At: Tensor, Ut: Tensor) -> tuple:
    return tuple((x.data_ptr(), x.shape, x.stride(), x.dtype, x.device) for x in (At, Ut))


@torch.no_grad()
def evaluate(built: Built, At: Tensor, Ut: Tensor) -> Tensor:
    """The test loss, one sample at a time; the mean, on the device. On the
    card the pass replays ``built.test_graph`` (captured at the first call
    on these tensors), elsewhere it runs eagerly."""
    built.model.eval()
    if not At.is_cuda:
        return torch.stack([sample_loss(built, At[i:i + 1], Ut[i:i + 1])
                            for i in range(At.shape[0])]).mean()
    if built.test_graph is None or built.test_graph.key != _test_key(At, Ut):
        built.test_graph = GraphedTestPass(built, At, Ut)
    return built.test_graph()


def main(argv=None) -> dict:
    """Runs the CLI; returns ``{"model", "n_params", "history", "test"}``."""
    args = get_parser().parse_args(argv)
    device = resolve_device("cpu" if args.no_cuda else None)
    (a_np, u_np), (at_np, ut_np), normalizer = load_windows(args)
    A, U, At, Ut = (to_device(x, device) for x in (a_np, u_np, at_np, ut_np))
    n_train, n_test = A.shape[0], At.shape[0]
    if n_train < args.batch_size or n_test == 0:
        raise ValueError(f"{n_train} train and {n_test} test samples do not "
                         f"fill a batch of {args.batch_size}")

    built = build(args, n_train, normalizer, device)
    n_params = num_parameters(built.model)
    print(f"FNO3d parameters: {n_params}", flush=True)
    rng = np.random.default_rng(args.seed)

    history = []
    for ep in range(args.epochs):
        ls = train_epoch(built, A, U, epoch_order(rng, n_train, args.batch_size, device))
        test = evaluate(built, At, Ut)
        train_l2, test_l2 = float(ls.mean()), float(test)  # the epoch's sync
        history.append({"epoch": ep + 1, "train": train_l2, "test": test_l2})
        print(f"Epoch {ep + 1:2d}/{args.epochs} | train rel L2: {train_l2:.5e} | "
              f"test rel L2: {test_l2:.5e}", flush=True)
    return {"model": built.model, "n_params": n_params, "history": history,
            "test": history[-1]["test"] if history else None}


if __name__ == "__main__":
    main()

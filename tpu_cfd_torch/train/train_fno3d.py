"""FNO3d baseline training with dataset normalization (PyTorch).

Counterpart of ``examples/ex2_fno3d_train.py``, with the same flags plus
``--no-cuda``: a fixed-window dataset (``--t-start``, spatial Gaussian
normalizer) or an FNO-paper-format file (``--mat-file``, field ``u`` shaped
``(N, n, n, T)``), ``FNO3d(modes, modes, modes_t, width, input_channel=T)``,
the relative Sobolev loss of order 0 on denormalised fields, and Adam on the
one-cycle schedule (``div_factor=1e4``, ``final_div_factor=1e3``). As in the
example, each fixed-window set is normalised with its own statistics when it
is built, and the loss denormalises both with the **train** statistics; the
``--mat-file`` test inputs are normalised with the train normalizer.

The FNO3d input is the input frames broadcast along the output time axis
plus the (x, y, t) grid channels. Both dataset kinds have static windows, so
all of them live on the device and an epoch takes a permutation: no
per-batch host slicing, and one synchronisation an epoch. Eval runs one
sample at a time. It runs on the card unless ``--no-cuda`` is given.

Run (after generating the McWilliams dataset):
  python -m tpu_cfd_torch.train.train_fno3d --epochs 10 --num-samples 1024
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from tpu_cfd_torch.data.datasets import (
    NavierStokesDataset,
    SpatioTemporalDatasetFixedTime,
)
from tpu_cfd_torch.device import resolve_device
from tpu_cfd_torch.models import FNO3d, init_like_flax, make_fno3d_input, num_parameters
from tpu_cfd_torch.train import losses, pipeline

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
    p.add_argument("--time-steps", type=int, default=10)
    p.add_argument("--t-start", type=int, default=10)
    p.add_argument("--res", type=int, default=64)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--no-cuda", default=False, action="store_true",
                   help="run on the CPU")
    return p


def load_windows(args):
    """The static (input, target) windows of the train and the test set as
    numpy arrays, and the normalizer of the targets (None for raw targets)."""
    T = args.time_steps
    if args.mat_file:
        # FNO-paper workflow: inputs normalized with the train normalizer,
        # targets raw frames
        train_ds = NavierStokesDataset(
            args.mat_file, n_samples=args.num_samples, time_steps_input=T,
            time_steps_output=T, normalize=True)
        test_ds = NavierStokesDataset(
            args.mat_file, n_samples=args.num_test_samples, train=False,
            time_steps_input=T, time_steps_output=T, normalize=False)
        test_a = train_ds.normalizer.transform(test_ds.a)
        return (train_ds.a, train_ds.u), (test_a, test_ds.u), None
    data_path = args.data_file or os.path.join(
        pipeline.DATA_PATH, "McWilliams2d_64x64_N1152_v1e-3_T10_steps100.npz")
    kw = dict(fields=[FIELD], steps=T, out_steps=T, T_start=args.t_start)
    train_ds = SpatioTemporalDatasetFixedTime(
        data_path, n_samples=args.num_samples, **kw)
    test_ds = SpatioTemporalDatasetFixedTime(
        data_path, n_samples=args.num_test_samples, train=False, **kw)
    # the loss denormalises with the train statistics, on the test set too
    normalizer = train_ds.normalizers[FIELD]
    if train_ds.total_steps < args.t_start + 2 * T:
        raise ValueError(
            f"{data_path} holds {train_ds.total_steps} records, fewer than "
            f"--t-start {args.t_start} plus {T} input and {T} output steps")
    windows = []
    for ds in (train_ds, test_ds):
        inp, out = ds.sample(np.arange(len(ds)))
        windows.append((inp[FIELD], out[FIELD]))
    return windows[0], windows[1], normalizer


def main(argv=None) -> dict:
    """Runs the CLI; returns ``{"model", "n_params", "history", "test"}``."""
    args = get_parser().parse_args(argv)
    device = resolve_device("cpu" if args.no_cuda else None)
    T = args.time_steps
    (a_np, u_np), (at_np, ut_np), normalizer = load_windows(args)
    to_dev = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)  # noqa: E731
    A, U, At, Ut = (to_dev(x) for x in (a_np, u_np, at_np, ut_np))
    n_train, n_test = A.shape[0], At.shape[0]
    if n_train < args.batch_size or n_test == 0:
        raise ValueError(f"{n_train} train and {n_test} test samples do not "
                         f"fill a batch of {args.batch_size}")

    model = FNO3d(args.modes, args.modes, args.modes_t, width=args.width,
                  input_channel=T)
    init_like_flax(model, torch.Generator().manual_seed(args.seed))
    model.to(device)
    n_params = num_parameters(model)
    print(f"FNO3d parameters: {n_params}", flush=True)
    rng = np.random.default_rng(args.seed)

    nb = max(1, n_train // args.batch_size)
    optimizer = pipeline.get_optimizer("Adam", model.parameters(), args.lr)
    scheduler = pipeline.onecycle_lr(optimizer, args.lr, nb, args.epochs,
                                     div_factor=1e4, final_div_factor=1e3)
    sobolev = losses.SobolevLoss(n_grid=args.res, norm_order=0, relative=True)

    if normalizer is not None:
        # SpatialGaussianNormalizer's statistics are per (x, y) location
        mean, std = to_dev(normalizer.mean), to_dev(normalizer.std) + normalizer.eps

        def denorm(u):
            return u * std + mean
    else:
        def denorm(u):  # .mat targets are raw solution frames
            return u

    def loss_fn(out, u):
        return sobolev(denorm(out[0]), denorm(u))

    step = pipeline.make_train_step(model, loss_fn, optimizer, scheduler)

    @torch.no_grad()
    def run_eval() -> torch.Tensor:
        return torch.stack([
            loss_fn(model(make_fno3d_input(At[i:i + 1], T)), Ut[i:i + 1])
            for i in range(n_test)]).mean()

    history = []
    for ep in range(args.epochs):
        # one permutation an epoch, from the same rng stream as a host loop
        order = rng.permutation(n_train)[: nb * args.batch_size]
        order = torch.from_numpy(order.reshape(nb, args.batch_size)).to(device)
        model.train()
        ls = torch.stack([step(make_fno3d_input(A[idx], T), U[idx])
                          for idx in order])
        model.eval()
        train_l2, test_l2 = float(ls.mean()), float(run_eval())  # the epoch's sync
        history.append({"epoch": ep + 1, "train": train_l2, "test": test_l2})
        print(f"Epoch {ep + 1:2d}/{args.epochs} | train rel L2: {train_l2:.5e} | "
              f"test rel L2: {test_l2:.5e}", flush=True)
    return {"model": model, "n_params": n_params, "history": history,
            "test": history[-1]["test"] if history else None}


if __name__ == "__main__":
    main()

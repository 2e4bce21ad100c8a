"""SFNO trained 5 epochs reproduces the McWilliams inverse-cascade spectrum.

Counterpart of ``examples/ex2_sfno_5ep_spectra.py``: trains the reference's
McWilliams recipe (modes 32/32/5, width 10, beta -1e-2, one-cycle Adam 1e-2)
for 5 epochs on the generated 64² dataset, then compares the shell-averaged
enstrophy spectra E(k) of predictions and ground truth on held-out samples
(the last predicted frame, averaged over 8 samples) and draws the overlay
with a k^(-5) guide. The ``gap`` is the mean |log10 E_pred - log10 E_true|
over k = 2..20. On a mesh coarser than 64² the modes are cut to n/2 and the
gap's range to the wavenumbers the mesh holds.

Runs on the card unless ``--no-cuda`` asks for the CPU:
  python -m tpu_cfd_torch.examples.ex2_sfno_5ep_spectra [--epochs 5] \\
      [--data-file <McWilliams npz>]
The figure goes to ``--out`` (default FIG_PATH/mcwilliams_5ep_spectra.png)
where matplotlib is installed.
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np
import torch

from tpu_cfd_torch.data.datasets import SpatioTemporalDataset
from tpu_cfd_torch.device import resolve_device
from tpu_cfd_torch.models import SFNO, init_like_flax
from tpu_cfd_torch.train import losses, pipeline
from tpu_cfd_torch.train.train import _resolve_data
from tpu_cfd_torch.utils import visualizations as viz

T_IN, T_OUT = 10, 10


def main(argv=None) -> dict:
    """Runs the example; returns ``{"gap", "history" (mean train loss an
    epoch), "train_steps", "n", "figure"}``."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--num-samples", type=int, default=1024)
    p.add_argument("--num-val-samples", type=int, default=64,
                   help="held-out samples, from the end of the file")
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--data-file", type=str, default=None,
                   help="the dataset (default: the McWilliams recipe's train file)")
    p.add_argument("--out", type=str, default=None,
                   help="figure path (default FIG_PATH/mcwilliams_5ep_spectra.png)")
    p.add_argument("--no-cuda", action="store_true", help="run on the CPU")
    args = p.parse_args(argv)
    device = resolve_device("cpu" if args.no_cuda else None)

    data_path = _resolve_data("McWilliams2d", "train", args.data_file)
    train_ds = SpatioTemporalDataset(data_path, n_samples=args.num_samples,
                                     fields=["vorticity"], steps=T_IN, out_steps=T_OUT)
    val_ds = SpatioTemporalDataset(data_path, n_samples=args.num_val_samples,
                                   fields=["vorticity"], steps=T_IN, out_steps=T_OUT,
                                   train=False)
    n = train_ds.data["vorticity"].shape[1]
    modes = min(32, n // 2)
    model = SFNO(modes_x=modes, modes_y=modes, modes_t=5, width=10, beta=-1e-2,
                 output_steps=T_OUT)
    rng = np.random.default_rng(1127825)
    train_ds.sample(np.arange(2), rng)  # the JAX example's init batch: same draws after it
    init_like_flax(model, torch.Generator().manual_seed(0)).to(device)

    steps_per_epoch = len(train_ds) // args.batch_size
    opt = pipeline.get_optimizer("Adam", model.parameters(), 1e-2)
    sched = pipeline.onecycle_lr(opt, 1e-2, steps_per_epoch=steps_per_epoch,
                                 epochs=args.epochs)
    step = pipeline.make_train_step(
        model, losses.SobolevLoss(n_grid=n, norm_order=0, relative=True), opt, sched)
    history, train_steps = [], 0
    for ep in range(args.epochs):
        ep_loss = [step(torch.from_numpy(bi["vorticity"]).to(device),
                        torch.from_numpy(bo["vorticity"]).to(device))
                   for bi, bo in train_ds.batches(args.batch_size, rng)]
        train_steps += len(ep_loss)
        history.append(float(torch.stack(ep_loss).mean()))
        print(f"epoch {ep + 1}/{args.epochs}: train rel Sobolev {history[-1]:.4e}")

    # spectra on held-out windows: predictions against ground truth
    inp, out = val_ds.sample(np.arange(min(8, len(val_ds))), np.random.default_rng(0))
    with torch.no_grad():
        pred = model(torch.from_numpy(inp["vorticity"]).to(device),
                     out_steps=T_OUT).cpu().numpy()  # (b, x, y, t)
    truth = out["vorticity"]
    h = 2 * math.pi / n
    # E(k) over the held-out samples at the last (most rolled-out) frame
    spec_pred, spec_true = (
        np.mean([viz.get_enstrophy_spectrum(f[i, ..., -1], h) for i in range(len(f))],
                axis=0) for f in (pred, truth))
    ks = np.arange(2, min(21, n // 2))  # entry i of a spectrum is k = i + 1
    gap = float(np.abs(np.log10(spec_pred[ks - 1]) - np.log10(spec_true[ks - 1])).mean())
    print(f"mean |log10 E_pred - log10 E_true| over k={ks[0]}..{ks[-1]}: {gap:.3f}")

    out_path = args.out or os.path.join(pipeline.FIG_PATH, "mcwilliams_5ep_spectra.png")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    figure = viz.save_figure(
        lambda: viz.plot_enstrophy_spectrum(
            [truth[0, ..., -1], pred[0, ..., -1]], h=h,
            labels=["simulation", f"SFNO {args.epochs}ep"],
            title="McWilliams2d enstrophy spectra"),
        out_path, dpi=120, bbox_inches="tight")
    if figure is not None:
        print(f"figure: {figure}")
    return {"gap": gap, "history": history, "train_steps": train_steps, "n": n,
            "figure": figure}


if __name__ == "__main__":
    main()

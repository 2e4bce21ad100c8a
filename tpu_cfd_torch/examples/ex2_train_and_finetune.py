"""End-to-end demo: generate data → train SFNO → a-posteriori fine-tune.

Counterpart of ``examples/ex2_train_and_finetune.py``, shrunk to run in
minutes and in fp32, as the JAX demo is. The operator learns
trajectory-to-trajectory on coarse data, then the output layer is refined at
evaluation resolution against the PDE residual, differentiating through the
spectral solver. Its ``dt=1e-6`` difference in fp32 sits at roundoff, so
the residual need not fall; the demo shows that the three stages run.

Runs on the card unless ``--no-cuda`` asks for the CPU:
  python -m tpu_cfd_torch.examples.ex2_train_and_finetune [--no-cuda]
"""

from __future__ import annotations

import argparse
import math
import os
import tempfile

import numpy as np
import torch

from tpu_cfd_torch.data.datasets import SpatioTemporalDataset
from tpu_cfd_torch.data.generate import main_mcwilliams
from tpu_cfd_torch.device import resolve_device
from tpu_cfd_torch.models import SFNO, init_like_flax
from tpu_cfd_torch.train import finetune, losses, pipeline

# the three stages' arguments, as in the JAX demo
GENERATE = ["--grid-size", "128", "--subsample", "2", "--num-samples", "8",
            "--batch-size", "4", "--time", "1.0", "--time-warmup", "0.5",
            "--dt", "1e-3", "--num-steps", "24"]
MODEL = dict(modes_x=12, modes_y=12, modes_t=4, width=10, latent_steps=8,
             num_spectral_layers=3, output_steps=8)
FT_MODES = (24, 24, 4)
EPOCHS, BATCH, FT_STEPS = 5, 2, 30


def main(argv=None) -> dict:
    """Runs the demo. Returns ``{"data_path", "train_history" (mean loss an
    epoch), "train_steps", "finetune_history"}``."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workdir", type=str, default=None,
                   help="where the dataset goes (default: a new temporary directory)")
    p.add_argument("--no-cuda", action="store_true", help="run on the CPU")
    args = p.parse_args(argv)
    device = resolve_device("cpu" if args.no_cuda else None)
    workdir = args.workdir or tempfile.mkdtemp(prefix="tpu_cfd_torch_demo_")

    # 1) generate a small McWilliams dataset
    data_path = main_mcwilliams(GENERATE + ["--filepath", workdir]
                                + (["--no-cuda"] if args.no_cuda else []))
    print(f"dataset: {data_path}")

    # 2) train a small SFNO
    ds = SpatioTemporalDataset(data_path, n_samples=6, fields=["vorticity"],
                               steps=8, out_steps=8)
    model = SFNO(**MODEL)
    rng = np.random.default_rng(0)
    ds.sample(np.arange(2), rng)  # the JAX demo's init batch: same draws after it
    init_like_flax(model, torch.Generator().manual_seed(0)).to(device)
    opt = pipeline.get_optimizer("Adam", model.parameters(), 5e-3)
    sched = pipeline.onecycle_lr(opt, 5e-3, steps_per_epoch=3, epochs=EPOCHS)
    n = ds.data["vorticity"].shape[1]  # 64 at these arguments
    step = pipeline.make_train_step(
        model, losses.SobolevLoss(n_grid=n, norm_order=0, relative=True), opt, sched)
    train_history, train_steps = [], 0
    for ep in range(EPOCHS):
        ep_loss = []
        for bi, bo in ds.batches(BATCH, rng):
            ep_loss.append(step(torch.from_numpy(bi["vorticity"]).to(device),
                                torch.from_numpy(bo["vorticity"]).to(device)))
        train_steps += len(ep_loss)
        train_history.append(float(torch.stack(ep_loss).mean()))
        print(f"epoch {ep + 1}: train rel Sobolev {train_history[-1]:.4e}")

    # 3) fine-tune the output layer against the PDE residual
    inp, _ = ds.sample(np.arange(1), rng)
    w_in = torch.from_numpy(inp["vorticity"]).to(device)
    with torch.no_grad():
        pred = model(w_in)
    ft = finetune.OutConvFT(*FT_MODES, out_steps=8,
                            visc=1e-3, dt=1e-6, diam=2 * math.pi, delta=5e-2)
    ft.conv.reset_parameters(torch.Generator().manual_seed(1))
    with torch.no_grad():
        for prm in ft.parameters():
            prm.mul_(1e-2)
    ft.to(device)
    hist = finetune.finetune_steps(ft, pred[..., None], w_in, None, out_steps=8,
                                   n_steps=FT_STEPS, lr=1e-2)
    print(f"fine-tune Bochner residual: {hist[0]:.3e} -> {hist[-1]:.3e}")
    return {"data_path": os.fspath(data_path), "train_history": train_history,
            "train_steps": train_steps, "finetune_history": hist}


if __name__ == "__main__":
    main()

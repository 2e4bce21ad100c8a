"""SFNO training CLI: trajectory-to-trajectory operator learning (PyTorch).

Counterpart of ``tpu_cfd/train/train.py``, with the same flags plus
``--no-cuda``. Runs on the card unless ``--no-cuda`` asks for the CPU, and
raises when there is no card. The dataset lives on the card and each epoch
gathers its windows there (``--host-data`` slices batches on the host
instead); batches come from the same numpy draws as the JAX CLI's.
Parameters are drawn from a ``torch.Generator`` seeded by ``--seed`` with
flax's initializer distributions.

Example (the reference's McWilliams run):
  python -m tpu_cfd_torch.train.train --example McWilliams2d --epochs 15 \\
      --num-samples 1152 --batch-size 64 --width 10 --modes 32 --modes-t 5 \\
      --num-layers 4 --time-steps 10 --out-time-steps 10 --activation GELU

``--compute-dtype bfloat16`` (bf16 activations in the lifting and the
backbone), ``--remat`` (activation checkpointing) and ``--optimizer lion``
work as in the JAX CLI. ``--data-parallel`` and ``--demo-plots`` are not
ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import os
import re
import time
from datetime import datetime

import numpy as np
import torch

from tpu_cfd_torch.data.data_utils import get_logger
from tpu_cfd_torch.data.datasets import SpatioTemporalDataset
from tpu_cfd_torch.device import resolve_device
from tpu_cfd_torch.models import SFNO, init_like_flax, num_parameters
from tpu_cfd_torch.train import losses, pipeline
from tpu_cfd_torch.train.pipeline import DATA_PATH, LOG_PATH, MODEL_PATH

# Default dataset files as the dataset CLIs name them
DATA_FILES = {
    "fno": {
        "train": "fnodata_extra_256to64_N1280_v1e-3_T50_steps100.npz",
        "valid": "fnodata_extra_256to64_N1280_v1e-3_T50_steps100.npz",
        "test": "fnodata_extra_fp64_256x256_N16_v1e-3_T50_steps100.npz",
    },
    "McWilliams2d": {
        "train": "McWilliams2d_256to64_N1152_v1e-3_T10_steps100.npz",
        "valid": "McWilliams2d_256to64_N1152_v1e-3_T10_steps100.npz",
        "test": "McWilliams2d_fp64_256x256_N16_v1e-3_T10_steps100.npz",
    },
}

_NOT_PORTED = {
    "data_parallel": "--data-parallel waits for ROADMAP.md Queue A item 6 "
                     "(torch.distributed data parallelism)",
    "demo_plots": "--demo-plots waits for ROADMAP.md Queue A item 6 "
                  "(utils/visualizations.py)",
}


def _resolve_data(example: str, split: str, override: str = None) -> str:
    if override:
        return override if os.path.isabs(override) else os.path.join(DATA_PATH, override)
    path = os.path.join(DATA_PATH, DATA_FILES[example][split])
    if not os.path.exists(path):
        # older "{ns}x{ns}" naming of subsampled sets, and the .pt format
        legacy = re.sub(r"_\d+to(\d+)_", r"_\1x\1_", path)
        for alt in (legacy, path.replace(".npz", ".pt"), legacy.replace(".npz", ".pt")):
            if os.path.exists(alt):
                return alt
    return path


def build_model(args) -> SFNO:
    return SFNO(
        modes_x=args.modes, modes_y=args.modes, modes_t=args.modes_t,
        width=args.width, beta=args.beta, num_spectral_layers=args.num_layers,
        output_steps=args.out_time_steps, spatial_padding=args.spatial_padding,
        activation=args.activation, spatial_random_feats=args.spatial_random_feats,
        lift_activation=not args.lift_linear, latent_steps=args.latent_steps,
        mxu_precision=args.mxu_precision, compute_dtype=args.compute_dtype,
        remat=args.remat)


def main(args=None) -> dict:
    """Runs the CLI; returns ``{"model", "n_params", "history", "test",
    "checkpoint"}`` (the best model's path without its ``.pt`` suffix)."""
    args = get_parser().parse_args(args)
    for flag, why in _NOT_PORTED.items():
        if getattr(args, flag):
            raise NotImplementedError(f"{why}; not ported to PyTorch yet")
    device = resolve_device("cpu" if args.no_cuda else None)
    pipeline.ensure_paths()
    stamp = datetime.now().strftime("%d_%b_%Y_%Hh%Mm")
    logger = get_logger(os.path.join(LOG_PATH, f"{stamp}_train.log"),
                        name="tpu_cfd_torch.train")
    logger.info("Arguments: " + " | ".join(f"{k}={v}" for k, v in vars(args).items()))

    example, n, fs = args.example, args.res, args.field
    time_steps, out_steps = args.time_steps, args.out_time_steps
    train_path = _resolve_data(example, "train", args.train_file)
    val_path = _resolve_data(example, "valid", args.train_file)
    logger.info(f"Training: first {args.num_samples} samples of {train_path} on {device}")
    train_dataset = SpatioTemporalDataset(
        data_path=train_path, n_samples=args.num_samples, fields=[fs],
        steps=time_steps, out_steps=out_steps)
    val_dataset = SpatioTemporalDataset(
        data_path=val_path, n_samples=args.num_val_samples, fields=[fs],
        steps=time_steps, out_steps=out_steps, train=False)

    model = build_model(args)
    init_like_flax(model, torch.Generator().manual_seed(args.seed))
    model.to(device)
    n_params = num_parameters(model)
    logger.info(f"Number of parameters: {n_params}")
    rng = np.random.default_rng(args.seed)

    steps_per_epoch = max(1, len(train_dataset) // args.batch_size)
    optimizer = pipeline.get_optimizer(args.optimizer, model.parameters(), args.lr)
    scheduler = pipeline.onecycle_lr(optimizer, args.lr, steps_per_epoch, args.epochs)
    loss_func = losses.SobolevLoss(n_grid=n, norm_order=args.norm_order, relative=True)
    path_model = os.path.join(MODEL_PATH, f"sfno_{example}_{n}x{n}_m{args.modes}_w{args.width}")

    data_bytes = train_dataset.data[fs].nbytes + val_dataset.data[fs].nbytes
    use_device_data = (not args.host_data
                       and data_bytes <= args.device_data_limit_gb * 2 ** 30)
    if use_device_data:
        run_epoch = pipeline.make_device_epoch(
            model, loss_func, optimizer,
            torch.from_numpy(train_dataset.data[fs]).to(device), time_steps,
            out_steps, scheduler, args.grad_clip)
        run_eval = pipeline.make_device_eval(
            model, loss_func, torch.from_numpy(val_dataset.data[fs]).to(device),
            time_steps, out_steps, model_out_steps=out_steps)
        logger.info(f"Device-resident data: {data_bytes / 2 ** 20:.0f} MiB on {device}")
    else:
        train_step = pipeline.make_train_step(model, loss_func, optimizer,
                                              scheduler, args.grad_clip)
        eval_step = pipeline.make_eval_step(model, loss_func, out_steps=out_steps)

    history = []
    val_l2_min = np.inf
    if not args.eval_only:
        for ep in range(args.epochs):
            t0 = time.perf_counter()
            model.train()
            if use_device_data:
                idx, starts = train_dataset.epoch_indices(args.batch_size, rng)
                ep_losses = run_epoch(idx, starts).cpu().numpy()
                train_l2, count = float(ep_losses.sum()), len(ep_losses)
                vidx, vstarts = val_dataset.epoch_indices(
                    args.batch_size, np.random.default_rng(0), shuffle=False)
                if vidx.size == 0:
                    raise ValueError(f"val dataset yielded no batches "
                                     f"(n={len(val_dataset)}, batch={args.batch_size})")
                model.eval()
                val_l2 = float(run_eval(vidx, vstarts))
            else:
                train_l2, count = 0.0, 0
                for inp, out in train_dataset.batches(args.batch_size, rng):
                    a = torch.from_numpy(inp[fs]).to(device)
                    u = torch.from_numpy(out[fs]).to(device)
                    train_l2 += float(train_step(a, u))
                    count += 1
                model.eval()
                val_l2 = pipeline.eval_epoch(eval_step, val_dataset,
                                             args.batch_size, device, field=fs)
            if val_l2 < val_l2_min:
                pipeline.save_checkpoint(model, path_model)
                val_l2_min = val_l2
            seconds = time.perf_counter() - t0
            history.append({"epoch": ep + 1, "train": train_l2 / max(count, 1),
                            "val": val_l2, "seconds": seconds})
            logger.info(f"Epoch [{ep + 1:3d}/{args.epochs}] avg train rel: "
                        f"{train_l2 / max(count, 1):.4e} | avg val rel: "
                        f"{val_l2:.4e} | {seconds:.1f}s")
        logger.info(f"Training complete. Best model saved to {path_model}.pt")

    test_l2 = None
    if not args.train_only:
        test_path = _resolve_data(example, "test", args.test_file)
        if not os.path.exists(test_path):
            logger.info(f"No test data at {test_path}; skipping eval phase.")
        else:
            test_l2 = _eval_phase(args, model, path_model, test_path, device, logger)
    return {"model": model, "n_params": n_params, "history": history, "test": test_l2,
            "checkpoint": path_model}


def _eval_phase(args, model, path_model, test_path, device, logger) -> float:
    """High-resolution eval from the best checkpoint (fp64 with --double)."""
    dtype = torch.float64 if args.double else torch.float32
    test_dataset = SpatioTemporalDataset(
        data_path=test_path, n_samples=args.num_test_samples, fields=[args.field],
        steps=args.time_steps, out_steps=args.out_time_steps,
        T_start=args.test_t_start, train=False,
        dtype=np.float64 if args.double else np.float32)
    if os.path.exists(path_model + ".pt"):
        pipeline.load_checkpoint(path_model, model)
    else:
        logger.info("No best checkpoint; evaluating the last parameters.")
    model.to(device=device, dtype=dtype).eval()
    metric = losses.SobolevLoss(n_grid=args.test_res, norm_order=args.norm_order,
                                relative=True)
    test_step = pipeline.make_eval_step(model, metric, out_steps=args.out_time_steps)
    test_l2 = pipeline.eval_epoch(test_step, test_dataset, args.test_batch_size,
                                  device, field=args.field)
    logger.info(f"Test rel Sobolev metric at {args.test_res}x{args.test_res}: "
                f"{test_l2:.4e}")
    return test_l2


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Train SFNO (PyTorch port)")
    parser.add_argument("--example", type=str, default="fno")
    parser.add_argument("--num-samples", type=int, default=1024)
    parser.add_argument("--num-val-samples", type=int, default=64)
    parser.add_argument("--num-test-samples", type=int, default=16)
    parser.add_argument("--test-t-start", type=int, default=30,
                        help="high-res eval window start")
    parser.add_argument("--test-batch-size", type=int, default=1)
    parser.add_argument("--res", type=int, default=64)
    parser.add_argument("--test-res", type=int, default=256)
    parser.add_argument("--field", type=str, default="vorticity")
    parser.add_argument("--batch-size", type=int, default=4)
    parser.add_argument("--lr", type=float, default=1e-2)
    parser.add_argument("--seed", type=int, default=1127825)
    parser.add_argument("--epochs", type=int, default=15)
    parser.add_argument("--optimizer", type=str, default="Adam")
    parser.add_argument("--viscosity", type=float, default=1e-3)
    parser.add_argument("--width", type=int, default=10)
    parser.add_argument("--modes", type=int, default=32)
    parser.add_argument("--modes-t", type=int, default=5)
    parser.add_argument("--num-layers", type=int, default=4)
    parser.add_argument("--latent-steps", type=int, default=10)
    parser.add_argument("--spatial-padding", type=int, default=0)
    parser.add_argument("--time-steps", type=int, default=10)
    parser.add_argument("--out-time-steps", type=int, default=10)
    parser.add_argument("--beta", type=float, default=0.0)
    parser.add_argument("--activation", type=str, default="GELU")
    parser.add_argument("--grad-clip", type=float, default=0.0)
    parser.add_argument("--spatial-random-feats", default=False, action="store_true")
    parser.add_argument("--lift-linear", default=False, action="store_true")
    parser.add_argument("--host-data", default=False, action="store_true",
                        help="slice batches on the host instead of keeping the"
                             " dataset on the device")
    parser.add_argument("--device-data-limit-gb", type=float, default=6.0,
                        help="fall back to --host-data when train+val arrays"
                             " exceed this size")
    parser.add_argument("--double", default=False, action="store_true",
                        help="run the eval phase in float64")
    parser.add_argument("--mxu-precision", type=str, default="highest",
                        choices=["highest", "high", "default"],
                        help="accepted for the JAX CLI's flags; every mode "
                             "computes in fp32")
    parser.add_argument("--compute-dtype", type=str, default=None,
                        choices=["float32", "bfloat16"],
                        help="activation dtype of the lifting and the backbone;"
                             " parameters, mode-space math and the head stay"
                             " in the input's dtype")
    parser.add_argument("--remat", default=False, action="store_true",
                        help="recompute the lifting/backbone blocks in the"
                             " backward pass instead of keeping their"
                             " intermediates")
    parser.add_argument("--norm-order", type=float, default=0.0)
    parser.add_argument("--eval-only", default=False, action="store_true")
    parser.add_argument("--train-only", default=False, action="store_true")
    parser.add_argument("--train-file", type=str, default=None,
                        help="override train/valid data file")
    parser.add_argument("--test-file", type=str, default=None)
    parser.add_argument("--demo-plots", type=int, default=0)
    parser.add_argument("--data-parallel", default=False, action="store_true")
    parser.add_argument("--no-cuda", default=False, action="store_true",
                        help="run on the CPU")
    return parser


if __name__ == "__main__":
    main()

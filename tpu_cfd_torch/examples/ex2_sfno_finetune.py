"""A-posteriori fine-tuning of a trained SFNO at 256² in fp64.

Counterpart of ``examples/ex2_sfno_finetune.py``, with the same flags plus
``--no-cuda``:

1. load an SFNO trained at 64² (``python -m tpu_cfd_torch.train.train``),
2. run it zero-shot on one fp64 256² test trajectory, tapping the reduced
   latent "r" that feeds the output conv,
3. enlarge the output spectral conv to eval modes (64, 64, 6) with the
   trained low-mode corners transplanted in,
4. refine ONLY that conv with two-group Adam (bias fast, weight slow)
   against the PDE residual in the α-weighted H⁻¹ dual norm, where the
   residual is computed by differentiating through the spectral CN-IMEX
   solver step itself.

Runs in fp64 end to end on the card (``torch.fft`` and complex128 einsums:
no hand-written kernel runs on this path), or on the CPU with ``--no-cuda``.
Without a card and without ``--no-cuda`` it raises. ``main`` builds its
objects with ``build_sfno``, ``zero_shot``, ``build_outconv``,
``make_forcing`` and ``residual_norm``, and refines with
``finetune.finetune_steps``; on a batch the same objects refine one conv on
the batch-mean residual norm.

Run:
  python -m tpu_cfd_torch.examples.ex2_sfno_finetune --example fno
  python -m tpu_cfd_torch.examples.ex2_sfno_finetune --example McWilliams2d \\
      --gt-floor --lr-decay 0.05 --iters 160
"""

from __future__ import annotations

import argparse
import math
import os
import time

import numpy as np
import torch

from tpu_cfd_torch.data.datasets import SpatioTemporalDataset
from tpu_cfd_torch.device import resolve_device
from tpu_cfd_torch.models import SFNO, forward_with_latents
from tpu_cfd_torch.train import finetune, losses, pipeline
from tpu_cfd_torch.train.train import _resolve_data

# per-example settings mirroring the two reference notebooks' cells 1/6-8
CONFIGS = {
    "fno": dict(
        modes=12, modes_t=5, width=20, beta=1e-2,
        steps=10, out_steps=40, t_start=30,
        diam=1.0, lr_bias=2e-1, iters=50, forcing="sincos",
    ),
    "McWilliams2d": dict(
        modes=32, modes_t=5, width=10, beta=-1e-2,
        steps=10, out_steps=10, t_start=50,
        diam=2 * math.pi, lr_bias=1e-2, iters=100, forcing="none",
    ),
}


# the output conv's solver post-process (notebook cell 6), and the enlarged
# conv's modes and weight learning rate (the flags' defaults)
FT_KWS = dict(delta=1.0, visc=1e-3, dt=1e-6, bdf_weight=(0.5, 0.5),
              temporal_padding=True, finetune=True)
MODES_FT = (64, 64, 6)
LR_WEIGHT = 1e-4
# the α of the H⁻¹ residual norm
RESIDUAL_ALPHA = 10 ** (-3 / 2)


def make_forcing(kind: str, n: int, dtype, device) -> torch.Tensor:
    """The data-generation forcing on the eval grid (notebook cell 5)."""
    if kind == "none":
        return torch.zeros((1, n, n), dtype=dtype, device=device)
    x = np.linspace(0, 1, n + 1)[:-1]
    X, Y = np.meshgrid(x, x, indexing="ij")
    f = 0.1 * (np.sin(2 * np.pi * (X + Y)) + np.cos(2 * np.pi * (X + Y)))
    return torch.from_numpy(f[None]).to(device=device, dtype=dtype)


def build_sfno(cfg: dict) -> SFNO:
    """The example's SFNO at ``cfg``'s widths (``CONFIGS``), in fp32 on the
    CPU, with the class-default activation."""
    return SFNO(
        modes_x=cfg["modes"], modes_y=cfg["modes"], modes_t=cfg["modes_t"],
        width=cfg["width"], beta=cfg["beta"], output_steps=cfg["out_steps"],
    )


def zero_shot(model: SFNO, w_in: torch.Tensor, out_steps: int):
    """The zero-shot pass on ``w_in`` ``(b, n, n, steps)``, no graph kept:
    ``(prediction (b, n, n, out_steps), the reduced latent "r" that feeds
    the output conv)``."""
    with torch.no_grad():
        pred, latents = forward_with_latents(model, w_in, out_steps=out_steps)
    return pred, latents["r"]


def build_outconv(model: SFNO, cfg: dict, modes_ft=MODES_FT, dtype=torch.float64,
                  device=None) -> finetune.OutConvFT:
    """The output conv enlarged to ``modes_ft``, the trained corners of
    ``model.out_conv`` transplanted in (notebook cell 6)."""
    return finetune.build_finetune_outconv(
        model.out_conv.conv, (cfg["modes"], cfg["modes"], cfg["modes_t"]),
        tuple(modes_ft), out_steps=cfg["out_steps"],
        generator=torch.Generator().manual_seed(1), dtype=dtype, device=device,
        diam=cfg["diam"], **FT_KWS,
    )


def residual_norm(n: int, diam: float) -> losses.SobolevLoss:
    """The α-weighted H⁻¹ norm of the residual, time-averaged, the mean over
    the batch of each sample's norm."""
    return losses.SobolevLoss(
        n_grid=n, norm_order=-1, relative=False, time_average=True,
        alpha=RESIDUAL_ALPHA, freq_cutoff=n // 2 + 1, diam=diam,
    )


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--example", choices=list(CONFIGS), default="fno")
    p.add_argument("--res", type=int, default=256)
    p.add_argument("--idx", type=int, default=1,
                   help="test-sample index (notebook cell 4/5 uses idx=1/2)")
    p.add_argument("--iters", type=int, default=None)
    p.add_argument("--lr-bias", type=float, default=None)
    p.add_argument("--lr-weight", type=float, default=LR_WEIGHT)
    p.add_argument("--modes-ft", type=int, nargs=3, default=MODES_FT)
    p.add_argument("--ckpt", type=str, default=None,
                   help="checkpoint path without its .pt suffix")
    p.add_argument("--test-file", type=str, default=None)
    p.add_argument("--t-start", type=int, default=None)
    p.add_argument("--lr-decay", type=float, default=None,
                   help="exponential lr decay over the run (end/start ratio, "
                        "e.g. 0.1); default: constant lrs as in the notebook")
    p.add_argument("--gt-floor", action="store_true",
                   help="also report the residual norm of the GROUND-TRUTH "
                        "trajectory through the same ±dt CN solves — the "
                        "discretization floor of the metric itself")
    p.add_argument("--no-cuda", action="store_true", help="run on the CPU")
    return p


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    """Runs the example. Returns ``{"best", "best_iter", "history",
    "zero_shot_rel_l2", "gt_floor", "zero_shot_ms", "gt_floor_ms",
    "iter_seconds"}``: ``best`` is the least residual of the history and
    ``best_iter`` its number of Adam updates; ``gt_floor`` is None without
    ``--gt-floor``; ``iter_seconds[i]`` is the wall time from iteration i's
    metrics to the next's (one Adam update and one forward and backward; the
    last one the update and the evaluation after the loop)."""
    args = get_parser().parse_args(argv)
    device = resolve_device("cpu" if args.no_cuda else None)
    cfg = CONFIGS[args.example]
    n = args.res
    iters = args.iters if args.iters is not None else cfg["iters"]
    lr_bias = args.lr_bias if args.lr_bias is not None else cfg["lr_bias"]
    t_start = args.t_start if args.t_start is not None else cfg["t_start"]
    T, T_out, diam = cfg["steps"], cfg["out_steps"], cfg["diam"]
    dtype = torch.float64

    test_path = _resolve_data(args.example, "test", args.test_file)
    ds = SpatioTemporalDataset(
        test_path, n_samples=16, fields=["vorticity"], steps=T,
        out_steps=T_out, T_start=t_start, train=False, dtype=np.float64,
    )
    inp, out = ds.sample(np.array([args.idx]))
    w_in = torch.from_numpy(inp["vorticity"]).to(device)     # (1, n, n, T)
    w_gt = torch.from_numpy(out["vorticity"]).to(device)     # (1, n, n, T_out)

    model = build_sfno(cfg)
    ckpt = args.ckpt or os.path.join(
        pipeline.MODEL_PATH,
        f"sfno_{args.example}_64x64_m{cfg['modes']}_w{cfg['width']}",
    )
    pipeline.load_checkpoint(ckpt, model)
    model.to(device=device, dtype=dtype)

    # zero-shot super-resolution pass, tapping the reduced latent "r"
    l2_rel = losses.SobolevLoss(
        n_grid=n, norm_order=0, time_average=True, relative=True, diam=diam,
        freq_cutoff=n // 2 + 1,
    )
    t0 = time.perf_counter()
    pred_no, v_latent = zero_shot(model, w_in, T_out)
    _sync(device)
    zero_shot_ms = 1e3 * (time.perf_counter() - t0)
    zero_shot_l2 = float(l2_rel(pred_no, w_gt))
    print(f"zero-shot rel L2 at {n}x{n}: {zero_shot_l2:.5e}")

    # enlarged output conv, trained corners transplanted (notebook cell 6)
    qft = build_outconv(model, cfg, args.modes_ft, dtype, device)
    res_hm1 = residual_norm(n, diam)
    f = make_forcing(cfg["forcing"], n, dtype, device)
    result = {"zero_shot_rel_l2": zero_shot_l2, "zero_shot_ms": zero_shot_ms,
              "gt_floor": None, "gt_floor_ms": None}

    if args.gt_floor:
        # residual of the exact solver trajectory itself under the SAME
        # ±dt CN derivative estimate and norm: the metric's discretization
        # floor — no predicted trajectory can be expected below it
        t0 = time.perf_counter()
        with torch.no_grad():
            gt_out = finetune.fine_tune_post(
                w_gt, f, visc=FT_KWS["visc"], dt=FT_KWS["dt"],
                diam=diam, bdf_weight=FT_KWS["bdf_weight"],
            )
            result["gt_floor"] = float(res_hm1(gt_out["residual"]))
        result["gt_floor_ms"] = 1e3 * (time.perf_counter() - t0)
        print("GT-trajectory residual (discretization floor): "
              f"{result['gt_floor']:.3e}")
        if iters == 0:
            return {**result, "best": None, "best_iter": None, "history": [],
                    "iter_seconds": []}

    stamps = []

    def track(o):
        _sync(device)
        stamps.append(time.perf_counter())
        return {"l2_vs_gt": l2_rel(o["w"], w_gt), "l2_vs_noft": l2_rel(o["w"], pred_no)}

    hist = finetune.finetune_steps(
        qft, v_latent, w_in, f, out_steps=T_out, n_steps=iters, lr=args.lr_weight,
        lr_bias=lr_bias, residual_norm=res_hm1, track=track, lr_decay=args.lr_decay)
    for i, h in enumerate(hist):
        if i % 10 == 0 or i == len(hist) - 1:
            print(
                f"iter {i:3d} | Res Hm1 {h['residual']:.3e} | "
                f"|ft-gt| {h['l2_vs_gt']:.3e} | |ft-noft| {h['l2_vs_noft']:.3e}"
            )
    # finetune_steps leaves the best-residual iterate (the Adam tail is
    # non-monotonic at the discretization floor): report what it achieves
    best_i, best = finetune.best_of(hist)
    print(f"last-iterate residual: {hist[-1]['residual']:.3e}")
    # history index i = residual of the params after i Adam updates, so
    # "at iter N" attributes the best number to an exact iteration budget
    print(f"best residual (alpha-weighted H^-1, {iters} iters): "
          f"{best:.3e} at iter {best_i}")
    return {**result, "best": best, "best_iter": best_i, "history": hist,
            "iter_seconds": [float(s) for s in np.diff(stamps)]}


if __name__ == "__main__":
    main()

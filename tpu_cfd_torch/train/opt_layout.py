"""Optimizer sweep of the SFNO train step: ``torch.optim.Adam`` vs the one-pass Adam kernel.

Counterpart of ``scripts/opt_layout_r4.py`` at its own configuration (SFNO
modes 12/12/5, width 20, 64², t 10 → 40, batch 4, Adam at 1e-3 on the
relative Sobolev loss of order 0). Two variants:

- ``base``        the plain step: ``torch.optim.Adam``, the port's
                  counterpart of ``optax.adam``;
- ``fused_adam``  the step keeps its own ``m``, ``v`` and step count and,
                  after ``backward()``, updates all parameter leaves with one
                  launch of the hand-written kernel
                  (``tpu_cfd_torch.ops.cuda.adam.AdamLeaves``, built once): one
                  pass that reads ``p, g, m, v`` and writes ``p, m, v``.

The JAX script's ``merge2``, ``merge2d`` and ``packed`` variants reshape the
optimizer's leaves so that a TPU's 128 lanes are filled. A CUDA kernel
indexes a contiguous leaf linearly, so they have no counterpart on a card
and the CLI refuses them by name.

Flags compose as in the script: ``--compute-dtype bfloat16`` runs the
model's activations in bf16; ``--scan N`` takes N steps between two reads of
the loss, with no host synchronisation in between (the card-resident epoch
of ``train.pipeline``; without it the host reads the loss after every step,
as a host-fed loop does); ``--check`` first takes three steps of the variant
and of ``base`` from the same initial state and requires the same loss to
``rtol=2e-5``. It runs on the card unless ``--no-cuda`` is given. One JSON
line a variant.

Usage: python -m tpu_cfd_torch.train.opt_layout [--variants base,fused_adam]
       [--compute-dtype bfloat16] [--scan 8] [--batch 4] [--n-calls 20]
       [--check] [--no-cuda]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Optional, Sequence

import torch

from tpu_cfd_torch.device import resolve_device
from tpu_cfd_torch.models import SFNO, init_like_flax
from tpu_cfd_torch.ops.cuda.adam import AdamLeaves
from tpu_cfd_torch.train import losses

Tensor = torch.Tensor

VARIANTS = ("base", "fused_adam")
TPU_ONLY_VARIANTS = ("merge2", "merge2d", "packed")
CHECK_STEPS = 3
CHECK_RTOL = 2e-5
SEED = 0


def check_variant(variant: str) -> str:
    if variant in TPU_ONLY_VARIANTS:
        raise ValueError(
            f"variant {variant!r} is a TPU lane-tiling lever (it merges a leaf's "
            f"trailing axes to fill 128 lanes) with no counterpart on a CUDA "
            f"card; available: {list(VARIANTS)}")
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; available: {list(VARIANTS)}")
    return variant


def build_step(variant: str, model: torch.nn.Module, loss_fn: Callable,
               t_out: int, lr: float = 1e-3):
    """Returns ``step(x, y) -> loss`` (a 0-d tensor on the device; no host
    sync) that updates ``model`` in place with the variant's optimizer, at
    Adam's usual ``b1=0.9``, ``b2=0.999``, ``eps=1e-8`` either way."""
    check_variant(variant)
    params = list(model.parameters())

    def loss_and_grads(x: Tensor, y: Tensor) -> Tensor:
        for p in params:
            p.grad = None
        loss = loss_fn(model(x, out_steps=t_out), y)
        loss.backward()
        return loss.detach()

    if variant == "base":
        opt = torch.optim.Adam(params, lr=lr)

        def step(x: Tensor, y: Tensor) -> Tensor:
            loss = loss_and_grads(x, y)
            opt.step()
            return loss

        return step

    # the leaves and moments are checked and their launches planned once
    leaves = AdamLeaves(params, [torch.zeros_like(p) for p in params],
                        [torch.zeros_like(p) for p in params])
    count = 0  # on the host: the bias corrections cost no synchronisation

    def step(x: Tensor, y: Tensor) -> Tensor:
        nonlocal count
        loss = loss_and_grads(x, y)
        count += 1
        leaves.step([p.grad for p in params], lr=lr, step=count)
        return loss

    return step


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_variant(variant: str, batch: int = 4, n: int = 64, t_in: int = 10,
                  t_out: int = 40, n_calls: int = 20,
                  compute_dtype: Optional[str] = None, scan: int = 0,
                  check: bool = False, device=None, *, width: int = 20,
                  modes: Sequence[int] = (12, 12, 5), latent_steps: int = 10
                  ) -> dict:
    """Times one variant's train step; returns the JSON line's dict.

    ``width``, ``modes`` and ``latent_steps`` size the model down for tests
    on the CPU; the CLI never sets them and always runs the full width.
    """
    check_variant(variant)
    device = resolve_device(device)

    def new_model() -> SFNO:
        model = SFNO(modes_x=modes[0], modes_y=modes[1], modes_t=modes[2],
                     width=width, beta=1e-2, output_steps=t_out,
                     latent_steps=latent_steps, compute_dtype=compute_dtype)
        init_like_flax(model, torch.Generator().manual_seed(SEED))
        return model.to(device)

    x = torch.randn(batch, n, n, t_in, device=device,
                    generator=torch.Generator(device=device).manual_seed(SEED))
    y = torch.randn(batch, n, n, t_out, device=device,
                    generator=torch.Generator(device=device).manual_seed(SEED + 1))
    loss_fn = losses.SobolevLoss(n_grid=n, norm_order=0, relative=True)
    model = new_model()
    step = build_step(variant, model, loss_fn, t_out)
    leaves = sum(1 for _ in model.parameters())
    steps_taken = 0
    checked = None

    if check:
        base_step = build_step("base", new_model(), loss_fn, t_out)
        for _ in range(CHECK_STEPS):
            l1, l2 = base_step(x, y), step(x, y)
        steps_taken += CHECK_STEPS
        l1, l2 = float(l1), float(l2)
        if not abs(l1 - l2) <= CHECK_RTOL * abs(l1):  # also fails on a NaN
            raise RuntimeError(f"check failed: {variant} loss {l2!r} != base "
                               f"{l1!r} after {CHECK_STEPS} steps "
                               f"(rtol {CHECK_RTOL})")
        checked = {"loss": l2, "base_loss": l1, "steps": CHECK_STEPS}
        print(f"check ok: {variant} loss {l2:.6f} == base {l1:.6f}",
              file=sys.stderr)

    per_call = scan if scan else 1

    def run() -> float:
        for _ in range(per_call):
            loss = step(x, y)
        return float(loss)  # the one host read (and synchronisation) a call

    run()
    _synchronize(device)
    t0 = time.perf_counter()
    for _ in range(n_calls):
        loss = run()
    _synchronize(device)
    dt = (time.perf_counter() - t0) / (n_calls * per_call)
    steps_taken += (n_calls + 1) * per_call
    return {"variant": variant, "compute_dtype": compute_dtype or "float32",
            "scan": scan, "batch": batch, "ms_step": dt * 1e3,
            "samples_per_s": batch / dt, "loss": loss, "check": checked,
            "leaves": leaves, "steps": steps_taken,
            "n_params": sum(p.numel() for p in model.parameters()),
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu")}


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Optimizer sweep of the SFNO train step (PyTorch port)")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--compute-dtype", default=None,
                    choices=["float32", "bfloat16"])
    ap.add_argument("--scan", type=int, default=0,
                    help="steps between two host reads of the loss")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--n-calls", type=int, default=20)
    ap.add_argument("--check", action="store_true",
                    help="require a few steps to match the base variant's loss")
    ap.add_argument("--no-cuda", action="store_true", help="run on the CPU")
    return ap


def main(argv=None) -> list:
    """Runs the CLI; prints one JSON line a variant and returns the dicts."""
    args = get_parser().parse_args(argv)
    variants = [check_variant(v) for v in args.variants.split(",")]
    device = resolve_device("cpu" if args.no_cuda else None)
    rows = []
    for v in variants:
        rows.append(bench_variant(
            v, batch=args.batch, n_calls=args.n_calls,
            compute_dtype=args.compute_dtype, scan=args.scan, check=args.check,
            device=device))
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()

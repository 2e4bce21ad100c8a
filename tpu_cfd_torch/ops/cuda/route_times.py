"""Times the routes the port chooses between on the card, for its defaults.

Run from the root of a checkout on one card:
``python3 -m tpu_cfd_torch.ops.cuda.route_times [--sweep conv|solver|all]``.
Each sweep prints one JSON line with the card's name and power limit:

- ``conv``: the whole ``SpectralConvS`` forward plus backward (gradients of
  the input and the weights) at 64², m ∈ {8, 12, 16, 24, 32}, on two routes:
  the fused DFT kernel pair (``models/fused_conv.fused_spectral_conv_s``) and
  the ``impl="fft"`` arithmetic (``torch.fft``), at the batch, time steps and
  width of the SFNO McWilliams recipe (b 64, t 10, c 10, modes_t 5) and of
  the optimizer sweep (b 4, t 10, c 20, modes_t 5), and at the recipe's
  t and c with b 8, 16, 32 and 128 (the planes decide). ``fused_pair_wins``
  (``models/fused_conv.py``) encodes its result.
- ``convt``: the SFNO's two ``SpectralConvT`` (lifting and output) forward
  plus backward at 64², m ∈ {8, 12, 16, 24, 32}, on the dense DFT einsums
  (``_dft_apply``) and on ``torch.fft``, at the two configurations.
  ``dft_apply_wins`` (``models/sfno.py``) encodes its result.
- ``solver``: ms a step of the 256²-style solver at n ∈ {64, 128, 256, 512,
  1024} and b ∈ {8, 32, 128} on the routes ``dft_galerkin_fused``,
  ``dft_aligned_fused``, ``fft`` and ``dft_galerkin`` (``torch.matmul``).
  It checks the rule of ``recommended_fft_impl`` (``solvers/equations.py``):
  each row records the rule's route beside the fastest, and ``slow_defaults``
  lists the points where the rule's route is more than 5 % slower than the
  fastest, or ``fft`` (the rule's route where the kernel cannot step the
  run) more than 5 % slower than the fastest route without the kernel. An
  empty list after a kernel change leaves the rule standing.

Every point is the median of three rounds of CUDA events after a warm-up. A
point that runs out of device memory is recorded as such, not dropped.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys

import numpy as np
import torch

CONV_MODES = (8, 12, 16, 24, 32)
# (batch, time steps, channels, temporal modes) of the two SFNO configurations,
# and the recipe's at other batches, where the routes cross over
CONV_CASES = {"recipe": (64, 10, 10, 5), "sweep": (4, 10, 20, 5),
              **{f"recipe_b{b}": (b, 10, 10, 5) for b in (8, 16, 32, 128)}}
SOLVER_SIZES = (64, 128, 256, 512, 1024)
SOLVER_BATCHES = (8, 32, 128)
SOLVER_ROUTES = ("dft_galerkin_fused", "dft_aligned_fused", "fft", "dft_galerkin")
# a default route slower than the fastest by more than this is listed: the
# fused routes drift 1–4 % between sweeps at 64²–128², b=8
_MARGIN = 1.05


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip()


def median_ms(fn, iters: int, rounds: int = 3) -> dict:
    """ms a call: CUDA events over ``iters`` calls, after one warm-up call;
    the median and the spread of ``rounds`` rounds."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / iters)
    times.sort()
    return {"ms": times[len(times) // 2], "rounds": times}


def conv_sweep(dev: torch.device) -> dict:
    from tpu_cfd_torch.models.base import SpectralConv
    from tpu_cfd_torch.models.fused_conv import fused_spectral_conv_s
    from tpu_cfd_torch.models.sfno import SpectralConvS
    from tpu_cfd_torch.ops.cuda import spectral_conv as sc

    gen = torch.Generator(device=dev).manual_seed(0)
    n = 64
    rows = []
    for case, (b, nt, ch, mt) in CONV_CASES.items():
        for m in CONV_MODES:
            conv = SpectralConvS(ch, ch, (m, m, mt)).to(dev)
            params = list(conv.parameters())
            v = torch.randn(b, n, n, nt, ch, device=dev, generator=gen)
            v.requires_grad_(True)
            cot = torch.randn(b, n, n, nt, ch, device=dev, generator=gen)
            routes = {
                "kernels": lambda: fused_spectral_conv_s(
                    v, conv.compact_weight(), None, conv.modes),
                "fft": lambda: SpectralConv.forward(conv, v),
            }
            row = {"case": case, "n": n, "m": m, "b": b, "nt": nt, "c": ch, "mt": mt}
            for route, fwd in routes.items():
                sc.reset_launch_counts()
                row[route] = median_ms(
                    lambda f=fwd: torch.autograd.grad(f(), [v, *params], cot), 10)
                if route == "kernels":  # every launch on the fused kernels
                    row["launches"] = dict(sc.LAUNCHES)
            row["fused_pair_wins"] = row["kernels"]["ms"] < row["fft"]["ms"]
            print(f"conv {case} m={m}: kernels {row['kernels']['ms']:.4f} ms, "
                  f"fft {row['fft']['ms']:.4f} ms", file=sys.stderr, flush=True)
            rows.append(row)
            del conv, params, v, cot
            torch.cuda.empty_cache()
    return {"sweep": "conv", "what": "SpectralConvS forward + backward, ms",
            "rows": rows}


def convt_sweep(dev: torch.device) -> dict:
    """The SFNO's two SpectralConvT (the lifting's: width -> width, t_in ->
    latent steps; the output's: 1 -> 1, latent + 1 -> out + 1 steps with
    temporal padding and a bias) forward + backward, on ``_dft_apply`` (dense
    DFT einsums) and on ``torch.fft``, at 64² and the two configurations."""
    from tpu_cfd_torch.models.sfno import SpectralConvT

    gen = torch.Generator(device=dev).manual_seed(0)
    n = 64
    cases = {"recipe": (64, 10, 10, 10, 5), "sweep": (4, 20, 10, 40, 5)}
    rows = []
    for case, (b, width, latent, out_steps, mt) in cases.items():
        for m in CONV_MODES:
            for role in ("lifting", "out"):
                if role == "lifting":
                    conv = SpectralConvT(width, width, (m, m, mt), out_steps=latent)
                    shape, call = (b, n, n, 10, width), {}
                else:
                    conv = SpectralConvT(1, 1, (m, m, mt), delta=0.1, bias=True,
                                         temporal_padding=True)
                    shape, call = (b, n, n, latent + 1, 1), {"out_steps": out_steps + 1}
                conv = conv.to(dev)
                params = list(conv.parameters())
                v = torch.randn(*shape, device=dev, generator=gen).requires_grad_(True)
                with torch.no_grad():
                    cot = torch.randn_like(conv(v, **call))
                row = {"case": case, "role": role, "n": n, "m": m, "b": b,
                       "shape": list(shape), "call": call}
                for impl in ("dft", "fft"):
                    conv.impl = impl
                    row[impl] = median_ms(lambda: torch.autograd.grad(
                        conv(v, **call), [v, *params], cot), 10)
                print(f"convt {case} {role} m={m}: dft {row['dft']['ms']:.4f} ms, "
                      f"fft {row['fft']['ms']:.4f} ms", file=sys.stderr, flush=True)
                rows.append(row)
                del conv, params, v, cot
                torch.cuda.empty_cache()
    return {"sweep": "convt", "what": "SpectralConvT forward + backward, ms", "rows": rows}


def slow_defaults(rows: list) -> list:
    """The solver rows where a default route is more than ``_MARGIN`` times
    the fastest route it competes with, or was not timed: ``recommended``
    against every route, and ``fft`` against the routes without the kernel."""
    slow = []
    for row in rows:
        for default, fastest in dict.fromkeys(((row["recommended"], row["fastest"]),
                                               ("fft", row["fastest_unfused"]))):
            best = row[fastest]["ms_per_step"]
            got = row[default].get("ms_per_step")
            if got is None or got > best * _MARGIN:
                slow.append({"n": row["n"], "b": row["b"], "default": default,
                             "fastest": fastest,
                             "ratio": None if got is None else got / best})
    return slow


def solver_sweep(dev: torch.device, sizes=SOLVER_SIZES, batches=SOLVER_BATCHES) -> dict:
    from tpu_cfd_torch import grids
    from tpu_cfd_torch.solvers.equations import (NavierStokes2DSpectral,
                                                 recommended_fft_impl)

    gen = torch.Generator(device=dev).manual_seed(0)
    dt = 1e-4  # small enough to stay finite at 1024² on every route
    rows = []
    for n in sizes:
        grid = grids.Grid((n, n), domain=((0, 2 * math.pi), (0, 2 * math.pi)))
        for b in batches:
            # a smooth random field: white noise with the modes above n/8 cut
            what = torch.fft.rfft2(torch.randn(b, n, n, device=dev, generator=gen))
            k = torch.fft.fftfreq(n, 1.0 / n, device=dev).abs()
            what = what * ((k[:, None] <= n // 8) & (k[None, : n // 2 + 1] <= n // 8))
            row = {"n": n, "b": b}
            for route in SOLVER_ROUTES:
                impl = route.removesuffix("_fused")
                try:
                    ns = NavierStokes2DSpectral(viscosity=1e-3, grid=grid, fft_impl=impl,
                                                fused=route.endswith("_fused"),
                                                device=dev)
                    # steps per call: about 400 ms of work, 5 to 200 steps
                    probe = median_ms(lambda: ns.forward(what, dt, 2), 1, rounds=1)["ms"]
                    steps = int(np.clip(round(400.0 / max(probe, 1e-3)), 5, 200))
                    t = median_ms(lambda: ns.forward(what, dt, steps), 1)
                    row[route] = {"ms_per_step": t["ms"] / steps, "steps": steps,
                                  "rounds": [r / steps for r in t["rounds"]]}
                except torch.cuda.OutOfMemoryError as e:
                    row[route] = {"out_of_memory": str(e).splitlines()[0]}
                except ValueError as e:  # a route this shape does not take
                    row[route] = {"not_run": str(e)}
                ns = None
                torch.cuda.empty_cache()
            timed = {r: row[r]["ms_per_step"] for r in SOLVER_ROUTES
                     if "ms_per_step" in row[r]}
            row["fastest"] = min(timed, key=timed.get)
            row["recommended"] = recommended_fft_impl(n, b)
            row["fastest_unfused"] = min((r for r in timed if not r.endswith("_fused")),
                                         key=timed.get)
            print(f"solver n={n} b={b}: " + ", ".join(
                f"{r} {t:.4f}" for r, t in timed.items()) + " ms/step",
                file=sys.stderr, flush=True)
            rows.append(row)
            del what
            torch.cuda.empty_cache()
    return {"sweep": "solver", "what": "ms a step, RK4-CN, viscosity 1e-3",
            "rows": rows, "slow_defaults": slow_defaults(rows)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--sweep", choices=("conv", "convt", "solver", "all"),
                        default="all")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("route_times: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    for name, fn in (("conv", conv_sweep), ("convt", convt_sweep),
                     ("solver", solver_sweep)):
        if args.sweep in (name, "all"):
            print(json.dumps({**fn(dev), "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

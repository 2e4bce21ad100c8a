"""Times the hand-written spectral kernels at the main paths' shapes on one card.

Run from the root of a checkout: ``python3 -m tpu_cfd_torch.ops.cuda.kernel_times``.
It prints one JSON line: ms a launch (CUDA events over 20 launches after a
warm-up) of the RK4-CN stage's three kernels at 256², b=32, in both layouts
(main path 1's shape), of ``dft2d_inverse`` at the SFNO recipe's and the
optimizer sweep's shapes (main paths 2 and 3), of ``pointwise_ffn`` at the
recipe's (2,621,440 rows, 10 -> 40 -> 10, GELU) and the sweep's (163,840
rows, 20 -> 80 -> 20, ReLU) shapes with float32 and bfloat16 rows, and ms a
step of the fused Galerkin rollout at b=32, with the card's name and power
limit. Inputs come from a seeded generator on the card.

It calls only the wrappers' public signatures, which an older checkout of the
port shares, so a copy of this file runs unchanged there. To compare two
commits on one card, unpack the other one with ``git archive`` into a
directory that ``.gitignore`` lists, copy this file into its
``tpu_cfd_torch/ops/cuda/``, and run both in turns (old, new, new, old) in one
call.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

from tpu_cfd_torch import grids
from tpu_cfd_torch.models.fused_conv import _dft2d_constants
from tpu_cfd_torch.ops.cuda import ffn
from tpu_cfd_torch.ops.cuda import spectral_conv as sc
from tpu_cfd_torch.ops.cuda import spectral_step as ss
from tpu_cfd_torch.solvers.equations import NavierStokes2DSpectral


def _ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip()
    out = {"card": card}
    n, b = 256, 32
    grid = grids.Grid((n, n), domain=((0, 2 * np.pi), (0, 2 * np.pi)))
    for layout in ("galerkin", "aligned"):
        c = ss.constants(layout, grid, 1e-3, 0.0, 1e-3, dev)
        w = 1e-2 * torch.randn(b, c["R"], c["m"], dtype=torch.complex64, device=dev,
                               generator=gen)
        h = torch.randn_like(w)
        jc = ss.resolve_block_cols("auto", n, c["m"])
        A = ss.inverse_first(w, c)
        T = ss.advect(A, c, jc)
        out[f"inverse_first_{layout}"] = _ms(lambda: ss.inverse_first(w, c, A), 20)
        out[f"advect_{layout}"] = _ms(lambda: ss.advect(A, c, jc, T), 20)
        out[f"forward_first_{layout}"] = _ms(
            lambda: ss.forward_first(T, w.clone(), h.clone(), c, 1), 20)
    what = torch.fft.rfft2(torch.randn(b, n, n, device=dev, generator=gen))
    fused = NavierStokes2DSpectral(viscosity=1e-3, grid=grid, fft_impl="dft_galerkin",
                                   fused=True, device=dev)
    out["rollout_galerkin_b32_per_step"] = _ms(lambda: fused.forward(what, 1e-3, 50), 2) / 50
    for key, (bb, nn, m, ch) in {"": (64, 64, 32, 10), "_sweep": (4, 64, 12, 20)}.items():
        c = _dft2d_constants(nn, nn, m, m, str(dev), "complex64")
        g = torch.randn(bb, 10 * ch, 2 * m, 2 * m, dtype=torch.complex64, device=dev,
                        generator=gen)
        out["dft2d_inverse" + key] = _ms(lambda: sc.inverse(g, 1.0 / (nn * nn * 10), c), 20)
    for key, (rows, k, act) in {"recipe": (64 * 64 * 64 * 10, 10, "GELU"),
                                "sweep": (4 * 64 * 64 * 10, 20, "ReLU")}.items():
        x = torch.randn(rows, k, device=dev, generator=gen)
        w = [a * torch.randn(*s, device=dev, generator=gen) for s, a in (
            ((4 * k, k), 0.3), ((4 * k,), 0.1), ((k, 4 * k), 0.15), ((k,), 0.1))]
        for tag, xr in (("", x), ("_bf16", x.bfloat16())):
            out[f"ffn_{key}{tag}"] = _ms(lambda: ffn.ffn_forward(xr, *w, act), 20)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

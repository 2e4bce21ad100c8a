#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``tpu_cfd_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and the CUDA toolkit (``nvcc``), and exits non-zero,
printing no result, when either is missing or any phase fails:

1. prints the card (``nvidia-smi`` name and power limit) and the versions;
2. builds the spectral-step kernels from ``tpu_cfd_torch/ops/cuda/csrc``;
3. holds each kernel, and the whole fused rollout in both layouts, against
   its plain PyTorch version on the same CUDA tensors at 256²;
4. drives the main path, ``python -m tpu_cfd_torch.data.generate
   mcwilliams`` at 256², batch 32, 100 warmup + 91 recorded steps, checks
   the dataset, and checks from the launch counters that the kernels did
   the stepping;
5. times each kernel and the rollout (Galerkin b=32 and b=8, aligned b=32,
   100 steps) beside its bound, its plain version and the unfused
   ``torch.matmul`` dense-DFT and ``torch.fft`` solver paths.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

N = 256
DT = 1e-3
# NVIDIA H100 SXM data sheet: fp32 outside the tensor cores, HBM3 rate
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
ROLLOUT_TOL = 5e-6   # rel-L2, kernel vs plain over 10 steps (fp32 sum order)
KERNEL_TOL = 1e-5    # max abs error / max |plain|, one launch
REFERENCE_TOL = 1e-4  # rel-L2, fp32 fused rollout vs fp64 torch.fft, 20 steps
SOURCE = "tpu_cfd_torch/ops/cuda/csrc/spectral_step.cu"
REPLACES = "tpu_cfd/ops/pallas/spectral_step.py:104"


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import numpy as np

    from tpu_cfd_torch import grids
    from tpu_cfd_torch.data import generate
    from tpu_cfd_torch.ops import dft2d
    from tpu_cfd_torch.ops.cuda import _build, spectral_step as ss
    from tpu_cfd_torch.ops.spectral import brick_wall_filter_2d
    from tpu_cfd_torch.solvers import forcings, initial_conditions as ic
    from tpu_cfd_torch.solvers.equations import NavierStokes2DSpectral

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _card_line()
    print(card, flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    _build.build("spectral_step", force=True)
    ss._lib()
    print(f"build: spectral_step.cu in {time.perf_counter() - t0:.2f} s",
          flush=True)

    grid = grids.Grid((N, N), domain=((0, 2 * np.pi), (0, 2 * np.pi)))

    def initial_spectrum(b: int, seed: int = 0):
        noise = torch.stack([
            torch.randn(grid.shape, device=dev,
                        generator=ic.sample_generator(seed, i, dev))
            for i in range(b)])
        return torch.fft.rfft2(ic.vorticity_field(grid, 4, noise=noise).data)

    def rel(a, b) -> float:
        return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))

    def cuda_ms(fn, iters: int) -> float:
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / iters

    # -- 3a. whole rollouts: kernel vs plain, both layouts ------------------
    what4 = initial_spectrum(4)
    for layout in ("galerkin", "aligned"):
        for forced in (False, True):
            kw = (dict(viscosity=1e-2, drag=0.1, forcing_fn=forcings.KolmogorovForcing(
                grid=grid, wave_number=4)) if forced else dict(viscosity=1e-3))
            for prec in dft2d.PRECISIONS:
                ns = NavierStokes2DSpectral(
                    grid=grid, fft_impl=f"dft_{layout}", fused=True,
                    mxu_precision=prec, device=dev, **kw)
                w = ns._align(what4)
                f_hat = (ns._explicit_terms(w.new_zeros(w.shape[-2:]))
                         if forced else None)
                c = ss.constants(layout, grid, ns.viscosity, ns.drag, DT, dev, f_hat)
                jc = ss.resolve_block_cols("auto", N, c["m"])
                got = ss._fused_rollout(
                    w, layout=layout, grid=grid, viscosity=ns.viscosity,
                    drag=ns.drag, dt=DT, steps=10, forcing_hat=f_hat,
                    precision=prec, block_cols="auto")
                torch.cuda.synchronize()
                want = ss._fused_rollout_plain(w, c, 10, jc)
                torch.cuda.synchronize()
                err = rel(got, want)
                print(f"rollout {layout} forced={forced} precision={prec}: "
                      f"rel-L2 kernel vs plain {err:.3e} (tol {ROLLOUT_TOL})",
                      flush=True)
                _require(bool(torch.isfinite(got).all()), "finite rollout")
                _require(err < ROLLOUT_TOL, f"{layout} rollout vs plain")

    # -- 3b. each kernel vs its plain version at the main path's shapes -----
    B = 32
    c = ss.constants("galerkin", grid, 1e-3, 0.0, DT, dev)
    jc = ss.resolve_block_cols("auto", N, c["m"])
    w = NavierStokes2DSpectral(viscosity=1e-3, grid=grid, fft_impl="dft_galerkin",
                               device=dev)._align(initial_spectrum(B))
    w = w.contiguous()
    A = ss._inverse_first_plain(w, c)
    T = ss._advect_plain(A, c)
    h = torch.randn_like(w) * w.abs().mean()
    wk, hk = w.clone(), h.clone()  # forward_first updates these in place
    R, m = c["R"], c["m"]
    kernels = {
        "spectral_inverse_first": (
            lambda: ss.inverse_first(w, c),
            lambda: ss._inverse_first_plain(w, c),
            # flops: 4 fields x complex (n x R)(R x m); bytes: w, G, cf, A
            B * 32 * N * R * m,
            B * R * m * 8 + N * R * 8 + 4 * R * m * 4 + B * 4 * N * m * 8,
            "inverse_first"),
        "spectral_advect": (
            lambda: ss.advect(A, c, jc),
            lambda: ss._advect_plain(A, c),
            # 4 last-axis inverses (16 n^2 m) + one forward (4 n^2 m)
            B * 20 * N * N * m,
            B * 4 * N * m * 8 + 2 * m * N * 4 + N * m * 8 + B * N * m * 8,
            "advect"),
        "spectral_forward_first": (
            lambda: ss.forward_first(T, wk, hk, c, 1),
            lambda: ss._forward_first_plain(T, w, h, c, 1),
            # complex (R x n)(n x m) + the per-mode update
            B * (8 * N * R * m + 16 * R * m),
            B * N * m * 8 + R * N * 8 + R * m * (3 * 4 + 8) + 4 * B * R * m * 8,
            "forward_first"),
    }
    results = {}
    for name, (kern, plain, flops, nbytes, key) in kernels.items():
        got = kern()
        want = plain()
        if isinstance(got, tuple):  # forward_first returns (w, h)
            got, want = torch.cat([g.flatten() for g in got]), torch.cat(
                [p.flatten() for p in want])
        torch.cuda.synchronize()
        max_abs = float((got - want).abs().max())
        scale = float(want.abs().max())
        print(f"kernel {name}: max abs err {max_abs:.3e} (max |plain| "
              f"{scale:.3e}, tol {KERNEL_TOL} of it)", flush=True)
        _require(max_abs <= KERNEL_TOL * scale, f"{name} vs plain")
        results[name] = dict(max_abs_err=max_abs, flops=flops, bytes=nbytes, key=key)

    # -- 3c. agreement with an independent reference on a small input ------
    # on the 2/3-rule support both dynamics are the same, so filter the IC
    what2 = initial_spectrum(2, seed=1) * brick_wall_filter_2d(grid, device=dev)
    ref = NavierStokes2DSpectral(viscosity=1e-3, grid=grid, fft_impl="fft",
                                 dtype=torch.float64, device=dev
                                 ).forward(what2.to(torch.complex128), DT, 20)[0]
    fus = NavierStokes2DSpectral(viscosity=1e-3, grid=grid, fft_impl="dft_galerkin",
                                 fused=True, device=dev).forward(what2, DT, 20)[0]
    err = rel(fus.to(torch.complex128), ref)
    print(f"reference: fused galerkin fp32 vs torch.fft fp64, 20 steps, "
          f"rel-L2 {err:.3e} (tol {REFERENCE_TOL})", flush=True)
    _require(err < REFERENCE_TOL, "fused rollout vs fp64 torch.fft reference")

    # -- 4. the main path --------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--grid-size", str(N), "--subsample", "4", "--batch-size", "32",
                "--num-samples", "32", "--time", "0.2", "--time-warmup", "0.1",
                "--dt", str(DT), "--num-steps", "10", "--filepath", tmp]
        ss.reset_launch_counts()
        t0 = time.perf_counter()
        path = generate.main_mcwilliams(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ss.LAUNCHES)
        with np.load(path) as z:
            vort = z["vorticity"]
        with open(path + ".meta.json") as f:
            meta = json.load(f)
    # warmup 100 steps; records land 1 step in, then every 10: 1 + 9 * 10
    steps = 100 + 1 + 9 * 10
    print(f"main path: mcwilliams 256^2 b32, {steps} steps in {wall:.2f} s "
          f"(build excluded), launches {launches}, fft_impl {meta['fft_impl']}, "
          f"records {vort.shape}", flush=True)
    _require(vort.shape == (32, 10, 64, 64), f"dataset shape {vort.shape}")
    _require(bool(np.isfinite(vort).all()), "finite dataset")
    enstrophy = (vort.astype(np.float64) ** 2).mean(axis=(0, 2, 3))
    print(f"main path: mean enstrophy first/last record {enstrophy[0]:.6e} / "
          f"{enstrophy[-1]:.6e}", flush=True)
    _require(enstrophy[-1] < enstrophy[0], "enstrophy decays")
    _require(meta["fft_impl"] == "dft_galerkin_fused", "main path took the kernel")
    for key in ("inverse_first", "advect", "forward_first"):
        _require(launches[key] == steps * 5, f"{key} launched {launches[key]} "
                 f"times, expected {steps * 5}")

    # -- 5. timings ----------------------------------------------------------
    for name, r in results.items():
        kern, plain = kernels[name][0], kernels[name][1]
        r["ms"] = cuda_ms(kern, 20)
        r["plain_ms"] = cuda_ms(plain, 20)
        r["bound_ms"] = 1e3 * max(r["bytes"] / HBM_BYTES_PER_S,
                                  r["flops"] / FP32_FLOPS)
        r["bound_by"] = ("bytes" if r["bytes"] / HBM_BYTES_PER_S
                         > r["flops"] / FP32_FLOPS else "operations")
        print(f"time {name} b32: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)

    rollouts = []
    steps = 100
    for layout, b in (("galerkin", 32), ("galerkin", 8), ("aligned", 32)):
        what = initial_spectrum(b)
        fused = NavierStokes2DSpectral(viscosity=1e-3, grid=grid,
                                       fft_impl=f"dft_{layout}", fused=True,
                                       device=dev)
        wb = fused._align(what).contiguous()
        cb = ss.constants(layout, grid, 1e-3, 0.0, DT, dev)
        jcb = ss.resolve_block_cols("auto", N, cb["m"])
        row = {"layout": layout, "n": N, "batch": b, "steps": steps}
        row["ms_per_step"] = cuda_ms(lambda: fused.forward(what, DT, steps), 1) / steps
        row["plain_ms_per_step"] = cuda_ms(
            lambda: ss._fused_rollout_plain(wb, cb, steps, jcb), 1) / steps
        lib = {}
        for impl in (f"dft_{layout}", "fft"):
            ns = NavierStokes2DSpectral(viscosity=1e-3, grid=grid, fft_impl=impl,
                                        device=dev)
            lib[impl] = cuda_ms(lambda: ns.forward(what, DT, steps), 1) / steps
        row["library_ms_per_step"] = lib
        row["bound_ms_per_step"] = (
            1e3 * b * ss.flops_per_sample_step(layout, N) / FP32_FLOPS)
        row["sample_steps_per_s"] = b / (row["ms_per_step"] * 1e-3)
        print(f"time rollout {layout} b{b}: kernel {row['ms_per_step']:.4f} ms/step "
              f"({row['sample_steps_per_s']:.1f} sample-steps/s), bound "
              f"{row['bound_ms_per_step']:.4f}, plain {row['plain_ms_per_step']:.4f}, "
              f"torch.matmul dft_{layout} {lib[f'dft_{layout}']:.4f}, torch.fft "
              f"{lib['fft']:.4f} ms/step", flush=True)
        rollouts.append(row)

    line = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES,
         "launches": launches[r["key"]], "max_abs_err": r["max_abs_err"],
         "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": None}
        for name, r in results.items()], "rollouts": rollouts, "card": card}
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())

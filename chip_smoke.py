#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``tpu_cfd_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and the CUDA toolkit (``nvcc``), and exits non-zero,
printing no result, when either is missing or any phase fails:

1. prints the card (``nvidia-smi`` name and power limit) and the versions;
2. builds the three CUDA sources of ``tpu_cfd_torch/ops/cuda/csrc`` with one
   ``nvcc`` each, all at once;
3. holds each spectral-step kernel, and the whole fused rollout in both
   layouts, against its plain PyTorch version on the same CUDA tensors at
   256², and the fused rollout against the fp64 ``torch.fft`` solver;
4. drives the first main path, ``python -m tpu_cfd_torch.data.generate
   mcwilliams`` at 256² → 64², 128 samples, batch 32, 100 warmup + 291
   recorded steps (30 records), checks the dataset, and checks from the
   launch counters that the spectral-step kernels did the stepping;
5. holds the SFNO kernels against their plain versions at the McWilliams
   recipe's shapes: the DFT pair (``dft2d_modes``, ``dft2d_inverse``)
   forward and backward, also at 256², b=2, and against ``torch.fft``
   where 2m = n; ``pointwise_ffn`` forward (its backward is plain PyTorch);
6. drives the second main path, ``python -m tpu_cfd_torch.train.train`` at
   the McWilliams recipe (16,469,791 parameters, batch 64, 2 epochs) on
   that dataset, checks the losses, and checks from the launch counters
   that every SpectralConvS and PointwiseFFN ran through the kernels;
7. times every kernel beside its bound, its plain version and the library
   call, the rollouts, and the SFNO train step by three routes (kernels,
   ``impl="fft"``, plain versions).

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

N = 256
DT = 1e-3
# NVIDIA H100 SXM data sheet: fp32 outside the tensor cores, HBM3 rate
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
ROLLOUT_TOL = 5e-6   # rel-L2, kernel vs plain over 10 steps (fp32 sum order)
KERNEL_TOL = 1e-5    # max abs error / max |plain|, one launch
REFERENCE_TOL = 1e-4  # rel-L2, fp32 fused rollout vs fp64 torch.fft, 20 steps
FFT_TOL = 1e-4       # max abs error / max |fft|, DFT pair vs torch.fft at 2m = n
CSRC = "tpu_cfd_torch/ops/cuda/csrc/"
# the SFNO McWilliams recipe (README; tpu_cfd/train/train.py)
RECIPE = dict(b=64, n=64, nt=10, width=10, modes=32, modes_t=5, layers=4)
RECIPE_PARAMS = 16_469_791


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


@contextlib.contextmanager
def plain_versions(sc, ffn_ops):
    """Routes the SFNO kernels' wrappers to their plain versions, in the
    autograd Functions' forwards and backwards alike, for the yardsticks."""
    saved = sc.modes, sc.inverse, ffn_ops.ffn_forward
    sc.modes, sc.inverse = sc._modes_plain, sc._inverse_plain
    ffn_ops.ffn_forward = ffn_ops._ffn_plain
    try:
        yield
    finally:
        sc.modes, sc.inverse, ffn_ops.ffn_forward = saved


def _bound(flops: float, nbytes: float) -> dict:
    t_ops, t_bytes = flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "bytes" if t_bytes > t_ops else "operations"}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import numpy as np
    import torch.nn.functional as F

    from tpu_cfd_torch import grids
    from tpu_cfd_torch.data import generate
    from tpu_cfd_torch.models import SFNO, init_like_flax
    from tpu_cfd_torch.models.fused_conv import _dft2d_constants
    from tpu_cfd_torch.ops import dft2d
    from tpu_cfd_torch.ops.cuda import _build, ffn as ffn_ops
    from tpu_cfd_torch.ops.cuda import spectral_conv as sc, spectral_step as ss
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

    # -- 2. build: one nvcc per source, all started together ---------------
    t0 = time.perf_counter()
    sources = ("spectral_step", "spectral_conv", "ffn")
    with ThreadPoolExecutor(len(sources)) as pool:
        for name, fut in [(s, pool.submit(_build.build, s, (), True)) for s in sources]:
            print(f"build: {name}.cu -> {fut.result().name}", flush=True)
    ss._lib(), sc._lib(), ffn_ops._lib()
    print(f"build: {len(sources)} sources in {time.perf_counter() - t0:.2f} s",
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

    def max_err(got, want):
        got, want = torch.as_tensor(got), torch.as_tensor(want)
        return float((got - want).abs().max()), float(want.abs().max())

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

    # -- 3b. each spectral-step kernel vs its plain version -----------------
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
            B * R * m * 8 + N * R * 8 + 4 * R * m * 4 + B * 4 * N * m * 8),
        "spectral_advect": (
            lambda: ss.advect(A, c, jc),
            lambda: ss._advect_plain(A, c),
            # 4 last-axis inverses (16 n^2 m) + one forward (4 n^2 m)
            B * 20 * N * N * m,
            B * 4 * N * m * 8 + 2 * m * N * 4 + N * m * 8 + B * N * m * 8),
        "spectral_forward_first": (
            lambda: ss.forward_first(T, wk, hk, c, 1),
            lambda: ss._forward_first_plain(T, w, h, c, 1),
            # complex (R x n)(n x m) + the per-mode update
            B * (8 * N * R * m + 16 * R * m),
            B * N * m * 8 + R * N * 8 + R * m * (3 * 4 + 8) + 4 * B * R * m * 8),
    }
    results = {}
    for name, (kern, plain, flops, nbytes) in kernels.items():
        got = kern()
        want = plain()
        if isinstance(got, tuple):  # forward_first returns (w, h)
            got, want = torch.cat([g.flatten() for g in got]), torch.cat(
                [p.flatten() for p in want])
        torch.cuda.synchronize()
        max_abs, scale = max_err(got, want)
        print(f"kernel {name}: max abs err {max_abs:.3e} (max |plain| "
              f"{scale:.3e}, tol {KERNEL_TOL} of it)", flush=True)
        _require(max_abs <= KERNEL_TOL * scale, f"{name} vs plain")
        results[name] = dict(max_abs_err=max_abs)

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

    tmp_ctx = tempfile.TemporaryDirectory()
    tmp = tmp_ctx.name
    # -- 4. main path 1: the training dataset, generated on the card --------
    argv = ["--grid-size", str(N), "--subsample", "4", "--batch-size", "32",
            "--num-samples", "128", "--time", "0.4", "--time-warmup", "0.1",
            "--dt", str(DT), "--num-steps", "30", "--filepath", tmp]
    ss.reset_launch_counts()
    t0 = time.perf_counter()
    data_path = generate.main_mcwilliams(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    gen_launches = dict(ss.LAUNCHES)
    with np.load(data_path) as z:
        vort = z["vorticity"]
    with open(data_path + ".meta.json") as f:
        meta = json.load(f)
    # per batch: 100 warmup steps; 30 records, 1 step in then every 10
    steps = 4 * (100 + 1 + 29 * 10)
    print(f"main path 1: mcwilliams 256^2->64^2, 128 samples b32, {steps} steps "
          f"in {wall:.2f} s (build excluded), launches {gen_launches}, "
          f"fft_impl {meta['fft_impl']}, records {vort.shape}", flush=True)
    _require(vort.shape == (128, 30, 64, 64), f"dataset shape {vort.shape}")
    _require(bool(np.isfinite(vort).all()), "finite dataset")
    enstrophy = (vort.astype(np.float64) ** 2).mean(axis=(0, 2, 3))
    print(f"main path 1: mean enstrophy first/last record {enstrophy[0]:.6e} / "
          f"{enstrophy[-1]:.6e}", flush=True)
    _require(enstrophy[-1] < enstrophy[0], "enstrophy decays")
    _require(meta["fft_impl"] == "dft_galerkin_fused", "main path took the kernel")
    for key in ("inverse_first", "advect", "forward_first"):
        _require(gen_launches[key] == steps * 5, f"{key} launched "
                 f"{gen_launches[key]} times, expected {steps * 5}")

    # -- 5. the SFNO kernels vs their plain versions ------------------------
    rb, rn, rt, rw, rm = (RECIPE[k] for k in ("b", "n", "nt", "width", "modes"))
    planes = rb * rt * rw
    gen = torch.Generator(device=dev).manual_seed(0)

    def dft_inputs(b, n):
        cc = _dft2d_constants(n, n, rm, rm, str(dev), "complex64")
        v = torch.randn(b, rt * rw, n, n, device=dev, generator=gen)
        g = torch.randn(b, rt * rw, 2 * rm, 2 * rm, dtype=torch.complex64,
                        device=dev, generator=gen)
        return cc, v, g, 1.0 / (n * n * rt)

    def check(name, got, want):
        max_abs, scale = max_err(got, want)
        print(f"kernel {name}: max abs err {max_abs:.3e} (max |plain| "
              f"{scale:.3e}, tol {KERNEL_TOL} of it)", flush=True)
        _require(max_abs <= KERNEL_TOL * scale, f"{name} vs plain")
        return max_abs

    def grads(fn, inputs, cot):
        xs = [x.detach().clone().requires_grad_(True) for x in inputs]
        out = fn(*xs)
        return torch.autograd.grad(out, xs, cot)

    for b, n in ((rb, rn), (2, 256)):
        cc, v, g, scale = dft_inputs(b, n)
        tag = f"{n}^2 b{b}"
        e_m = check(f"dft2d_modes {tag}", sc.modes(v, cc), sc._modes_plain(v, cc))
        e_i = check(f"dft2d_inverse {tag}", sc.inverse(g, scale, cc),
                    sc._inverse_plain(g, scale, cc))
        # each backward launches the partner kernel
        for nm, fn, x, cot in (
                ("dft2d_modes", lambda x: sc.dft2d_modes(x, cc), v, g * 1e-3),
                ("dft2d_inverse", lambda x: sc.dft2d_inverse(x, scale, cc), g,
                 torch.randn_like(v))):
            k_grad = grads(fn, [x], cot)[0]
            with plain_versions(sc, ffn_ops):
                p_grad = grads(fn, [x], cot)[0]
            check(f"{nm} backward {tag}", k_grad, p_grad)
        if n == rn:
            results["dft2d_modes"] = dict(max_abs_err=e_m)
            results["dft2d_inverse"] = dict(max_abs_err=e_i)
            modes_in, inverse_in, recipe_c, recipe_scale = v, g, cc, scale
    # an independent reference where 2m = n: torch.fft
    fft_modes = lambda: torch.fft.fft2(modes_in).transpose(-1, -2)  # noqa: E731
    fft_inverse = lambda: torch.fft.ifft2(  # noqa: E731
        inverse_in.transpose(-1, -2)).real * (recipe_scale * rn * rn)
    for nm, got, want in (
            ("dft2d_modes", sc.modes(modes_in, recipe_c), fft_modes()),
            ("dft2d_inverse", sc.inverse(inverse_in, recipe_scale, recipe_c),
             fft_inverse())):
        max_abs, ref_scale = max_err(got, want)
        print(f"reference: {nm} {rn}^2 vs torch.fft, max abs err {max_abs:.3e} "
              f"(max |fft| {ref_scale:.3e}, tol {FFT_TOL} of it)", flush=True)
        _require(max_abs <= FFT_TOL * ref_scale, f"{nm} vs torch.fft")

    hidden = 4 * rw
    rows = rb * rn * rn * rt
    fx = torch.randn(rb, rn, rn, rt, rw, device=dev, generator=gen)
    fw = [torch.randn(*s, device=dev, generator=gen) * a for s, a in (
        ((hidden, rw), 0.3), ((hidden,), 0.1), ((rw, hidden), 0.15), ((rw,), 0.1))]
    x2 = fx.reshape(-1, rw)
    # forward only: the FFN's backward is plain PyTorch on either route
    results["pointwise_ffn"] = dict(max_abs_err=check(
        f"pointwise_ffn {rows} rows", ffn_ops.ffn_forward(x2, *fw, "GELU"),
        ffn_ops._ffn_plain(x2, *fw, "GELU")))

    # -- 6. main path 2: SFNO training at the McWilliams recipe -------------
    # the CLI's output paths are read when its modules are imported
    for var in ("MODEL_PATH", "LOG_PATH", "DATA_PATH", "FIG_PATH"):
        os.environ[var] = os.path.join(tmp, var.lower())
    from tpu_cfd_torch.train import losses, pipeline as tpipe, train

    targv = ["--example", "McWilliams2d", "--train-file", data_path,
             "--res", str(rn), "--modes", str(rm), "--modes-t", str(RECIPE["modes_t"]),
             "--width", str(rw), "--num-layers", str(RECIPE["layers"]),
             "--time-steps", str(rt), "--out-time-steps", str(rt),
             "--batch-size", str(rb), "--activation", "GELU", "--epochs", "2",
             "--num-samples", "128", "--num-val-samples", "64", "--train-only"]
    sc.reset_launch_counts()
    ffn_ops.reset_launch_counts()
    t0 = time.perf_counter()
    run = train.main(targv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    train_launches = {**sc.LAUNCHES, **ffn_ops.LAUNCHES}
    hist = run["history"]
    print(f"main path 2: train.main at the recipe, {run['n_params']} parameters, "
          f"2 epochs x 2 steps + 2 val batches in {wall:.2f} s, launches "
          f"{train_launches}, history {hist}", flush=True)
    _require(run["n_params"] == RECIPE_PARAMS, f"parameter count {run['n_params']}")
    _require(all(np.isfinite([hh["train"] for hh in hist] + [hh["val"] for hh in hist]))
             and len(hist) == 2, "finite train and val losses")
    train_steps, val_batches = 4, 2
    per_step = {"modes": 6, "inverse": 6, "ffn": 4}
    per_eval = {"modes": 3, "inverse": 3, "ffn": 4}
    for key in per_step:
        want = train_steps * per_step[key] + val_batches * per_eval[key]
        _require(train_launches[key] == want,
                 f"{key} launched {train_launches[key]} times, expected {want}")

    # -- 7. timings -----------------------------------------------------------
    # the DFT pair's floor counts an FFT's operations (sc.flops), not the
    # dense contraction the kernels do: at 2m = n it is bound by bytes
    dft_flops = sc.flops(planes, rn, rn, 2 * rm, 2 * rm)
    dft_bytes = planes * rn * rn * 4 + planes * 4 * rm * rm * 8
    ffn_flops = ffn_ops.flops(rows, rw, hidden, rw)
    ffn_bytes = rows * 2 * rw * 4 + sum(t.numel() for t in fw) * 4
    chain = lambda: F.linear(F.gelu(F.linear(x2, fw[0], fw[1]), approximate="tanh"),  # noqa: E731
                             fw[2], fw[3])
    # name: (kernel, plain version, library call or None, flops, bytes)
    timed = {name: (kern, plain, None, flops, nbytes)
             for name, (kern, plain, flops, nbytes) in kernels.items()}
    timed.update({
        "dft2d_modes": (lambda: sc.modes(modes_in, recipe_c),
                        lambda: sc._modes_plain(modes_in, recipe_c), fft_modes,
                        dft_flops, dft_bytes),
        "dft2d_inverse": (lambda: sc.inverse(inverse_in, recipe_scale, recipe_c),
                          lambda: sc._inverse_plain(inverse_in, recipe_scale, recipe_c),
                          fft_inverse, dft_flops, dft_bytes),
        "pointwise_ffn": (lambda: ffn_ops.ffn_forward(x2, *fw, "GELU"),
                          lambda: ffn_ops._ffn_plain(x2, *fw, "GELU"), None,
                          ffn_flops, ffn_bytes),
    })
    for name, (kern, plain, lib, flops, nbytes) in timed.items():
        r = results[name]
        r["ms"] = cuda_ms(kern, 20)
        r["plain_ms"] = cuda_ms(plain, 20)
        r["library_ms"] = cuda_ms(lib, 20) if lib is not None else None
        r.update(_bound(flops, nbytes))
    chain_ms = cuda_ms(chain, 20)
    for name, r in results.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"time {name}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library {lib} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})",
              flush=True)
    print(f"time pointwise_ffn as F.linear -> gelu -> F.linear (information): "
          f"{chain_ms:.4f} ms", flush=True)

    rollouts = []
    rsteps = 100
    for layout, b in (("galerkin", 32), ("galerkin", 8), ("aligned", 32)):
        what = initial_spectrum(b)
        fused = NavierStokes2DSpectral(viscosity=1e-3, grid=grid,
                                       fft_impl=f"dft_{layout}", fused=True,
                                       device=dev)
        wb = fused._align(what).contiguous()
        cb = ss.constants(layout, grid, 1e-3, 0.0, DT, dev)
        jcb = ss.resolve_block_cols("auto", N, cb["m"])
        row = {"layout": layout, "n": N, "batch": b, "steps": rsteps}
        row["ms_per_step"] = cuda_ms(lambda: fused.forward(what, DT, rsteps), 1) / rsteps
        row["plain_ms_per_step"] = cuda_ms(
            lambda: ss._fused_rollout_plain(wb, cb, rsteps, jcb), 1) / rsteps
        lib = {}
        for impl in (f"dft_{layout}", "fft"):
            ns = NavierStokes2DSpectral(viscosity=1e-3, grid=grid, fft_impl=impl,
                                        device=dev)
            lib[impl] = cuda_ms(lambda: ns.forward(what, DT, rsteps), 1) / rsteps
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

    def profile_steps(route, fn, steps: int) -> dict:
        """torch.profiler over ``steps`` calls: device busy share, top kernels."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0) / steps
        kern = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                      key=lambda e: -e.self_device_time_total)
        busy_ms = sum(e.self_device_time_total for e in kern) / 1e3 / steps
        ours = sum(e.self_device_time_total for e in kern
                   if "bgemm_kernel" in e.key or "ffn_kernel" in e.key) / 1e3 / steps
        top = [(e.key[:90], e.self_device_time_total / 1e3 / steps, e.count / steps)
               for e in kern[:12]]
        print(f"profile {route}: device busy {busy_ms:.3f} of {wall_ms:.3f} ms/step "
              f"(profiled), share {busy_ms / wall_ms:.3f}; hand-written SFNO kernels "
              f"{ours:.3f} ms/step", flush=True)
        for name, ms_, count in top:
            print(f"profile {route}:   {ms_:8.3f} ms/step  x{count:5.1f}  {name}",
                  flush=True)
        return {"busy_ms_per_step": busy_ms, "wall_ms_per_step": wall_ms,
                "sfno_kernels_ms_per_step": ours}

    # the SFNO train step at the recipe, three routes, same parameters
    with np.load(data_path) as z:
        frames = torch.from_numpy(np.moveaxis(z["vorticity"][:rb], 1, -1)).to(dev)
    inp, target = frames[..., :rt].contiguous(), frames[..., rt:2 * rt].contiguous()
    loss_fn = losses.SobolevLoss(n_grid=rn, norm_order=0.0, relative=True)
    base = train.build_model(train.get_parser().parse_args(targv))
    init_like_flax(base, torch.Generator().manual_seed(0))
    kernel_bound_ms = (6 * results["dft2d_modes"]["bound_ms"]
                       + 6 * results["dft2d_inverse"]["bound_ms"]
                       + 4 * results["pointwise_ffn"]["bound_ms"])
    train_rows = []
    iters = 10

    def train_route(route: str) -> dict:
        model = train.build_model(train.get_parser().parse_args(targv))
        if route == "fft":
            model = SFNO(modes_x=rm, modes_y=rm, modes_t=RECIPE["modes_t"], width=rw,
                         num_spectral_layers=RECIPE["layers"], output_steps=rt,
                         activation="GELU", beta=0.0, impl="fft")
        model.load_state_dict(base.state_dict())
        model.to(dev)
        opt = tpipe.get_optimizer("Adam", model.parameters(), 1e-3)
        step = tpipe.make_train_step(model, loss_fn, opt)
        for _ in range(2):
            step(inp, target)
        torch.cuda.synchronize()
        sc.reset_launch_counts()
        ffn_ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(iters):
            loss = step(inp, target)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / iters
        counts = {**sc.LAUNCHES, **ffn_ops.LAUNCHES}
        _require(bool(torch.isfinite(loss)), f"finite loss on the {route} route")
        if route == "kernels":
            for key in per_step:
                _require(counts[key] == iters * per_step[key],
                         f"{key}: {counts[key]} launches in {iters} steps")
        row = {"route": route, "ms_per_step": ms, "samples_per_s": rb / (ms * 1e-3),
               "launches_per_step": {k: v / iters for k, v in counts.items()},
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "loss": float(loss)}
        print(f"time train step {route}: {ms:.3f} ms/step, {row['samples_per_s']:.1f} "
              f"samples/s, peak {row['peak_gib']:.2f} GiB, launches/step "
              f"{row['launches_per_step']}", flush=True)
        row["profile"] = profile_steps(route, lambda: step(inp, target), 3)
        return row

    for route in ("kernels", "fft"):
        train_rows.append(train_route(route))
    with plain_versions(sc, ffn_ops):
        train_rows.append(train_route("plain"))
    print(f"time train step: kernels' bound {kernel_bound_ms:.3f} ms/step "
          f"(6 modes + 6 inverse + 4 ffn launches)", flush=True)
    tmp_ctx.cleanup()

    sources = {"spectral_inverse_first": ("spectral_step", "inverse_first"),
               "spectral_advect": ("spectral_step", "advect"),
               "spectral_forward_first": ("spectral_step", "forward_first"),
               "dft2d_modes": ("spectral_conv", "modes"),
               "dft2d_inverse": ("spectral_conv", "inverse"),
               "pointwise_ffn": ("ffn", "ffn")}
    replaces = {"spectral_step": "tpu_cfd/ops/pallas/spectral_step.py:104",
                "dft2d_modes": "tpu_cfd/models/pallas_conv.py:82",
                "dft2d_inverse": "tpu_cfd/models/pallas_conv.py:104",
                "pointwise_ffn": "tpu_cfd/ops/pallas/ffn.py:33"}
    launches = {**{("spectral_step", k): v for k, v in gen_launches.items()},
                **{("spectral_conv", k): v for k, v in train_launches.items()
                   if k in sc.LAUNCHES},
                ("ffn", "ffn"): train_launches["ffn"]}
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": CSRC + src + ".cu",
         "replaces": replaces.get(name, replaces.get(src)),
         "launches": launches[(src, key)], "max_abs_err": r["max_abs_err"],
         "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        for name, r in results.items() for src, key in [sources[name]]],
        "rollouts": rollouts, "train_steps": train_rows,
        "train_step_kernel_bound_ms": kernel_bound_ms,
        "ffn_chain_ms": chain_ms, "card": card}
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())

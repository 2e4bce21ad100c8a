#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``tpu_cfd_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and the CUDA toolkit (``nvcc``), and exits non-zero,
printing no result, when either is missing or any phase fails:

1. prints the card (``nvidia-smi`` name and power limit) and the versions;
2. builds the four CUDA sources of ``tpu_cfd_torch/ops/cuda/csrc`` with one
   ``nvcc`` each, all at once;
3. holds each spectral-step kernel, and the whole fused rollout in both
   layouts, against its plain PyTorch version on the same CUDA tensors at
   256², and the fused rollout against the fp64 ``torch.fft`` solver;
4. drives the first main path, ``python -m tpu_cfd_torch.data.generate
   mcwilliams`` at 256² → 64², 128 samples, batch 32, 100 warmup + 291
   recorded steps (30 records), checks the dataset, and checks from the
   launch counters that the spectral-step kernels did the stepping;
5. holds the SFNO kernels against their plain versions at the shapes the
   main paths give them, the McWilliams recipe's and the optimizer sweep's:
   the DFT pair (``dft2d_modes``, ``dft2d_inverse``) forward and backward,
   where 2m = n (64², b=64), at 256² (b=2) and where 2m < n (m=12, 64², b=4,
   200 planes), and at 64² against ``torch.fft`` too, with both transforms
   on their fused tensor-core kernels at 64² and on two passes at 256²
   (checked by count); ``pointwise_ffn`` forward (its
   backward is plain PyTorch) at 10 → 40 → 10 with GELU and at 20 → 80 → 20
   with ReLU, each with float32 and with bfloat16 rows; the multi-tensor
   Adam over three steps on the 52 leaves of each SFNO in one launch a step,
   on sizes 1, 3, 10, 4097 and 1,024,000 with aligned and unaligned
   pointers, on 104 leaves in two launches a step, leaf by leaf
   (``adam_step``), and against ``torch.optim.Adam``;
6. drives the second main path, ``python -m tpu_cfd_torch.train.train`` at
   the McWilliams recipe's widths and the throughput batch 64 (16,469,791
   parameters, 2 epochs; the accuracy run trains at batch 4) on
   that dataset, checks the losses, and checks from the launch counters
   that every PointwiseFFN ran through its kernel and every SpectralConvS
   took the route ``fused_pair_wins`` names for the recipe's shape (the DFT
   kernel pair, each transform on its fused kernel, or the ``torch.fft``
   arithmetic);
7. times every kernel beside its bound (by bytes, or by operations at the
   faster of FFMA and 3xTF32 on the tensor cores, both kept; the FFN also by
   its device time, without the wrapper's host time), its plain
   version and the library call (the DFT pair at main path 3's m=12 too,
   and each transform on its two-pass route beside the fused one), the
   RK4-CN stage's three kernels in both layouts and the rollouts beside
   ``torch.fft`` in three rounds with their spread, the SFNO train step
   by six routes (the default, the DFT kernel pair forced and
   ``impl="fft"`` in seven rounds taken in turns, each round in a rotated
   order; plain versions, bf16 activations and remat in three rounds each,
   the last checking the doubled forward launches), and checks that the
   default's median is no more than the faster median of the kernel pair
   and ``impl="fft"`` plus the largest interquartile range of their rounds,
   the Adam step
   over all leaves of both SFNOs (through the table main path 3 keeps,
   through ``adam_step_leaves``, leaf by leaf) beside ``torch.optim.Adam``
   fused and foreach, and the FNO3d step;
8. drives the third main path, ``python -m tpu_cfd_torch.train.opt_layout
   --variants base,fused_adam --check`` at its own configuration (SFNO modes
   12/12/5, width 20, 64², t 10 → 40, batch 4), checks the losses and that
   the Adam kernel launched once a step over 52 leaves, every
   ``dft2d_modes`` and ``dft2d_inverse`` took its fused kernel and the SFNO
   kernels ran; then
   the same with ``--compute-dtype bfloat16 --scan 8``, where the FFN
   kernel's count must still move;
9. drives the fourth main path, ``python -m tpu_cfd_torch.train.train_fno3d``
   (modes 32/5, width 10, batch 4, 2 epochs) on the dataset of phase 4, and
   checks the parameter count and the losses;
10. drives the fifth main path, ``python -m tpu_cfd_torch.data.generate
   kolmogorov`` at its widths (256² → 64², batch 8, forcing and drag 0.1),
   32 samples, 100 warmup + 291 recorded steps (30 records; depth cut from
   4.5·10³ + 5.5·10³ steps and 1,152 samples), checks the dataset, that the
   fused Galerkin kernels did the stepping (each counter ``steps × 5``),
   that the initial condition on the card (``filtered_velocity_field`` at
   256², b=8, fp32) is divergence-free to 1e-4 with each sample's maximum
   speed 5 to 1e-5, holds the fused Galerkin rollout from the curl of that
   IC against its plain version over 10 steps at the CLI's constants
   (viscosity 1e-3, drag 0.1, Kolmogorov forcing), and prints its
   sample-steps/s and the rollout's alone (median of five calls, range);
11. drives the sixth main path, ``python -m tpu_cfd_torch.data.generate fno``
   at its widths (256² → 64², batch 8, IMEX order 2 on ``torch.fft``), 16
   samples, 100 warmup + 291 recorded steps (30 records; depth cut from
   3·10⁴ + 2·10⁴ steps and 1,280 samples), once plainly and once with
   ``--replicable-init`` (the GRF's noise drawn at 2048² on the card),
   checks the datasets and that no spectral-step kernel launched, and times
   the IMEX-2 rollout at b=8 and the full dataset's b=64 for the dataset's
   cost (median of five calls, range);
12. drives the seventh main path, ``python -m
   tpu_cfd_torch.examples.ex2_sfno_finetune --example McWilliams2d
   --gt-floor --lr-decay 0.05`` at 256² in fp64 with eval modes (64, 64, 6)
   on the SFNO that phase 6 trained (the recipe's widths), on an fp64 test
   set it generates (``generate mcwilliams --double --subsample 1``, 8
   samples at b=8, 70 records: the example reads frames 50-69), cut to 10
   iterations; checks that everything is finite, that the best residual is
   no more than iteration 0's and that no kernel launched (the fp64 route,
   as in JAX); holds ``fine_tune_post`` on the card against the CPU on the
   same frames (the fields within ``FT_DEVICE_TOL`` of the largest
   ∂w/∂t, the GT floors within the norm of their residuals' difference),
   and the residual norm and one step's gradients at dt 1e-3; prints the
   zero-shot forward's, the GT floor's and an iteration's ms;
12b. drives the eighth main path, ``python -m
   tpu_cfd_torch.examples.ex2_train_and_finetune`` as it is (fp32: 128²
   McWilliams data, 5 epochs of a 3-layer SFNO, 30 fine-tune steps), checks
   that its histories are finite and that the kernels its shapes route to
   launched exactly as counted (the RK4-CN stage ``steps × 5`` where the
   dataset took the fused route, the FFN once a layer a forward pass, the
   DFT pair where ``fused_pair_wins`` names it);
13. runs the example ``tpu_cfd_torch.examples.ex1_kolmogorov_fvm`` (the FVM
   solver, ``solvers/fvm.py``, at the JAX example's constants: 128²,
   ``filtered_velocity_field`` with maximum velocity 3, peak wavenumber 3
   and 3 projections, ``stable_time_step`` at Courant 0.5, Kolmogorov
   forcing (wave 3) and drag 0.1, classic RK4 with projection, 10 frames of
   20 steps) in fp64 and with ``--f32``; checks that everything is finite
   and divergence-free (1e-12 in fp64, 1e-4 in fp32), holds the card
   against the CPU after 20 fp64 steps from the example's IC
   (``FVM_DEVICE_TOL``), and prints the ms a step. No kernel runs here;
14. drives main path 9, ``--data-parallel`` in both CLIs: ``generate
   mcwilliams`` at 256² → 64², 64 samples, b=32, 100 + 100 steps (100
   records), and ``train`` with phase 6's arguments, once in this process
   at world 1 on NCCL, then each as a user starts it, under ``python -m
   torch.distributed.run --standalone --nproc_per_node 1`` and plainly (one
   worker a visible card by ``torch.multiprocessing.spawn``); each dataset
   must equal the run without the flag within the JAX package's
   tolerances, and each training run's parameters phase 6's within rtol
   2e-4, atol 2e-6 (the last in this process, the best checkpoint of the
   others); K1/K2/K3 ``steps × 5`` a batch and the FFN 4 a step, by count;
   prints sample-steps/s and train ms/step beside the runs without the
   flag; the process group is destroyed after;
15. drives main path 10, the examples: ``ex1_kolmogorov_simulation`` at its
   defaults (256², 3,000 steps on ``torch.fft``: no kernel), prints the
   final enstrophy and the spectrum's peak; ``check_sfno_shapes`` as it is
   (shapes, latents, ms a forward at 128²); ``ex2_sfno_5ep_spectra`` on 64
   train and 64 held-out samples of phase 4's dataset (its ``gap``); the
   DFT pair's and the FFN's launches exact by count, each kernel instance
   held against its plain version at the examples' shapes; and ``train
   --demo-plots 2`` (its eval at 256² in fp64 on phase 12's test set),
   whose figures exist where matplotlib is installed;
16. the utilities on the card: ``profile_to`` around 10 fused rollout
   steps writes a trace holding the 50 ``spectral_advect`` launches;
   ``timer`` and ``device_memory_summary`` print.

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
# NVIDIA H100 SXM data sheet: fp32 outside the tensor cores, dense TF32 on the
# tensor cores, HBM3 rate. A product held to fp32 accuracy on the tensor cores
# takes three TF32 products (3xTF32: a_lo b_hi + a_hi b_lo + a_hi b_hi).
FP32_FLOPS = 67e12
TF32X3_FLOPS = 495e12 / 3
HBM_BYTES_PER_S = 3.35e12
ROLLOUT_TOL = 5e-6   # rel-L2, kernel vs plain over 10 steps (fp32 sum order)
KERNEL_TOL = 1e-5    # max abs error / max |plain|, one launch
# bf16 rows: kernel and plain version each round one fp32 sum to bf16, so they
# differ by at most one bf16 spacing, 2^-7 of the entry at the low end of a binade
BF16_TOL = 2.0 ** -7
ADAM_TOL = 1e-6      # max abs error / max |plain| of p, m, v after three steps
REFERENCE_TOL = 1e-4  # rel-L2, fp32 fused rollout vs fp64 torch.fft, 20 steps
FFT_TOL = 1e-4       # max abs error / max |fft|, DFT pair vs torch.fft at 2m = n
CSRC = "tpu_cfd_torch/ops/cuda/csrc/"
# the SFNO at the McWilliams recipe's widths (README; tpu_cfd/train/train.py)
# and the throughput batch 64. The recipe's accuracy run trains at batch 4,
# train.py's default (train/recipe_accuracy.py, logs/train_mc_r4.log)
RECIPE = dict(b=64, n=64, nt=10, width=10, modes=32, modes_t=5, layers=4)
RECIPE_PARAMS = 16_469_791
# the optimizer sweep's SFNO (scripts/opt_layout_r4.py) and the FNO3d
# example's defaults (examples/ex2_fno3d_train.py)
SWEEP = dict(modes_x=12, modes_y=12, modes_t=5, width=20, beta=1e-2, output_steps=40)
SWEEP_BATCH = 4
SWEEP_PARAMS = 9_242_461
FNO3D_PARAMS = 16_386_997
LEAVES = 52  # parameter leaves of a 4-layer SFNO: the Adam kernel updates a step
GATE_ROUNDS = 7  # rounds of the train-step route gate (phase 7)
FT_ITERS = 10  # fine-tune iterations of main path 7 (the recipe runs 160)
# card vs CPU in fp64 (phase 12): cuFFT and pocketfft differ at roundoff, and
# the ±dt difference divides it by dt; fields over the largest |∂w/∂t|, the
# dt 1e-3 norm relative, gradients over each leaf's largest entry
FT_DEVICE_TOL = 1e-8
# the GT floor card vs CPU, relative: the norm of a residual far smaller than
# w_t, so the fields' roundoff weighs more in it than in FT_DEVICE_TOL's
# comparison; read 6.3e-8 apart (NVIDIA H100 80GB HBM3, 700 W), held to 16x
FT_FLOOR_TOL = 1e-6
# the FVM example (examples/ex1_kolmogorov_fvm.py): 128^2, 10 frames of 20 steps
FVM_N, FVM_FRAMES, FVM_INNER = 128, 10, 20
# card vs CPU after 20 fp64 steps: FFT roundoff through a scheme whose flux
# is continuous in its inputs (the limiter's switches are scaled by the jump)
FVM_DEVICE_TOL = 1e-10


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


@contextlib.contextmanager
def kernel_route(sfno_mod):
    """Sends every fp32 same-mesh SpectralConvS through the DFT kernel pair,
    whatever ``fused_pair_wins`` answers for its shape."""
    saved = sfno_mod.fused_pair_wins
    sfno_mod.fused_pair_wins = lambda *shape: True
    try:
        yield
    finally:
        sfno_mod.fused_pair_wins = saved


def _bound(flops: float, nbytes: float, product: bool = True) -> dict:
    """The least time the card could take: the bytes over the HBM rate or the
    operations over the fastest fp32-accurate rate, whichever is longer. A
    product may run on FFMA or as 3xTF32 on the tensor cores, so it takes the
    lesser of the two; both are kept (``bound_ffma_ms``, ``bound_tf32x3_ms``)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ffma = flops / FP32_FLOPS
    t_tf32 = flops / TF32X3_FLOPS if product else None
    t_ops = min(t_ffma, t_tf32) if product else t_ffma
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "bound_ffma_ms": 1e3 * max(t_ffma, t_bytes),
            "bound_tf32x3_ms": 1e3 * max(t_tf32, t_bytes) if product else None}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import numpy as np
    import torch.nn.functional as F

    from tpu_cfd_torch import grids
    from tpu_cfd_torch.data import generate
    from tpu_cfd_torch.models import FNO3d, SFNO, init_like_flax, make_fno3d_input
    from tpu_cfd_torch.models import sfno as sfno_mod
    from tpu_cfd_torch.models.fused_conv import _dft2d_constants, fused_pair_wins
    from tpu_cfd_torch.ops import dft2d
    from tpu_cfd_torch.ops.cuda import _build, adam as adam_ops, ffn as ffn_ops
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
    sources = ("spectral_step", "spectral_conv", "ffn", "adam")
    with ThreadPoolExecutor(len(sources)) as pool:
        for name, fut in [(s, pool.submit(_build.build, s, (), True)) for s in sources]:
            print(f"build: {name}.cu -> {fut.result().name}", flush=True)
    ss._lib(), sc._lib(), ffn_ops._lib(), adam_ops._lib()
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

    def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
        for _ in range(warmup):
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

    def device_ms(fn, kernel: str, iters: int = 20) -> float:
        """ms a call on the device of the kernels whose name holds ``kernel``
        (torch.profiler): without the wrapper's host time, which a kernel of
        a few tens of microseconds timed back to back would show instead."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if kernel in e.key) / 1e3 / iters

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
                f_hat = ns._forcing_term() if forced else None
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
    gen = torch.Generator(device=dev).manual_seed(0)

    def dft_inputs(b, n, m, ch):
        cc = _dft2d_constants(n, n, m, m, str(dev), "complex64")
        v = torch.randn(b, rt * ch, n, n, device=dev, generator=gen)
        g = torch.randn(b, rt * ch, 2 * m, 2 * m, dtype=torch.complex64,
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

    # the recipe's shape, 256^2, and the sweep's: the truncated case 2m < n
    # at 10 latent steps x 20 channels
    sm, sw = SWEEP["modes_x"], SWEEP["width"]
    dft_cases = {}
    for b, n, m, ch in ((rb, rn, rm, rw), (2, 256, rm, rw), (SWEEP_BATCH, rn, sm, sw)):
        cc, v, g, scale = dft_inputs(b, n, m, ch)
        tag = f"{n}^2 b{b} m{m} {rt * ch} planes"
        sc.reset_launch_counts()
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
        # the shape alone picks the route: fused where it fits (64^2), else
        # two passes (256^2); three launches of each here, one in a backward
        fits = sc.fused_modes_layout(n, n, 2 * m, 2 * m) is not None
        fits_inv = sc.fused_inverse_layout(n, n, 2 * m, 2 * m) is not None
        counts = dict(sc.LAUNCHES)
        print(f"kernel dft2d_modes/dft2d_inverse {tag}: launches {counts}, fused "
              f"routes {fits}/{fits_inv}", flush=True)
        _require(fits == (n == rn) and counts["modes"] == 3
                 and counts["modes_fused"] == 3 * fits, f"dft2d_modes route at {tag}")
        _require(fits_inv == (n == rn) and counts["inverse"] == 3
                 and counts["inverse_fused"] == 3 * fits_inv,
                 f"dft2d_inverse route at {tag}")
        # the name of each shape's entry in the kernels line
        key = {rm: "", sm: "_sweep"}[m] if n == rn else None
        if key is not None:
            results["dft2d_modes" + key] = dict(max_abs_err=e_m)
            results["dft2d_inverse" + key] = dict(max_abs_err=e_i)
            dft_cases[key] = dict(v=v, g=g, c=cc, scale=scale, planes=b * rt * ch,
                                  n=n, m=m)
        # an independent reference, also where 2m < n: torch.fft on the whole
        # mesh, keeping (or filling) only the signed modes -m..m-1 of each axis
        if n == rn:
            idx = torch.cat([torch.arange(m), torch.arange(n - m, n)]).to(dev)
            full = torch.zeros(b, rt * ch, n, n, dtype=torch.complex64, device=dev)
            full[..., idx[:, None], idx] = g.transpose(-1, -2)
            for nm, got, want in (
                    ("dft2d_modes", sc.modes(v, cc),
                     torch.fft.fft2(v)[..., idx[:, None], idx].transpose(-1, -2)),
                    ("dft2d_inverse", sc.inverse(g, scale, cc),
                     torch.fft.ifft2(full).real * (scale * n * n))):
                max_abs, ref_scale = max_err(got, want)
                print(f"reference: {nm} {tag} vs torch.fft, max abs err {max_abs:.3e} "
                      f"(max |fft| {ref_scale:.3e}, tol {FFT_TOL} of it)", flush=True)
                _require(max_abs <= FFT_TOL * ref_scale, f"{nm} vs torch.fft, {tag}")
            del full

    def dft_timed(case) -> dict:
        """name suffix -> (kernel, plain version, library call, flops, bytes)
        for both transforms at one shape. The library call is torch.fft on
        the whole mesh: at 2m = n the spectrum is in the kernels' order, else
        the signed modes are selected (modes) or filled in (inverse)."""
        v, g, c, s_, n, m = (case[k] for k in ("v", "g", "c", "scale", "n", "m"))
        flops = sc.flops(case["planes"], n, n, 2 * m, 2 * m)
        nbytes = case["planes"] * (n * n * 4 + 4 * m * m * 8)
        if 2 * m == n:
            lib_modes = lambda: torch.fft.fft2(v).transpose(-1, -2)  # noqa: E731
            lib_inverse = lambda: torch.fft.ifft2(  # noqa: E731
                g.transpose(-1, -2)).real * (s_ * n * n)
        else:
            idx = torch.cat([torch.arange(m), torch.arange(n - m, n)]).to(dev)
            lib_modes = lambda: torch.fft.fft2(v)[..., idx[:, None], idx].transpose(  # noqa: E731
                -1, -2)

            def lib_inverse():
                full = g.new_zeros(*g.shape[:2], n, n)
                full[..., idx[:, None], idx] = g.transpose(-1, -2)
                return torch.fft.ifft2(full).real * (s_ * n * n)
        return {"dft2d_modes": (lambda: sc.modes(v, c), lambda: sc._modes_plain(v, c),
                                lib_modes, flops, nbytes),
                "dft2d_inverse": (lambda: sc.inverse(g, s_, c),
                                  lambda: sc._inverse_plain(g, s_, c), lib_inverse,
                                  flops, nbytes)}

    def ffn_case(b, width, act):
        """Rows and weights of one PointwiseFFN (width -> 4 width -> width) at
        b x n x n x nt rows; checks the kernel on float32 and on bfloat16 rows
        (forward only: the FFN's backward is plain PyTorch on either route)."""
        rows, hidden = b * rn * rn * rt, 4 * width
        x = torch.randn(rows, width, device=dev, generator=gen)
        w = [torch.randn(*s, device=dev, generator=gen) * a for s, a in (
            ((hidden, width), 0.3), ((hidden,), 0.1), ((width, hidden), 0.15),
            ((width,), 0.1))]
        tag = f"{rows} rows {width}->{hidden}->{width} {act}"
        err = check(f"pointwise_ffn {tag}", ffn_ops.ffn_forward(x, *w, act),
                    ffn_ops._ffn_plain(x, *w, act))
        xh = x.bfloat16()
        got, want = (f(xh, *w, act).float()
                     for f in (ffn_ops.ffn_forward, ffn_ops._ffn_plain))
        err_h, scale = max_err(got, want)
        print(f"kernel pointwise_ffn bf16 rows {tag}: max abs err {err_h:.3e} "
              f"(max |plain| {scale:.3e}, tol {BF16_TOL} of it: one bf16 spacing)",
              flush=True)
        _require(err_h <= BF16_TOL * scale, f"pointwise_ffn bf16 vs plain, {tag}")
        return dict(x=x, xh=xh, w=w, act=act, rows=rows, width=width, hidden=hidden,
                    err=err, err_bf16=err_h)

    # main path 2 runs the recipe's instance on float32 rows; main path 3 runs
    # the sweep's (another template instance, ReLU) on float32 and bfloat16
    ffn_recipe = ffn_case(rb, rw, "GELU")
    ffn_sweep = ffn_case(SWEEP_BATCH, sw, "ReLU")
    results["pointwise_ffn"] = dict(max_abs_err=ffn_recipe["err"])
    results["pointwise_ffn_bf16"] = dict(max_abs_err=ffn_sweep["err_bf16"])

    # adam_step: three steps from random p, g, m, v on every leaf shape of the
    # recipe's SFNO and on odd sizes, with aligned and unaligned pointers
    recipe_model = SFNO(modes_x=rm, modes_y=rm, modes_t=RECIPE["modes_t"], width=rw,
                        num_spectral_layers=RECIPE["layers"], output_steps=rt,
                        activation="GELU", beta=0.0)
    sweep_sfno = SFNO(**SWEEP)
    leaf_shapes = {tag: [tuple(p.shape) for p in model.parameters()]
                   for tag, model in (("recipe", recipe_model), ("sweep", sweep_sfno))}
    for tag, want in (("recipe", RECIPE_PARAMS), ("sweep", SWEEP_PARAMS)):
        _require(len(leaf_shapes[tag]) == LEAVES and sum(
            int(np.prod(sh)) for sh in leaf_shapes[tag]) == want, f"{tag} leaves")
    hyper = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8)

    def adam_state(shape, offset=0):
        """p, g, m, v of ``shape``; ``offset`` floats into their buffers, so
        that with offset 1 no pointer is 16-byte aligned."""
        n = int(np.prod(shape))
        p, g, m, v = (torch.randn(n + offset, device=dev, generator=gen)[offset:]
                      .view(shape) for _ in range(4))
        return p, g, m, v.square_()

    # per group: the largest (err / max |plain|, err) of p, m and v
    adam_err = {tag: (0.0, 0.0) for tag in ("recipe", "sweep", "odd")}
    cases = [(tag, sh, 0) for tag, shapes in leaf_shapes.items() for sh in shapes] + [
        ("odd", (n,), off) for n in (1, 3, 10, 4097) for off in (0, 1)]
    for tag, shape, offset in cases:
        p, g, m, v = adam_state(shape, offset)
        ref = [t.clone() for t in (p, m, v)]
        for step in (1, 2, 3):
            adam_ops.adam_step(p, g, m, v, step=step, **hyper)
            adam_ops._adam_plain(ref[0], g, ref[1], ref[2], step=step, **hyper)
        for name, a, b in zip("pmv", (p, m, v), ref):
            max_abs, scale = max_err(a, b)
            _require(max_abs <= ADAM_TOL * scale,
                     f"adam_step {name} vs plain on {shape} offset {offset}: "
                     f"{max_abs:.3e} of {scale:.3e}")
            adam_err[tag] = max(adam_err[tag], (max_abs / scale, max_abs))
    torch.cuda.synchronize()
    print(f"kernel adam_step: 3 steps on {len(cases)} leaves ({LEAVES} of the recipe's "
          f"SFNO, {LEAVES} of the sweep's, sizes 1/3/10/4097 aligned and unaligned): "
          f"largest err / max |plain| of p, m, v: "
          + ", ".join(f"{k} {v[0]:.3e}" for k, v in adam_err.items())
          + f" (tol {ADAM_TOL})", flush=True)
    # the multi-tensor Adam: each SFNO's 52 leaves in one launch a step, odd
    # sizes and 1,024,000 floats (aligned and offset-1) in one list, and 104
    # leaves in two launches a step, through the table main path 3 keeps
    groups = {"recipe": [(sh, 0) for sh in leaf_shapes["recipe"]],
              "sweep": [(sh, 0) for sh in leaf_shapes["sweep"]],
              "odd": [((n,), off) for n in (1, 3, 10, 4097, 1_024_000) for off in (0, 1)],
              "104 leaves": [(sh, 0) for sh in leaf_shapes["recipe"] + leaf_shapes["sweep"]]}
    leaves_err = {}
    for tag, specs in groups.items():
        state = [adam_state(sh, off) for sh, off in specs]
        ref = [[t.clone() for t in (p, m, v)] for p, _, m, v in state]
        ps, gs, ms_, vs = (list(ts) for ts in zip(*state))
        table = adam_ops.AdamLeaves(ps, ms_, vs)
        adam_ops.reset_launch_counts()
        for step in (1, 2, 3):
            table.step(gs, step=step, **hyper)
            for (p, m, v), g in zip(ref, gs):
                adam_ops._adam_plain(p, g, m, v, step=step, **hyper)
        torch.cuda.synchronize()
        want = {"adam": 3 * -(-len(specs) // adam_ops.MAX_LEAVES),
                "adam_leaves": 3 * len(specs)}
        _require(adam_ops.LAUNCHES == want, f"multi-tensor Adam launches on {tag}: "
                 f"{adam_ops.LAUNCHES}, expected {want}")
        leaves_err[tag] = (0.0, 0.0)
        for (p, _, m, v), r_ in zip(state, ref):
            for name, a, b in zip("pmv", (p, m, v), r_):
                max_abs, scale = max_err(a, b)
                _require(max_abs <= ADAM_TOL * scale,
                         f"multi-tensor Adam {name} vs plain on {tag}")
                leaves_err[tag] = max(leaves_err[tag], (max_abs / scale, max_abs))
    print("kernel adam_step_leaves: 3 steps, one launch a step a group of "
          f"{adam_ops.MAX_LEAVES} leaves (counted), largest err / max |plain| of p, m, v: "
          + ", ".join(f"{k} {v[0]:.3e}" for k, v in leaves_err.items())
          + f" (tol {ADAM_TOL})", flush=True)
    # the kernels line takes main path 3's shapes: the sweep's leaves
    results["adam_step"] = dict(max_abs_err=leaves_err["sweep"][1])
    # and against torch.optim.Adam from zero moments, on the same gradients
    shapes17 = leaf_shapes["recipe"][:8] + leaf_shapes["sweep"][:8] + [(4097,)]
    ps = [adam_state(sh)[0] for sh in shapes17]
    qs = [torch.nn.Parameter(p.clone()) for p in ps]
    opt = torch.optim.Adam(qs, lr=hyper["lr"])
    ms_, vs = [torch.zeros_like(p) for p in ps], [torch.zeros_like(p) for p in ps]
    for step in (1, 2, 3):
        gs = [torch.randn(sh, device=dev, generator=gen) for sh in shapes17]
        adam_ops.adam_step_leaves(ps, gs, ms_, vs, step=step, **hyper)
        for q, g in zip(qs, gs):
            q.grad = g
        opt.step()
    worst = 0.0
    for p, m, v, q in zip(ps, ms_, vs, qs):
        for name, a, b in (("p", p, q.detach()), ("m", m, opt.state[q]["exp_avg"]),
                           ("v", v, opt.state[q]["exp_avg_sq"])):
            max_abs, scale = max_err(a, b)
            _require(max_abs <= ADAM_TOL * scale,
                     f"adam_step_leaves {name} vs torch.optim.Adam on {tuple(p.shape)}")
            worst = max(worst, max_abs / scale)
    print(f"reference: adam_step_leaves vs torch.optim.Adam, 3 steps on 17 leaves, "
          f"largest err / max |reference| {worst:.3e} (tol {ADAM_TOL})", flush=True)
    # free the lists, so that the train steps' peak memory counts none of them
    del state, ref, ps, gs, ms_, vs, table, qs, opt

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
    sfno_ckpt = run["checkpoint"]  # phase 12 fine-tunes this model
    # phase 14 holds the --data-parallel runs to these: the last parameters
    # and the best checkpoint (later runs write to the same path)
    p6_final = {k: v.detach().cpu().clone() for k, v in run["model"].state_dict().items()}
    p6_best = torch.load(sfno_ckpt + ".pt", map_location="cpu", weights_only=True)
    hist = run["history"]
    print(f"main path 2: train.main at the recipe, {run['n_params']} parameters, "
          f"2 epochs x 2 steps + 2 val batches in {wall:.2f} s, launches "
          f"{train_launches}, history {hist}", flush=True)
    _require(run["n_params"] == RECIPE_PARAMS, f"parameter count {run['n_params']}")
    _require(all(np.isfinite([hh["train"] for hh in hist] + [hh["val"] for hh in hist]))
             and len(hist) == 2, "finite train and val losses")
    # the route fused_pair_wins names for the recipe's SpectralConvS: the DFT
    # kernel pair (6 launches of each transform a train step) or torch.fft (none)
    pair = int(fused_pair_wins(rn, rn, rm, rm, rb * rt * rw))
    print(f"main path 2: SpectralConvS at the recipe ({rb * rt * rw} planes of {rn}^2, "
          f"m {rm}) takes {'the DFT kernel pair' if pair else 'torch.fft'}", flush=True)
    train_steps, val_batches = 4, 2
    per_step = {"modes": 6 * pair, "inverse": 6 * pair, "ffn": 4}
    per_eval = {"modes": 3 * pair, "inverse": 3 * pair, "ffn": 4}
    for key in per_step:
        want = train_steps * per_step[key] + val_batches * per_eval[key]
        _require(train_launches[key] == want,
                 f"{key} launched {train_launches[key]} times, expected {want}")
    for key in ("modes", "inverse"):
        _require(train_launches[key + "_fused"] == train_launches[key],
                 f"{train_launches[key + '_fused']} of {train_launches[key]} {key} "
                 "launches took the fused kernel")

    # -- 7. timings -----------------------------------------------------------
    def ffn_timed(case, bf16: bool):
        """(kernel, plain version, no library call, flops, bytes) of one case;
        bf16 rows halve the rows' bytes, the weights and the operations stay."""
        x, w, act = case["xh" if bf16 else "x"], case["w"], case["act"]
        nbytes = (case["rows"] * 2 * case["width"] * x.element_size()
                  + sum(t.numel() for t in w) * 4)
        return (lambda: ffn_ops.ffn_forward(x, *w, act),
                lambda: ffn_ops._ffn_plain(x, *w, act), None,
                ffn_ops.flops(case["rows"], case["width"], case["hidden"],
                              case["width"]), nbytes)

    x2, fw = ffn_recipe["x"], ffn_recipe["w"]
    chain = lambda: F.linear(F.gelu(F.linear(x2, fw[0], fw[1]), approximate="tanh"),  # noqa: E731
                             fw[2], fw[3])

    def adam_bench(model) -> dict:
        """One Adam step over all leaves of ``model``: the kernel through the
        table main path 3 keeps (one launch), through ``adam_step_leaves``
        (every tensor checked on every call) and leaf by leaf (``adam_step``,
        one launch a leaf); its plain version; ``torch.optim.Adam`` fused and
        foreach on the same leaves; the kernel's device time (profiler) and
        the host time of a step through the table and through the function."""
        from torch.profiler import ProfilerActivity, profile

        state = [adam_state(tuple(p.shape)) for p in model.parameters()]
        ps, gs, ms_, vs = (list(ts) for ts in zip(*state))
        numel = sum(p.numel() for p in ps)
        table = adam_ops.AdamLeaves(ps, ms_, vs)
        counter = iter(range(1, 1 << 30))

        def table_step():
            table.step(gs, step=next(counter), **hyper)

        def leaves_fn():
            adam_ops.adam_step_leaves(ps, gs, ms_, vs, step=next(counter), **hyper)

        def run(fn):
            step = next(counter)
            for p, g, m, v in state:
                fn(p, g, m, v, step=step, **hyper)

        def library(**kw):
            qs = [torch.nn.Parameter(p.clone()) for p in ps]
            for q, g in zip(qs, gs):
                q.grad = g
            return torch.optim.Adam(qs, lr=hyper["lr"], **kw).step

        def host_ms(fn, calls=200) -> float:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            host = 1e3 * (time.perf_counter() - t0) / calls
            torch.cuda.synchronize()
            return host

        row = {"leaves": len(state), "n_params": numel,
               "ms": cuda_ms(table_step, 20, 5),
               "leaves_fn_ms": cuda_ms(leaves_fn, 20, 5),
               "per_leaf_ms": cuda_ms(lambda: run(adam_ops.adam_step), 20, 5),
               "plain_ms": cuda_ms(lambda: run(adam_ops._adam_plain), 20, 5),
               "library_ms": cuda_ms(library(fused=True), 20, 5),
               "library_foreach_ms": cuda_ms(library(foreach=True), 20, 5),
               "host_ms": host_ms(table_step), "host_leaves_fn_ms": host_ms(leaves_fn)}
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                table_step()
            torch.cuda.synchronize()
        row["device_ms"] = sum(e.self_device_time_total for e in prof.key_averages()
                               if "adam_multi_kernel" in e.key) / 1e3 / 10
        row.update(_bound(10 * numel, adam_ops.BYTES_PER_ELEMENT * numel, product=False))
        return row

    adam_rows = {"sweep": adam_bench(sweep_sfno), "recipe": adam_bench(recipe_model)}
    for tag, r in adam_rows.items():
        print(f"time adam over the {r['leaves']} leaves of the {tag}'s SFNO "
              f"({r['n_params']} parameters), ms/step: table {r['ms']:.4f} (kernel "
              f"{r['device_ms']:.4f} on the device, host {r['host_ms']:.4f}), "
              f"adam_step_leaves {r['leaves_fn_ms']:.4f} (host "
              f"{r['host_leaves_fn_ms']:.4f}), leaf by leaf {r['per_leaf_ms']:.4f}, "
              f"plain {r['plain_ms']:.4f}, torch.optim.Adam fused {r['library_ms']:.4f}, "
              f"foreach {r['library_foreach_ms']:.4f}, bound {r['bound_ms']:.4f} "
              f"({r['bound_by']})", flush=True)
    # the kernels line takes the main path's shapes: the sweep's 52 leaves
    results["adam_step"].update(
        {k: adam_rows["sweep"][k] for k in
         ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "bound_ffma_ms",
          "bound_tf32x3_ms")})
    # name: (kernel, plain version, library call or None, flops, bytes); the
    # spectral-step kernels' times come from the three rounds below
    timed = {name: (kern, plain, None, flops, nbytes)
             for name, (kern, plain, flops, nbytes) in kernels.items()}
    # the DFT pair at the recipe's shape (main path 2) and the sweep's (main
    # path 3); its floor counts an FFT's operations (sc.flops), not the dense
    # contraction the kernels do: at 2m = n it is bound by bytes
    for key, case in dft_cases.items():
        timed.update({name + key: t for name, t in dft_timed(case).items()})
    timed.update({
        # each entry at the shape of the main path whose launches it reports
        "pointwise_ffn": ffn_timed(ffn_recipe, False),
        "pointwise_ffn_bf16": ffn_timed(ffn_sweep, True),
    })
    # the DFT pair on the two-pass route each had before its fused kernel
    two_pass = {}
    for key, case in dft_cases.items():
        for name, fn in (
                ("dft2d_modes", lambda: sc._launch_modes_two_pass(case["v"], case["c"])),
                ("dft2d_inverse", lambda: sc._launch_inverse_two_pass(
                    case["g"], case["scale"], case["c"]))):
            two_pass[name + key] = cuda_ms(fn, 20)
            print(f"time {name}{key} on two passes: {two_pass[name + key]:.4f} ms",
                  flush=True)
    # the other two instances, for the table only
    ffn_other = {}
    for name, case, bf16 in (("recipe_bf16", ffn_recipe, True),
                             ("sweep_fp32", ffn_sweep, False)):
        kern, plain, _, flops, nbytes = ffn_timed(case, bf16)
        ffn_other[name] = {
            "max_abs_err": case["err_bf16" if bf16 else "err"], "rows": case["rows"],
            "width": case["width"], "act": case["act"], "ms": cuda_ms(kern, 20),
            "device_ms": device_ms(kern, "ffn_kernel"),
            "plain_ms": cuda_ms(plain, 20), **_bound(flops, nbytes)}
        print(f"time pointwise_ffn {name}: {ffn_other[name]['ms']:.4f} ms (device "
              f"{ffn_other[name]['device_ms']:.4f}), plain "
              f"{ffn_other[name]['plain_ms']:.4f} ms, bound "
              f"{ffn_other[name]['bound_ms']:.4f} ms ({ffn_other[name]['bound_by']})",
              flush=True)
    for name, (kern, plain, lib, flops, nbytes) in timed.items():
        r = results[name]
        if name not in kernels:
            r["ms"] = cuda_ms(kern, 20)
        if name.startswith("pointwise_ffn"):
            r["device_ms"] = device_ms(kern, "ffn_kernel")
        r["plain_ms"] = cuda_ms(plain, 20)
        r["library_ms"] = cuda_ms(lib, 20) if lib is not None else None
        r.update(_bound(flops, nbytes))
    chain_ms = cuda_ms(chain, 20)

    # the RK4-CN stage's kernels in both layouts at b=32, and the rollouts
    # beside torch.fft, in three rounds: torch.fft's time moves between runs
    rsteps = 100
    step_kernels = {f"{name} galerkin": kern for name, (kern, *_) in kernels.items()}
    ca = ss.constants("aligned", grid, 1e-3, 0.0, DT, dev)
    wa = NavierStokes2DSpectral(viscosity=1e-3, grid=grid, fft_impl="dft_aligned",
                                device=dev)._align(initial_spectrum(B)).contiguous()
    Aa = ss._inverse_first_plain(wa, ca)
    Ta = ss._advect_plain(Aa, ca)
    wak, hak = wa.clone(), torch.randn_like(wa) * wa.abs().mean()
    jca = ss.resolve_block_cols("auto", N, ca["m"])
    step_kernels.update({
        "spectral_inverse_first aligned": lambda: ss.inverse_first(wa, ca),
        "spectral_advect aligned": lambda: ss.advect(Aa, ca, jca),
        "spectral_forward_first aligned": lambda: ss.forward_first(Ta, wak, hak, ca, 1)})
    rollout_cases = {}
    for layout, b in (("galerkin", 32), ("galerkin", 8), ("aligned", 32)):
        what = initial_spectrum(b)
        fused = NavierStokes2DSpectral(viscosity=1e-3, grid=grid,
                                       fft_impl=f"dft_{layout}", fused=True,
                                       device=dev)
        fft_ns = NavierStokes2DSpectral(viscosity=1e-3, grid=grid, fft_impl="fft",
                                        device=dev)
        rollout_cases[f"rollout {layout} b{b}"] = (
            lambda f=fused, x=what: f.forward(x, DT, rsteps))
        rollout_cases[f"torch.fft b{b} ({layout} case)"] = (
            lambda f=fft_ns, x=what: f.forward(x, DT, rsteps))
    rounds = []
    for _ in range(3):
        rounds.append({**{k: cuda_ms(fn, 20) for k, fn in step_kernels.items()},
                       **{k: cuda_ms(fn, 1) / rsteps for k, fn in rollout_cases.items()}})
    spread = {}
    for k in rounds[0]:
        ts = sorted(r[k] for r in rounds)
        spread[k] = {"ms": ts, "median": ts[1], "spread": (ts[2] - ts[0]) / ts[1]}
        print(f"time x3 {k}: {ts[0]:.4f} / {ts[1]:.4f} / {ts[2]:.4f} ms"
              f"{' per step' if 'rollout' in k or 'fft' in k else ''} (spread "
              f"{100 * spread[k]['spread']:.1f} %)", flush=True)
    for name in kernels:
        results[name]["ms"] = spread[f"{name} galerkin"]["median"]
    for name, r in results.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        tf = "" if r.get("bound_tf32x3_ms") is None else (
            f"; FFMA {r['bound_ffma_ms']:.4f}, 3xTF32 {r['bound_tf32x3_ms']:.4f}")
        dev_ms = f" (device {r['device_ms']:.4f})" if "device_ms" in r else ""
        print(f"time {name}: {r['ms']:.4f} ms{dev_ms}, plain {r['plain_ms']:.4f} ms, "
              f"library {lib} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}{tf})",
              flush=True)
    print(f"time pointwise_ffn as F.linear -> gelu -> F.linear (information): "
          f"{chain_ms:.4f} ms", flush=True)

    rollouts = []
    for layout, b in (("galerkin", 32), ("galerkin", 8), ("aligned", 32)):
        what = initial_spectrum(b)
        wb = NavierStokes2DSpectral(viscosity=1e-3, grid=grid, fft_impl=f"dft_{layout}",
                                    device=dev)._align(what).contiguous()
        cb = ss.constants(layout, grid, 1e-3, 0.0, DT, dev)
        jcb = ss.resolve_block_cols("auto", N, cb["m"])
        row = {"layout": layout, "n": N, "batch": b, "steps": rsteps}
        row["ms_per_step"] = spread[f"rollout {layout} b{b}"]["median"]
        row["plain_ms_per_step"] = cuda_ms(
            lambda: ss._fused_rollout_plain(wb, cb, rsteps, jcb), 1) / rsteps
        ns = NavierStokes2DSpectral(viscosity=1e-3, grid=grid, fft_impl=f"dft_{layout}",
                                    device=dev)
        row["library_ms_per_step"] = {
            f"dft_{layout}": cuda_ms(lambda: ns.forward(what, DT, rsteps), 1) / rsteps,
            "fft": spread[f"torch.fft b{b} ({layout} case)"]["median"]}
        flops = b * ss.flops_per_sample_step(layout, N)
        row["bound_ms_per_step"] = 1e3 * flops / max(FP32_FLOPS, TF32X3_FLOPS)
        row["bound_ffma_ms_per_step"] = 1e3 * flops / FP32_FLOPS
        row["sample_steps_per_s"] = b / (row["ms_per_step"] * 1e-3)
        lib = row["library_ms_per_step"]
        print(f"time rollout {layout} b{b}: kernel {row['ms_per_step']:.4f} ms/step "
              f"({row['sample_steps_per_s']:.1f} sample-steps/s), bound "
              f"{row['bound_ms_per_step']:.4f} (FFMA {row['bound_ffma_ms_per_step']:.4f}), "
              f"plain {row['plain_ms_per_step']:.4f}, torch.matmul dft_{layout} "
              f"{lib[f'dft_{layout}']:.4f}, torch.fft {lib['fft']:.4f} ms/step", flush=True)
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
                   if any(k in e.key for k in ("bgemm_kernel", "modes_fused_kernel",
                                               "inverse_fused_kernel", "ffn_kernel",
                                               "adam_multi_kernel"))
                   ) / 1e3 / steps
        top = [(e.key[:90], e.self_device_time_total / 1e3 / steps, e.count / steps)
               for e in kern[:12]]
        print(f"profile {route}: device busy {busy_ms:.3f} of {wall_ms:.3f} ms/step "
              f"(profiled), share {busy_ms / wall_ms:.3f}; hand-written kernels "
              f"{ours:.3f} ms/step", flush=True)
        for name, ms_, count in top:
            print(f"profile {route}:   {ms_:8.3f} ms/step  x{count:5.1f}  {name}",
                  flush=True)
        return {"busy_ms_per_step": busy_ms, "wall_ms_per_step": wall_ms,
                "sfno_kernels_ms_per_step": ours,
                "launches_per_step": sum(e.count for e in kern) / steps}

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

    route_flags = {"bf16": ["--compute-dtype", "bfloat16"], "remat": ["--remat"]}
    # under remat the wrapped blocks' forwards run again in the backward pass:
    # every PointwiseFFN twice, every SpectralConvS's modes twice, and its
    # inverse once, since the recomputation stops at the block's last saved
    # tensor, which the inverse transform only consumes
    route_launches = {"default": per_step, "bf16": per_step,
                      "dft_kernels": {"modes": 6, "inverse": 6, "ffn": 4},
                      "remat": {"modes": 9 * pair, "inverse": 6 * pair, "ffn": 8}}

    def build_step(route: str):
        """The train step of ``route`` from the base parameters, warmed up."""
        model = train.build_model(train.get_parser().parse_args(
            targv + route_flags.get(route, [])))
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
        return step

    # the default, the kernel pair forced and impl="fft" are timed once, in the
    # gate's rounds below; train_route reads their launches, memory and profile
    gated = ("default", "dft_kernels", "fft")

    def train_route(route: str) -> dict:
        step = build_step(route)
        sc.reset_launch_counts()
        ffn_ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        rounds = []
        n_rounds, n_iters = (1, 2) if route in gated else (3, iters)
        for _ in range(n_rounds):
            t0 = time.perf_counter()
            for _ in range(n_iters):
                loss = step(inp, target)
            torch.cuda.synchronize()
            rounds.append(1e3 * (time.perf_counter() - t0) / n_iters)
        steps_run = n_rounds * n_iters
        counts = {**sc.LAUNCHES, **ffn_ops.LAUNCHES}
        _require(bool(torch.isfinite(loss)), f"finite loss on the {route} route")
        for key, want in route_launches.get(route, {}).items():
            _require(counts[key] == steps_run * want,
                     f"{key}: {counts[key]} launches in {steps_run} {route} steps, "
                     f"expected {steps_run * want}")
        for key in ("modes", "inverse"):
            _require(counts[key + "_fused"] == counts[key],
                     f"every {key} launch fused on the {route} route")
        row = {"route": route,
               "launches_per_step": {k: v / steps_run for k, v in counts.items()},
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "loss": float(loss)}
        timing = "timed in the gate's rounds"
        if route not in gated:
            rounds.sort()
            row.update(ms_per_step=rounds[1], rounds_ms=rounds,
                       samples_per_s=rb / (rounds[1] * 1e-3))
            timing = (f"{rounds[1]:.3f} ms/step (rounds "
                      f"{' / '.join(f'{r:.3f}' for r in rounds)}), "
                      f"{row['samples_per_s']:.1f} samples/s")
        print(f"time train step {route}: {timing}, peak {row['peak_gib']:.2f} GiB, "
              f"launches/step {row['launches_per_step']}", flush=True)
        row["profile"] = profile_steps(route, lambda: step(inp, target), 3)
        return row

    for route in ("default", "fft", "bf16", "remat"):
        train_rows.append(train_route(route))
    with kernel_route(sfno_mod):
        train_rows.append(train_route("dft_kernels"))
        # the kernel route's arithmetic in plain PyTorch (cuBLAS)
        with plain_versions(sc, ffn_ops):
            train_rows.append(train_route("plain"))
    print(f"time train step: kernels' bound {kernel_bound_ms:.3f} ms/step "
          f"(6 modes + 6 inverse + 4 ffn launches)", flush=True)
    # the default route is the faster of the kernel pair and torch.fft: its
    # median is no more than the faster median plus the largest interquartile
    # range of the three. The rounds are taken in turns, each round in an order
    # rotated by one, so that a drift of the card or the host falls on all three
    # alike (timed one route after another, the default and impl=fft, one route
    # at the recipe, once read 0.85 ms apart); median and quartiles let one
    # disturbed round move neither side
    def gate_context(route):
        return kernel_route(sfno_mod) if route == "dft_kernels" else contextlib.nullcontext()

    gate_steps = {}
    for route in gated:
        with gate_context(route):
            gate_steps[route] = build_step(route)
    gate_rounds = {route: [] for route in gated}
    for i in range(GATE_ROUNDS):
        for route in gated[i % 3:] + gated[:i % 3]:
            with gate_context(route):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(iters):
                    gate_steps[route](inp, target)
                torch.cuda.synchronize()
            gate_rounds[route].append(1e3 * (time.perf_counter() - t0) / iters)
    del gate_steps
    gate_ms = {route: float(np.median(r)) for route, r in gate_rounds.items()}
    iqr_ms = max(float(np.subtract(*np.percentile(r, [75, 25])))
                 for r in gate_rounds.values())
    range_ms = max(max(r) - min(r) for r in gate_rounds.values())
    best_ms = min(gate_ms["dft_kernels"], gate_ms["fft"])
    for row in train_rows:
        if row["route"] in gated:
            ms = gate_ms[row["route"]]
            row.update(ms_per_step=ms, rounds_ms=gate_rounds[row["route"]],
                       samples_per_s=rb / (ms * 1e-3))
    print(f"time train step, {GATE_ROUNDS} rounds in turns (medians): default "
          f"{gate_ms['default']:.3f} ms/step, kernel pair {gate_ms['dft_kernels']:.3f}, "
          f"impl=fft {gate_ms['fft']:.3f}; largest interquartile range of their "
          f"rounds {iqr_ms:.3f} (the tolerance), largest max-min {range_ms:.3f}",
          flush=True)
    _require(gate_ms["default"] <= best_ms + iqr_ms,
             "the default SpectralConvS route is no slower than the faster of the "
             "kernel pair and impl=fft")

    # the FNO3d train step at the example's defaults (cuFFT and cuBLAS only)
    fno = FNO3d(rm, rm, RECIPE["modes_t"], width=rw, input_channel=rt)
    init_like_flax(fno, torch.Generator().manual_seed(0)).to(dev)
    fno_step = tpipe.make_train_step(
        fno, lambda out, u: loss_fn(out[0], u),
        tpipe.get_optimizer("Adam", fno.parameters(), 1e-3))
    fno_in, fno_target = make_fno3d_input(inp[:4], rt), target[:4]
    torch.cuda.reset_peak_memory_stats()
    fno_row = {"batch": 4, "ms_per_step": cuda_ms(lambda: fno_step(fno_in, fno_target), 20),
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    fno_row["samples_per_s"] = 4 / (fno_row["ms_per_step"] * 1e-3)
    print(f"time FNO3d train step b4: {fno_row['ms_per_step']:.3f} ms/step, "
          f"{fno_row['samples_per_s']:.1f} samples/s, peak {fno_row['peak_gib']:.2f} GiB",
          flush=True)
    del fno, fno_step

    # -- 8. main path 3: the optimizer sweep at the script's configuration ----
    from tpu_cfd_torch.train import opt_layout, train_fno3d

    def sweep(extra, scan: int):
        """opt_layout.main with the counts set to 0 just before and read just after."""
        adam_ops.reset_launch_counts()
        sc.reset_launch_counts()
        ffn_ops.reset_launch_counts()
        rows_ = opt_layout.main(["--variants", "base,fused_adam", "--check", *extra,
                                 *(["--scan", str(scan)] if scan else [])])
        torch.cuda.synchronize()
        counts = {**adam_ops.LAUNCHES, **sc.LAUNCHES, **ffn_ops.LAUNCHES}
        tag = f"{rows_[0]['compute_dtype']} scan {scan}"
        by = {r["variant"]: r for r in rows_}
        print(f"main path 3 ({tag}): launches {counts}; "
              + "; ".join(f"{v} {r['ms_step']:.3f} ms/step, loss {r['loss']:.6f}"
                          for v, r in by.items()), flush=True)
        _require(set(by) == {"base", "fused_adam"}, "both variants ran")
        for v, r in by.items():
            _require(np.isfinite(r["loss"]) and r["n_params"] == SWEEP_PARAMS
                     and r["leaves"] == LEAVES, f"sweep {v}: {r}")
            c = r["check"]  # opt_layout raises when the check fails
            _require(abs(c["loss"] - c["base_loss"]) <= 2e-5 * abs(c["base_loss"]),
                     f"sweep --check {v}")
        steps_ = by["fused_adam"]["steps"]
        _require(counts["adam"] == steps_ and counts["adam_leaves"] == LEAVES * steps_,
                 f"adam launched {counts['adam']} times over {counts['adam_leaves']} "
                 f"leaves, expected once a step over {LEAVES} leaves, {steps_} steps")
        for key in ("modes", "inverse", "ffn"):
            _require(counts[key] > 0, f"{key} did not launch in the sweep ({tag})")
        for key in ("modes", "inverse"):
            _require(counts[key + "_fused"] == counts[key],
                     f"{counts[key + '_fused']} of {counts[key]} {key} launches took "
                     f"the fused kernel ({tag})")
        return rows_, counts

    # where the sweep's step spends its time: the device's busy share
    sweep_model = init_like_flax(SFNO(**SWEEP), torch.Generator().manual_seed(0)).to(dev)
    sweep_step = opt_layout.build_step(
        "fused_adam", sweep_model,
        losses.SobolevLoss(n_grid=rn, norm_order=0, relative=True), 40)
    sx = torch.randn(SWEEP_BATCH, rn, rn, 10, device=dev, generator=gen)
    sy = torch.randn(SWEEP_BATCH, rn, rn, 40, device=dev, generator=gen)
    for _ in range(3):
        sweep_step(sx, sy)
    sweep_profile = profile_steps("sweep fused_adam", lambda: sweep_step(sx, sy), 3)
    del sweep_model, sweep_step

    sweep_rows, sweep_launches = sweep([], 0)
    bf16_rows, bf16_launches = sweep(["--compute-dtype", "bfloat16"], 8)
    # every PointwiseFFN of every step and of the check's base model, bf16 too
    total_steps = sum(r["steps"] + r["check"]["steps"] for r in bf16_rows)
    _require(bf16_launches["ffn"] == 4 * total_steps,
             f"ffn launched {bf16_launches['ffn']} times with bf16 activations, "
             f"expected 4 x {total_steps}")
    sweep_rows += bf16_rows

    # -- 9. main path 4: FNO3d baseline training on the generated dataset -----
    # 30 records hold the example's --t-start 10 plus 10 input and 10 output steps
    print("main path 4: train_fno3d at the example's defaults (--t-start 10, "
          "10 + 10 steps of the dataset's 30 records), 96 train / 32 test "
          "samples, batch 4, 2 epochs", flush=True)
    t0 = time.perf_counter()
    fno_run = train_fno3d.main(["--data-file", data_path, "--num-samples", "96",
                                "--num-test-samples", "32", "--epochs", "2"])
    torch.cuda.synchronize()
    fhist = fno_run["history"]
    print(f"main path 4: {fno_run['n_params']} parameters, 2 epochs x 24 steps + "
          f"32 test samples in {time.perf_counter() - t0:.2f} s, history {fhist}",
          flush=True)
    _require(fno_run["n_params"] == FNO3D_PARAMS, f"FNO3d parameters {fno_run['n_params']}")
    _require(len(fhist) == 2 and all(np.isfinite(
        [h["train"] for h in fhist] + [h["test"] for h in fhist])),
        "finite FNO3d train and test losses")
    _require(next(fno_run["model"].parameters()).is_cuda, "FNO3d trained on the card")

    from tpu_cfd_torch.ops import finite_differences as fdm
    from tpu_cfd_torch.solvers.equations import IMEXStepper

    # -- 10. main path 5: the kolmogorov dataset on the fused Galerkin kernels
    kbatch, ksamples = 8, 32
    kgrid = grids.Grid((N, N), domain=((0, 2 * np.pi), (0, 2 * np.pi)))
    noise = torch.stack([torch.randn((2, N, N), device=dev,
                                     generator=ic.sample_generator(0, i, dev))
                         for i in range(kbatch)])
    vel = ic.filtered_velocity_field(kgrid, maximum_velocity=5.0, peak_wavenumber=4,
                                     noise=noise)
    div = float(fdm.divergence(vel).data.abs().max())
    speed = torch.linalg.vector_norm(torch.stack([u.data for u in vel]), dim=0)
    vmax_err = float(((speed.amax(dim=(-2, -1)) - 5.0).abs() / 5.0).max())
    print(f"main path 5: kolmogorov IC on the card (256^2, b{kbatch}, float32): max "
          f"|div| {div:.3e} (tol 1e-4), max |vmax - 5| / 5 over samples {vmax_err:.3e} "
          f"(tol 1e-5)", flush=True)
    _require(vel[0].data.is_cuda and div < 1e-4, "divergence-free kolmogorov IC")
    _require(vmax_err < 1e-5, "each kolmogorov sample's maximum speed is 5")
    kargv = ["--grid-size", str(N), "--subsample", "4", "--batch-size", str(kbatch),
             "--num-samples", str(ksamples), "--time", "0.4", "--time-warmup", "0.1",
             "--dt", str(DT), "--num-steps", "30", "--filepath", tmp]
    ss.reset_launch_counts()
    t0 = time.perf_counter()
    kpath = generate.main_kolmogorov(kargv)
    torch.cuda.synchronize()
    kwall = time.perf_counter() - t0
    kol_launches = dict(ss.LAUNCHES)
    with np.load(kpath) as z:
        kvort = z["vorticity"]
    with open(kpath + ".meta.json") as f:
        kmeta = json.load(f)
    ksteps = (ksamples // kbatch) * (100 + 1 + 29 * 10)
    kol_rate = kbatch * ksteps / kwall
    print(f"main path 5: kolmogorov 256^2->64^2, {ksamples} samples b{kbatch}, "
          f"{ksteps} steps in {kwall:.2f} s: {kol_rate:.1f} sample-steps/s with the "
          f"IC and the recorder, launches {kol_launches}, fft_impl "
          f"{kmeta['fft_impl']}, records {kvort.shape}", flush=True)
    _require(kvort.shape == (ksamples, 30, 64, 64), f"kolmogorov shape {kvort.shape}")
    _require(bool(np.isfinite(kvort).all()), "finite kolmogorov dataset")
    _require(kmeta["fft_impl"] == "dft_galerkin_fused", "kolmogorov took the kernel")
    for key in ("inverse_first", "advect", "forward_first"):
        _require(kol_launches[key] == ksteps * 5, f"kolmogorov: {key} launched "
                 f"{kol_launches[key]} times, expected {ksteps * 5}")

    # the fused Galerkin rollout at this path's batch and constants (the CLI's
    # solver, rebuilt from its meta file), from the curl of the IC above as
    # the CLI takes it, held against its plain version as phase 3a holds it
    kforcing = forcings.KolmogorovForcing(grid=kgrid, scale=1.0, wave_number=4,
                                          diam=2 * np.pi, vorticity=False)
    kol_ns = NavierStokes2DSpectral(
        viscosity=1e-3, grid=kgrid, drag=0.1, forcing_fn=kforcing,
        fft_impl=kmeta["fft_impl"][: -len("_fused")], fused=True,
        mxu_precision=kmeta["mxu_precision"], device=dev)
    kw_hat = kol_ns._align(torch.fft.rfft2(fdm.curl_2d(vel).data))
    kf_hat = kol_ns._forcing_term()
    kc = ss.constants("galerkin", kgrid, kol_ns.viscosity, kol_ns.drag, DT, dev, kf_hat)
    got = ss._fused_rollout(
        kw_hat, layout="galerkin", grid=kgrid, viscosity=kol_ns.viscosity,
        drag=kol_ns.drag, dt=DT, steps=10, forcing_hat=kf_hat,
        precision=kol_ns.mxu_precision, block_cols="auto")
    torch.cuda.synchronize()
    want = ss._fused_rollout_plain(kw_hat, kc, 10, ss.resolve_block_cols("auto", N, kc["m"]))
    torch.cuda.synchronize()
    kol_err = rel(got, want)
    print(f"main path 5: fused Galerkin rollout b{kbatch}, viscosity 1e-3, drag 0.1, "
          f"Kolmogorov forcing (scale 1, wave 4), 10 steps from the IC: rel-L2 kernel "
          f"vs plain {kol_err:.3e} (tol {ROLLOUT_TOL})", flush=True)
    _require(bool(torch.isfinite(got).all()), "finite kolmogorov rollout")
    _require(kol_err < ROLLOUT_TOL, "kolmogorov rollout vs plain")

    def rollout_rate(ns, b, steps=100, rounds=5):
        """sample-steps/s of ``ns.forward`` at batch b (CUDA events): the
        median of ``rounds`` calls and their range."""
        w0 = torch.fft.rfft2(torch.randn((b, N, N), device=dev, generator=gen))
        ms = [cuda_ms(lambda: ns.forward(w0, DT, steps=steps), iters=1,
                      warmup=1 if i == 0 else 0) for i in range(rounds)]
        rates = sorted(b * steps / (t / 1e3) for t in ms)
        return {"median": rates[rounds // 2], "min": rates[0], "max": rates[-1]}

    def rate_text(r):
        return f"{r['median']:.1f} (range {r['min']:.1f}-{r['max']:.1f} over 5 calls)"

    kol_rollout = rollout_rate(kol_ns, kbatch)
    print(f"main path 5: the fused Galerkin rollout alone at b{kbatch}: "
          f"{rate_text(kol_rollout)} sample-steps/s", flush=True)

    # -- 11. main path 6: the fno dataset, IMEX order 2 on torch.fft ----------
    fno_rows = {}
    for tag, extra in (("plain", []), ("replicable_init", ["--replicable-init"])):
        fargv = ["--grid-size", str(N), "--subsample", "4", "--batch-size", "8",
                 "--num-samples", "16", "--time", "0.4", "--time-warmup", "0.1",
                 "--dt", str(DT), "--num-steps", "30", "--filepath",
                 os.path.join(tmp, tag), *extra]
        ss.reset_launch_counts()
        t0 = time.perf_counter()
        fpath = generate.main_fno(fargv)
        torch.cuda.synchronize()
        fwall = time.perf_counter() - t0
        with np.load(fpath) as z:
            fvort = z["vorticity"]
        with open(fpath + ".meta.json") as f:
            fmeta = json.load(f)
        fsteps = 2 * (100 + 1 + 29 * 10)
        fno_rows[tag] = dict(seconds=fwall, steps=fsteps,
                             sample_steps_per_s=8 * fsteps / fwall,
                             launches=dict(ss.LAUNCHES))
        print(f"main path 6: fno {tag} 256^2->64^2, 16 samples b8, {fsteps} steps "
              f"in {fwall:.2f} s: {fno_rows[tag]['sample_steps_per_s']:.1f} "
              f"sample-steps/s with the IC and the recorder, fft_impl "
              f"{fmeta['fft_impl']}, records {fvort.shape}, spectral-step launches "
              f"{fno_rows[tag]['launches']}", flush=True)
        _require(fvort.shape == (16, 30, 64, 64), f"fno shape {fvort.shape}")
        _require(bool(np.isfinite(fvort).all()) and np.abs(fvort).max() > 0,
                 "finite, non-zero fno dataset")
        _require(fmeta["fft_impl"] == "fft", "the fno dataset takes torch.fft")
        _require(not any(fno_rows[tag]["launches"].values()),
                 "no spectral-step kernel on the IMEX order-2 path")
    fgrid = grids.Grid((N, N), domain=((0, 1.0), (0, 1.0)))
    fno_ns = NavierStokes2DSpectral(
        viscosity=1e-3, grid=fgrid, fft_impl="fft", solver=IMEXStepper(order=2),
        forcing_fn=forcings.SinCosForcing(grid=fgrid, scale=0.1, diam=1.0,
                                          wave_number=1, vorticity=True),
        device=dev)
    fno_rollout = {b: rollout_rate(fno_ns, b) for b in (8, 64)}
    full_h = {b: {k: 1280 * 5e4 / v / 3600 for k, v in r.items()}
              for b, r in fno_rollout.items()}
    print("main path 6: the IMEX-2 torch.fft rollout alone: "
          + ", ".join(f"b{b} {rate_text(r)} sample-steps/s" for b, r in fno_rollout.items())
          + "; the full fno dataset (1,280 samples x 5e4 steps) would take "
          + ", ".join(f"{h['median']:.2f} h ({h['max']:.2f}-{h['min']:.2f}) at b{b}"
                      for b, h in full_h.items()), flush=True)
    # -- 12. main path 7: the fine-tune example at 256^2 in fp64 --------------
    from tpu_cfd_torch.data.datasets import SpatioTemporalDataset
    from tpu_cfd_torch.examples import ex2_sfno_finetune, ex2_train_and_finetune
    from tpu_cfd_torch.train import finetune

    kernel_modules = (ss, sc, ffn_ops, adam_ops)

    def launch_counts() -> dict:
        return {k: v for mod in kernel_modules for k, v in mod.LAUNCHES.items()}

    # the example's test set: fp64 256^2 McWilliams trajectories, 70 records
    # (the example reads frames 50-69), 8 samples at b=8
    ft_argv = ["--grid-size", str(N), "--subsample", "1", "--double",
               "--num-samples", "8", "--batch-size", "8", "--time", "0.8",
               "--time-warmup", "0.1", "--dt", str(DT), "--num-steps", "70",
               "--filepath", os.path.join(tmp, "fp64")]
    t0 = time.perf_counter()
    ft_data = generate.main_mcwilliams(ft_argv)
    ft_gen_s = time.perf_counter() - t0
    with np.load(ft_data) as z:
        ftv = z["vorticity"]
    print(f"main path 7: fp64 test set {ftv.shape} {ftv.dtype} in {ft_gen_s:.2f} s",
          flush=True)
    _require(ftv.dtype == np.float64 and ftv.shape == (8, 70, N, N)
             and bool(np.isfinite(ftv).all()), "the fp64 256^2 test set")
    for mod in kernel_modules:
        mod.reset_launch_counts()
    t0 = time.perf_counter()
    ft = ex2_sfno_finetune.main(["--example", "McWilliams2d", "--res", str(N), "--test-file", ft_data,
                                 "--ckpt", sfno_ckpt, "--gt-floor", "--lr-decay", "0.05",
                                 "--iters", str(FT_ITERS)])
    torch.cuda.synchronize()
    ft_wall = time.perf_counter() - t0
    ft_launches = launch_counts()
    ft_res = [h["residual"] for h in ft["history"]]
    iter_ms = sorted(1e3 * t for t in ft["iter_seconds"][1:-1])
    ft_row = {"seconds": ft_wall, "zero_shot_rel_l2": ft["zero_shot_rel_l2"],
              "gt_floor": ft["gt_floor"], "iter0": ft_res[0], "best": ft["best"],
              "best_iter": ft["best_iter"], "last": ft_res[-1],
              "zero_shot_ms": ft["zero_shot_ms"], "gt_floor_ms": ft["gt_floor_ms"],
              "iter_ms_median": iter_ms[len(iter_ms) // 2],
              "iter_ms_range": [iter_ms[0], iter_ms[-1]], "launches": ft_launches,
              "generate_s": ft_gen_s}
    print(f"main path 7: ex2_sfno_finetune McWilliams2d 256^2 fp64, {FT_ITERS} iterations "
          f"in {ft_wall:.2f} s: zero-shot rel-L2 {ft['zero_shot_rel_l2']:.5e}, GT floor "
          f"{ft['gt_floor']:.4e}, iter 0 {ft_res[0]:.4e}, best {ft['best']:.4e} at iter "
          f"{ft['best_iter']}, last {ft_res[-1]:.4e}; zero-shot forward "
          f"{ft['zero_shot_ms']:.1f} ms, GT floor {ft['gt_floor_ms']:.1f} ms, "
          f"{ft_row['iter_ms_median']:.2f} ms an iteration (median of the {len(iter_ms)} "
          f"after the first, range {iter_ms[0]:.2f}-{iter_ms[-1]:.2f}) on {card}; kernel "
          f"launches {ft_launches}", flush=True)
    _require(all(np.isfinite([h[k] for h in ft["history"] for k in h]))
             and np.isfinite(ft["zero_shot_rel_l2"]) and np.isfinite(ft["gt_floor"]),
             "finite fine-tune history, zero-shot error and GT floor")
    _require(min(ft_res[1:]) < ft_res[0],
             "the fine-tune takes the residual below iteration 0's")
    _require(not any(ft_launches.values()),
             f"no hand-written kernel on the fp64 fine-tune: {ft_launches}")

    # card against CPU from the same trajectory: fine_tune_post's fields at
    # the example's dt (the gate) and the GT floor they give, then the norm
    # and one step's gradients at dt 1e-3, where the O(dt^2) residual stands
    # far above the roundoff that the +-dt difference divides by dt
    ft_ds = SpatioTemporalDataset(ft_data, n_samples=16, fields=["vorticity"], steps=10,
                                  out_steps=10, T_start=50, train=False, dtype=np.float64)
    ft_in, ft_gt = (torch.from_numpy(x["vorticity"]) for x in ft_ds.sample(np.array([1])))
    diam = 2 * np.pi
    res_hm1 = losses.SobolevLoss(n_grid=N, norm_order=-1, relative=False,
                                 time_average=True, alpha=10 ** (-3 / 2),
                                 freq_cutoff=N // 2 + 1, diam=diam)
    post = {}
    places = (("card", dev), ("cpu", torch.device("cpu")))
    for where, d in places:
        with torch.no_grad():
            o = finetune.fine_tune_post(
                ft_gt.to(d), torch.zeros((1, N, N), dtype=torch.float64, device=d),
                visc=1e-3, dt=1e-6, diam=diam, bdf_weight=(0.5, 0.5))
        post[where] = {k: v.cpu() for k, v in o.items()}
    wt_scale = float(post["cpu"]["w_t"].abs().max())
    post_err = {k: float((post["card"][k] - post["cpu"][k]).abs().max()) / wt_scale
                for k in post["cpu"]}
    floors = {k: float(res_hm1(v["residual"])) for k, v in post.items()}
    floor_err = abs(floors["card"] - floors["cpu"]) / floors["cpu"]
    trained = SFNO(modes_x=rm, modes_y=rm, modes_t=RECIPE["modes_t"], width=rw,
                   output_steps=rt)
    tpipe.load_checkpoint(sfno_ckpt, trained)
    ft_grads, ft_norms, ft_models = {}, {}, {}
    for where, d in places:
        m = finetune.build_finetune_outconv(
            trained.out_conv.conv, (rm, rm, RECIPE["modes_t"]), (64, 64, 6), out_steps=rt,
            generator=torch.Generator().manual_seed(1), dtype=torch.float64, device=d,
            delta=1.0, diam=diam, visc=1e-3, dt=1e-3, bdf_weight=(0.5, 0.5))
        out = m(ft_in[..., None].to(d), ft_in.to(d), None, out_steps=rt)
        loss = res_hm1(out["residual"])
        loss.backward()
        ft_models[where] = m
        ft_norms[where] = float(loss)
        ft_grads[where] = {k: p.grad.cpu() for k, p in m.named_parameters()}
    grad_err = max(float((ft_grads["card"][k] - g).abs().max() / g.abs().max())
                   for k, g in ft_grads["cpu"].items())
    norm_err = abs(ft_norms["card"] - ft_norms["cpu"]) / ft_norms["cpu"]
    ft_row["card_vs_cpu"] = {"fields_over_max_w_t": post_err, "gt_floor": floors,
                             "gt_floor_rel": floor_err, "norm_dt1e-3_rel": norm_err,
                             "grad_dt1e-3_rel": grad_err}
    print(f"main path 7: card vs CPU, fine_tune_post at dt 1e-6: max err / max|w_t| "
          + ", ".join(f"{k} {e:.3e}" for k, e in post_err.items())
          + f" (tol {FT_DEVICE_TOL}); GT floor {floors['card']:.9e} / {floors['cpu']:.9e}, "
          f"relative difference {floor_err:.3e} (tol {FT_FLOOR_TOL}); at dt 1e-3 the "
          f"residual norm {norm_err:.3e} and one step's gradients {grad_err:.3e} of the largest entry "
          f"(tol {FT_DEVICE_TOL})", flush=True)
    _require(max(post_err.values()) < FT_DEVICE_TOL, "fine_tune_post card vs CPU")
    _require(floor_err < FT_FLOOR_TOL, "GT floor card vs CPU")
    _require(abs(ft["gt_floor"] - floors["card"]) <= 1e-12 * floors["card"],
             "the example's GT floor is fine_tune_post's on the same frames")
    _require(norm_err < FT_DEVICE_TOL and grad_err < FT_DEVICE_TOL,
             "residual norm and gradients card vs CPU at dt 1e-3")
    # where an iteration's time goes: the card's busy share over one update,
    # forward and backward of the fine-tune at the example's shapes
    ft_card = ft_models["card"]
    ft_opt = finetune.groupwise_adam(1e-4, 1e-2, ft_card.named_parameters())
    ft_x, ft_res_in = ft_in[..., None].to(dev), ft_in.to(dev)

    def ft_iteration():
        ft_opt.zero_grad(set_to_none=True)
        res_hm1(ft_card(ft_x, ft_res_in, None, out_steps=rt)["residual"]).backward()
        ft_opt.step()

    ft_iteration()
    ft_row["profile"] = profile_steps("fine-tune iteration fp64", ft_iteration, 5)
    del trained, post, ft_grads, ft_models, ft_card, ft_opt

    # -- 12b. main path 8: the fp32 demo, generate -> train -> fine-tune -------
    for mod in kernel_modules:
        mod.reset_launch_counts()
    t0 = time.perf_counter()
    demo = ex2_train_and_finetune.main(["--workdir", os.path.join(tmp, "demo")])
    torch.cuda.synchronize()
    demo_wall = time.perf_counter() - t0
    demo_launches = launch_counts()
    with open(demo["data_path"] + ".meta.json") as f:
        demo_meta = json.load(f)
    # the dataset CLI's step count at the demo's arguments (data/generate.py)
    g = dict(zip(ex2_train_and_finetune.GENERATE[::2], ex2_train_and_finetune.GENERATE[1::2]))
    g_dt = float(g["--dt"])
    g_total = int((float(g["--time"]) - float(g["--time-warmup"])) / g_dt)
    g_every = max(1, g_total // int(g["--num-steps"]))
    g_records = -(-g_total // g_every)  # 25 at the demo's arguments
    demo_steps = (int(g["--num-samples"]) // int(g["--batch-size"])) * (
        int(float(g["--time-warmup"]) / g_dt) + 1 + (g_records - 1) * g_every)
    fused = int(demo_meta["fft_impl"] == "dft_galerkin_fused")
    layers = ex2_train_and_finetune.MODEL["num_spectral_layers"]
    lat, width, mx = (ex2_train_and_finetune.MODEL[k] for k in ("latent_steps", "width",
                                                                  "modes_x"))
    dn = int(g["--grid-size"]) // int(g["--subsample"])
    # each SpectralConvS: a train step launches each transform twice (its
    # forward and its partner's backward), a forward pass once
    pair_train = int(fused_pair_wins(dn, dn, mx, mx, ex2_train_and_finetune.BATCH * lat * width))
    pair_pred = int(fused_pair_wins(dn, dn, mx, mx, lat * width))
    n_train = demo["train_steps"]
    want = {**{k: demo_steps * 5 * fused for k in ("inverse_first", "advect", "forward_first")},
            "ffn": layers * (n_train + 1),
            **{k: (layers - 1) * (2 * n_train * pair_train + pair_pred)
               for k in ("modes", "inverse", "modes_fused", "inverse_fused")},
            "adam": 0, "adam_leaves": 0}
    demo_row = {"seconds": demo_wall, "fft_impl": demo_meta["fft_impl"],
                "train_history": demo["train_history"],
                "finetune_history": demo["finetune_history"], "launches": demo_launches,
                "expected_launches": want}
    print(f"main path 8: ex2_train_and_finetune in {demo_wall:.2f} s: dataset "
          f"{demo_meta['fft_impl']} ({demo_steps} steps), {n_train} train steps, losses "
          f"{demo['train_history']}, fine-tune residual {demo['finetune_history'][0]:.3e} -> "
          f"{demo['finetune_history'][-1]:.3e}; launches {demo_launches}, expected {want}",
          flush=True)
    _require(all(np.isfinite(demo["train_history"] + demo["finetune_history"])),
             "finite demo histories")
    _require(demo_launches == want, f"demo launches {demo_launches}, expected {want}")

    # the demo's kernel instances at its own shapes, each against its plain
    # version: the 128^2 b4 rollout from the CLI's IC (advect_layout tiles
    # 128^2 otherwise than 256^2), the DFT pair at 64^2 m12 on the train
    # step's and the prediction's planes, the FFN's instance on their rows
    dsz, db = int(g["--grid-size"]), int(g["--batch-size"])
    dgrid = grids.Grid((dsz, dsz), domain=((0, 2 * np.pi), (0, 2 * np.pi)))
    demo_ns = NavierStokes2DSpectral(
        viscosity=demo_meta["visc"], grid=dgrid, fft_impl="dft_galerkin", fused=True,
        mxu_precision=demo_meta["mxu_precision"], device=dev)
    dnoise = torch.stack([
        torch.randn(dgrid.shape, device=dev,
                    generator=ic.sample_generator(demo_meta["seed"], i, dev))
        for i in range(db)])
    dw_hat = demo_ns._align(torch.fft.rfft2(ic.vorticity_field(dgrid, 4, noise=dnoise).data))
    dc = ss.constants("galerkin", dgrid, demo_ns.viscosity, demo_ns.drag, g_dt, dev)
    got = ss._fused_rollout(
        dw_hat, layout="galerkin", grid=dgrid, viscosity=demo_ns.viscosity,
        drag=demo_ns.drag, dt=g_dt, steps=10, forcing_hat=None,
        precision=demo_ns.mxu_precision, block_cols="auto")
    torch.cuda.synchronize()
    want_r = ss._fused_rollout_plain(dw_hat, dc, 10, ss.resolve_block_cols("auto", dsz, dc["m"]))
    torch.cuda.synchronize()
    demo_err = {"rollout_rel_l2": rel(got, want_r)}
    print(f"main path 8: fused Galerkin rollout {dsz}^2 b{db}, viscosity "
          f"{demo_meta['visc']}, 10 steps from the CLI's IC: rel-L2 kernel vs plain "
          f"{demo_err['rollout_rel_l2']:.3e} (tol {ROLLOUT_TOL})", flush=True)
    _require(bool(torch.isfinite(got).all()), "finite demo rollout")
    _require(demo_err["rollout_rel_l2"] < ROLLOUT_TOL, "demo rollout vs plain")
    dcc = _dft2d_constants(dn, dn, mx, mx, str(dev), "complex64")
    demo_ffn = next(m for m in SFNO(**ex2_train_and_finetune.MODEL).modules()
                    if isinstance(m, sfno_mod.PointwiseFFN))
    d0, d1 = demo_ffn.dense_0, demo_ffn.dense_1
    for b in (ex2_train_and_finetune.BATCH, 1):
        v = torch.randn(b, lat * width, dn, dn, device=dev, generator=gen)
        gg = torch.randn(b, lat * width, 2 * mx, 2 * mx, dtype=torch.complex64,
                         device=dev, generator=gen)
        tag = f"demo {dn}^2 m{mx} {b * lat * width} planes"
        demo_err[f"dft2d_modes_{b * lat * width}"] = check(
            f"dft2d_modes {tag}", sc.modes(v, dcc), sc._modes_plain(v, dcc))
        demo_err[f"dft2d_inverse_{b * lat * width}"] = check(
            f"dft2d_inverse {tag}", sc.inverse(gg, 1.0 / (dn * dn * lat), dcc),
            sc._inverse_plain(gg, 1.0 / (dn * dn * lat), dcc))
        rows = b * dn * dn * lat
        x = torch.randn(rows, d0.in_features, device=dev, generator=gen)
        w = [torch.randn(*t.shape, device=dev, generator=gen) * a for t, a in (
            (d0.weight, 0.3), (d0.bias, 0.1), (d1.weight, 0.15), (d1.bias, 0.1))]
        demo_err[f"pointwise_ffn_{rows}"] = check(
            f"pointwise_ffn demo {rows} rows {d0.in_features}->{d0.out_features}->"
            f"{d1.out_features} {demo_ffn.activation}",
            ffn_ops.ffn_forward(x, *w, demo_ffn.activation),
            ffn_ops._ffn_plain(x, *w, demo_ffn.activation))
    demo_row["kernel_vs_plain"] = demo_err
    del demo_ns, dnoise, dw_hat, dc, got, want_r, v, gg, x, w

    # -- 13. the FVM solver through the Kolmogorov FVM example --------------
    from tpu_cfd_torch.examples import ex1_kolmogorov_fvm as ex_fvm

    fvm_rows = {}
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).split(".")[-1]
        t0 = time.perf_counter()
        fr = ex_fvm.main(["--n", str(FVM_N), "--frames", str(FVM_FRAMES),
                          "--inner-steps", str(FVM_INNER),
                          "--out", os.path.join(tmp, f"fvm_{tag}.png"),
                          *(["--f32"] if dtype == torch.float32 else [])])
        wall = time.perf_counter() - t0
        finite = bool(np.isfinite(fr["frames"]).all()) and all(
            bool(torch.isfinite(u.data).all()) for u in fr["velocity"])
        fvm_rows[tag] = {"ms_per_step": fr["ms_per_step"], "max_div": fr["max_div"],
                         "finite": finite, "dt": fr["dt"], "seconds": wall}
        print(f"phase 13: ex1_kolmogorov_fvm {FVM_N}^2 {tag}, classic RK4 + projection, "
              f"Kolmogorov forcing and drag 0.1, dt {fr['dt']:.6f}, {FVM_FRAMES} frames "
              f"of {FVM_INNER} steps: {fr['ms_per_step']:.3f} ms a step on {card} "
              f"({wall:.2f} s with the IC); final max |div| {fr['max_div']:.3e}",
              flush=True)
        _require(finite and fr["velocity"][0].data.device == dev,
                 f"finite FVM rollout on the card ({tag})")
        _require(fr["max_div"] < (1e-12 if dtype == torch.float64 else 1e-4),
                 f"divergence-free FVM velocity ({tag})")
        v, eqn, vdt = ex_fvm.build(FVM_N, dtype, dev)
        eqn(v, vdt)  # the forcing, the FFT plans and the solver's constants
        fvm_rows[tag]["profile"] = profile_steps(f"FVM step {tag}", lambda: eqn(v, vdt), 5)
    # card against CPU over 20 steps in fp64, from the example's IC
    ends = {}
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        v, eqn, vdt = ex_fvm.build(FVM_N, torch.float64, d)
        for _ in range(FVM_INNER):
            v = eqn(v, vdt)
        ends[where] = [u.data.cpu() for u in v]
    fvm_err = max(float((a - b).abs().max() / b.abs().max())
                  for a, b in zip(ends["card"], ends["cpu"]))
    fvm_rows["card_vs_cpu_rel"] = fvm_err
    print(f"phase 13: FVM card vs CPU after {FVM_INNER} steps in fp64: max err / max "
          f"{fvm_err:.3e} (tol {FVM_DEVICE_TOL})", flush=True)
    _require(fvm_err < FVM_DEVICE_TOL, "FVM card vs CPU")

    # -- 14. main path 9: --data-parallel in both CLIs, world 1 on NCCL -------
    import glob

    import torch.distributed as dist

    from tpu_cfd_torch import parallel
    from tpu_cfd_torch.parallel.launch import _free_port

    def same_dataset(p1, p2) -> dict:
        """The JAX package's tolerances for --data-parallel against one
        process (tests/test_parallel.py:215-239); the largest difference of
        each field."""
        diffs = {}
        with np.load(p1) as a, np.load(p2) as b:
            _require(set(a.files) == set(b.files), f"fields of {p2}")
            scale_vt = np.abs(a["vort_t"]).max() if a["vort_t"].size else 0.0
            for k in a.files:
                x, y = a[k], b[k]
                _require(x.shape == y.shape, f"{k} shape {y.shape} against {x.shape}")
                if not x.size:  # a field the run did not record
                    continue
                d = float(np.abs(x.astype(np.float64) - y).max())
                tol = (0.0 if x.dtype.kind in "iu" else 1e-4 * scale_vt
                       if k in ("vort_t", "residual") else 1e-5 * np.abs(x).max())
                _require(d <= tol, f"{k} differs under --data-parallel: {d} > {tol}")
                diffs[k] = d
        return diffs

    def same_params(got, want, what) -> float:
        """rtol 2e-4, atol 2e-6 (tests/test_parallel.py:184); the largest
        absolute difference."""
        worst = 0.0
        for k, w_ in want.items():
            g_ = got[k].detach().cpu()
            _require(bool(torch.allclose(g_, w_, rtol=2e-4, atol=2e-6)),
                     f"{what}: parameter {k} differs from phase 6's")
            worst = max(worst, float((g_ - w_).abs().max()))
        return worst

    def run_cli(tag, args, env_extra=None) -> float:
        """A CLI as a user starts it, in a process of its own; its wall time."""
        env = {**os.environ, **(env_extra or {})}
        t0 = time.perf_counter()
        done = subprocess.run([sys.executable, *args], env=env, capture_output=True,
                              text=True, timeout=420)
        wall = time.perf_counter() - t0
        if done.returncode != 0:
            print(done.stdout[-3000:], done.stderr[-3000:], sep="\n", file=sys.stderr)
        _require(done.returncode == 0, f"{tag} exited with {done.returncode}")
        return wall

    DP_SAMPLES, DP_BATCH = 64, 32
    dp_gen = ["--grid-size", str(N), "--subsample", "4", "--batch-size", str(DP_BATCH),
              "--num-samples", str(DP_SAMPLES), "--time", "0.2", "--time-warmup", "0.1",
              "--dt", str(DT), "--num-steps", "100"]
    # per batch: 100 warmup steps, then 100 records one step apart
    dp_batch_steps = 100 + 1 + 99
    dp_rows = {}
    ss.reset_launch_counts()
    t0 = time.perf_counter()
    dp_base = generate.main_mcwilliams(dp_gen + ["--filepath", os.path.join(tmp, "dp_base")])
    torch.cuda.synchronize()
    dp_rows["generate_plain_s"] = time.perf_counter() - t0
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1)
    try:
        ss.reset_launch_counts()
        t0 = time.perf_counter()
        dp_path = generate.main_mcwilliams(
            dp_gen + ["--filepath", os.path.join(tmp, "dp_nccl"), "--data-parallel"])
        torch.cuda.synchronize()
        dp_rows["generate_dp_s"] = time.perf_counter() - t0
        dp_gen_launches = dict(ss.LAUNCHES)
        # what gathering a batch's records to rank 0 costs: gather_object
        # pickles them on the host, the records of 32 samples here
        with np.load(dp_path) as z:
            recs = {"vorticity": z["vorticity"][:DP_BATCH]}
        t0 = time.perf_counter()
        parallel.gather_batch(recs, parallel.make_mesh())
        dp_rows["gather_batch_s"] = time.perf_counter() - t0
        dp_rows["gather_batch_mb"] = recs["vorticity"].nbytes / 2 ** 20
        # the train CLI without and with the flag, one after the other, both
        # after phase 6's first run (its cuFFT plans and allocator warm-up)
        plain_train = train.main(targv)
        torch.cuda.synchronize()
        sc.reset_launch_counts()
        ffn_ops.reset_launch_counts()
        dp_train = train.main(targv + ["--data-parallel"])
        torch.cuda.synchronize()
        dp_train_launches = {**sc.LAUNCHES, **ffn_ops.LAUNCHES}
    finally:
        dist.destroy_process_group()
    dp_rows["dataset_diff"] = {"in-process": same_dataset(dp_base, dp_path)}
    want_k = (DP_SAMPLES // DP_BATCH) * dp_batch_steps * 5
    for key in ("inverse_first", "advect", "forward_first"):
        _require(dp_gen_launches[key] == want_k, f"--data-parallel: {key} launched "
                 f"{dp_gen_launches[key]} times, expected {want_k}")
    for key in per_step:
        want = train_steps * per_step[key] + val_batches * per_eval[key]
        _require(dp_train_launches[key] == want, f"--data-parallel train: {key} "
                 f"launched {dp_train_launches[key]} times, expected {want}")
    dp_rows["params_max_diff"] = {"in-process": same_params(
        dp_train["model"].state_dict(), p6_final, "train --data-parallel in-process")}
    sample_steps = DP_SAMPLES * dp_batch_steps
    dp_rows["sample_steps_per_s"] = {
        "plain": sample_steps / dp_rows["generate_plain_s"],
        "data_parallel": sample_steps / dp_rows["generate_dp_s"]}
    dp_rows["params_max_diff"]["in-process, without the flag"] = same_params(
        plain_train["model"].state_dict(), p6_final, "train again without the flag")
    # ms a train step: the second epoch's 2 steps and its validation batch
    dp_rows["train_ms_per_step"] = {
        "plain": 1e3 * plain_train["history"][-1]["seconds"] / 2,
        "data_parallel": 1e3 * dp_train["history"][-1]["seconds"] / 2,
        "phase_6_first_run": 1e3 * hist[-1]["seconds"] / 2}
    print(f"main path 9: --data-parallel at world 1 on NCCL: generate {DP_SAMPLES} samples "
          f"b{DP_BATCH} {N}^2->64^2 ({dp_batch_steps} steps a batch) "
          f"{dp_rows['sample_steps_per_s']['data_parallel']:.1f} sample-steps/s against "
          f"{dp_rows['sample_steps_per_s']['plain']:.1f} without the flag (just before), "
          f"launches {dp_gen_launches}; gather_batch of {dp_rows['gather_batch_mb']:.1f} MB "
          f"{dp_rows['gather_batch_s']:.3f} s; train "
          f"{dp_rows['train_ms_per_step']['data_parallel']:.2f} ms/step against "
          f"{dp_rows['train_ms_per_step']['plain']:.2f} without the flag (just before; "
          f"phase 6's first run {dp_rows['train_ms_per_step']['phase_6_first_run']:.2f}; "
          f"the second epoch, validation included), launches {dp_train_launches}; dataset "
          f"max differences {dp_rows['dataset_diff']['in-process']}, parameters "
          f"{dp_rows['params_max_diff']['in-process']:.3e}", flush=True)
    # the same two CLIs as a user launches them: under torch.distributed.run,
    # and plainly (one worker a visible card, by torch.multiprocessing.spawn)
    launchers = {"torchrun": ["-m", "torch.distributed.run", "--standalone",
                              "--nproc_per_node", "1", "-m"],
                 "spawn": ["-m"]}
    dp_rows["launch_s"] = {}
    for tag, launcher in launchers.items():
        paths = {var: os.path.join(tmp, tag, var.lower())
                 for var in ("MODEL_PATH", "LOG_PATH", "FIG_PATH")}
        gen_s = run_cli(f"generate ({tag})", [
            *launcher, "tpu_cfd_torch.data.generate", "mcwilliams", "--data-parallel",
            *dp_gen, "--filepath", os.path.join(tmp, tag)])
        train_s = run_cli(f"train ({tag})", [
            *launcher, "tpu_cfd_torch.train.train", "--data-parallel", *targv], paths)
        dp_rows["launch_s"][tag] = {"generate": gen_s, "train": train_s}
        dp_rows["dataset_diff"][tag] = same_dataset(
            dp_base, os.path.join(tmp, tag, os.path.basename(dp_base)))
        best = torch.load(os.path.join(paths["MODEL_PATH"], os.path.basename(sfno_ckpt))
                          + ".pt", map_location="cpu", weights_only=True)
        dp_rows["params_max_diff"][tag] = same_params(best, p6_best, f"train ({tag})")
        print(f"main path 9: {tag}: generate {gen_s:.2f} s, train {train_s:.2f} s "
              f"(process start included); dataset max differences "
              f"{dp_rows['dataset_diff'][tag]}; best checkpoint against phase 6's "
              f"{dp_rows['params_max_diff'][tag]:.3e}", flush=True)
    _require(not dist.is_initialized(), "the process group is destroyed")

    # -- 15. main path 10: the examples and --demo-plots ---------------------
    from tpu_cfd_torch.examples import (check_sfno_shapes, ex1_kolmogorov_simulation,
                                        ex2_sfno_5ep_spectra)

    def hold_instances(tag, model, forwards, modes, width, latent):
        """The DFT pair, where ``fused_pair_wins`` sends it, and the FFN at
        each (batch, n) of ``forwards``, against their plain versions."""
        ffn_mod = next(m for m in model.modules() if isinstance(m, sfno_mod.PointwiseFFN))
        d0, d1 = ffn_mod.dense_0, ffn_mod.dense_1
        errs = {}
        for b, n in sorted(set(forwards)):
            planes = b * latent * width
            if fused_pair_wins(n, n, modes, modes, planes):
                cc = _dft2d_constants(n, n, modes, modes, str(dev), "complex64")
                v = torch.randn(b, latent * width, n, n, device=dev, generator=gen)
                gg = torch.randn(b, latent * width, 2 * modes, 2 * modes,
                                 dtype=torch.complex64, device=dev, generator=gen)
                at = f"{tag} {n}^2 m{modes} {planes} planes"
                errs[f"dft2d_modes {n} {planes}"] = check(
                    f"dft2d_modes {at}", sc.modes(v, cc), sc._modes_plain(v, cc))
                errs[f"dft2d_inverse {n} {planes}"] = check(
                    f"dft2d_inverse {at}", sc.inverse(gg, 1.0 / (n * n * latent), cc),
                    sc._inverse_plain(gg, 1.0 / (n * n * latent), cc))
            rows = b * n * n * latent
            x = torch.randn(rows, d0.in_features, device=dev, generator=gen)
            w = [torch.randn(*t.shape, device=dev, generator=gen) * a for t, a in (
                (d0.weight, 0.3), (d0.bias, 0.1), (d1.weight, 0.15), (d1.bias, 0.1))]
            errs[f"pointwise_ffn {rows}"] = check(
                f"pointwise_ffn {tag} {rows} rows {d0.in_features}->{d0.out_features}->"
                f"{d1.out_features} {ffn_mod.activation}",
                ffn_ops.ffn_forward(x, *w, ffn_mod.activation),
                ffn_ops._ffn_plain(x, *w, ffn_mod.activation))
        return errs

    def expected_sfno(forwards, train, layers, modes, width, latent):
        """Launches of an SFNO's kernels over the train steps ``train`` =
        (batch, n, steps) and the forward-only passes ``forwards`` [(batch,
        n)]: the FFN once a layer a forward; the DFT pair, where its shape
        takes it, once a SpectralConvS (layers - 1) a forward and once more in
        a backward."""
        def pair(b, n):
            return int(fused_pair_wins(n, n, modes, modes, b * latent * width))

        b, n, steps = train
        dft = (layers - 1) * (2 * steps * pair(b, n) + sum(pair(*f) for f in forwards))
        return {"modes": dft, "inverse": dft, "modes_fused": dft, "inverse_fused": dft,
                "ffn": layers * (steps + len(forwards))}

    ex_rows = {}
    for mod in kernel_modules:
        mod.reset_launch_counts()
    t0 = time.perf_counter()
    kol = ex1_kolmogorov_simulation.main(["--out", os.path.join(tmp, "kolmogorov_demo")])
    torch.cuda.synchronize()
    ex_rows["kolmogorov_simulation"] = {
        "seconds": time.perf_counter() - t0, "enstrophy": kol["enstrophy"],
        "peak_k": kol["peak_k"], "launches": launch_counts(), "figures": kol["figures"]}
    r = ex_rows["kolmogorov_simulation"]
    print(f"main path 10: ex1_kolmogorov_simulation 256^2, 3000 steps on torch.fft in "
          f"{r['seconds']:.2f} s: final enstrophy {r['enstrophy']:.4f}, spectrum peak "
          f"k={r['peak_k']}, launches {r['launches']}", flush=True)
    _require(np.isfinite(kol["trajectory"]).all() and kol["spectrum"].shape == (N // 2 - 1,)
             and np.isfinite(kol["enstrophy"]), "finite Kolmogorov simulation")
    _require(not any(r["launches"].values()), "no kernel under fft_impl='fft'")

    for mod in kernel_modules:
        mod.reset_launch_counts()
    shp = check_sfno_shapes.main([])
    torch.cuda.synchronize()
    shp_launches = launch_counts()
    shp_model = check_sfno_shapes.build()
    shp_want = expected_sfno(shp["forwards"], (1, rn, 0), 4, 16, 20, 10)
    ex_rows["check_sfno_shapes"] = {
        "n_params": shp["n_params"], "shapes": {str(k): v for k, v in shp["shapes"].items()},
        "latents": shp["latents"], "ms_per_forward": shp["ms_per_forward"],
        "launches": shp_launches, "expected_launches": shp_want}
    print(f"main path 10: check_sfno_shapes: {shp['n_params']} parameters, shapes "
          f"{shp['shapes']}, {len(shp['latents'])} latents, {shp['ms_per_forward']:.3f} "
          f"ms a forward at 128^2 (CUDA events) on {card}; launches {shp_launches}, "
          f"expected {shp_want}", flush=True)
    _require(all(v == (1, n, n, t_out) for (n, _, t_out), v in shp["shapes"].items()),
             "check_sfno_shapes output shapes")
    _require(len(shp["latents"]) == 5, "five named latents")
    _require({k: shp_launches[k] for k in shp_want} == shp_want,
             f"check_sfno_shapes launches {shp_launches}, expected {shp_want}")
    ex_rows["check_sfno_shapes"]["kernel_vs_plain"] = hold_instances(
        "check_sfno_shapes", shp_model, shp["forwards"], 16, 20, 10)

    ex_argv = ["--data-file", data_path, "--num-samples", "64", "--num-val-samples", "64",
               "--out", os.path.join(tmp, "spectra.png")]
    for mod in kernel_modules:
        mod.reset_launch_counts()
    t0 = time.perf_counter()
    spec = ex2_sfno_5ep_spectra.main(ex_argv)
    torch.cuda.synchronize()
    spec_launches = launch_counts()
    spec_model = SFNO(modes_x=32, modes_y=32, modes_t=5, width=10, beta=-1e-2,
                      output_steps=10)
    # the train steps at batch 4, then one prediction of 8 held-out samples
    spec_want = expected_sfno([(8, rn)], (4, rn, spec["train_steps"]), 4, 32, 10, 10)
    ex_rows["sfno_5ep_spectra"] = {
        "seconds": time.perf_counter() - t0, "gap": spec["gap"], "history": spec["history"],
        "train_steps": spec["train_steps"], "launches": spec_launches,
        "expected_launches": spec_want}
    print(f"main path 10: ex2_sfno_5ep_spectra, 64 train and 64 held-out samples of phase "
          f"4's dataset, {len(spec['history'])} epochs ({spec['train_steps']} steps) in "
          f"{ex_rows['sfno_5ep_spectra']['seconds']:.2f} s: losses {spec['history']}, gap "
          f"{spec['gap']:.4f}; launches {spec_launches}, expected {spec_want}", flush=True)
    _require(np.isfinite(spec["gap"]) and np.isfinite(spec["history"]).all(),
             "finite spectra gap and losses")
    _require({k: spec_launches[k] for k in spec_want} == spec_want,
             f"ex2_sfno_5ep_spectra launches {spec_launches}, expected {spec_want}")
    ex_rows["sfno_5ep_spectra"]["kernel_vs_plain"] = hold_instances(
        "ex2_sfno_5ep_spectra", spec_model, [(4, rn), (8, rn)], 32, 10, 10)

    # --demo-plots: the eval phase at 256^2 in fp64 on the test set of phase 12
    t0 = time.perf_counter()
    demo_plots = train.main([*targv[:-1], "--eval-only", "--test-file", ft_data,
                             "--test-res", str(N), "--double", "--num-test-samples", "2",
                             "--demo-plots", "2"])
    try:
        import matplotlib  # noqa: F401
        has_mpl = True
    except ModuleNotFoundError:
        has_mpl = False
    ex_rows["demo_plots"] = {"seconds": time.perf_counter() - t0, "test": demo_plots["test"],
                             "figures": demo_plots["demo_plots"], "matplotlib": has_mpl}
    print(f"main path 10: train.main --demo-plots 2 (eval at {N}^2 fp64) in "
          f"{ex_rows['demo_plots']['seconds']:.2f} s: test metric "
          f"{demo_plots['test']:.4e}, figures {demo_plots['demo_plots']} (matplotlib "
          f"{'present' if has_mpl else 'absent'})", flush=True)
    _require(np.isfinite(demo_plots["test"]), "finite demo-plots test metric")
    _require(len(demo_plots["demo_plots"]) == (4 if has_mpl else 0)
             and all(os.path.exists(f) for f in demo_plots["demo_plots"]),
             "demo plots written where matplotlib is installed")

    # -- 16. the utilities on the card ---------------------------------------
    from tpu_cfd_torch.utils import profiling, tools

    util_ns = NavierStokes2DSpectral(viscosity=1e-3, grid=grid, fft_impl="dft_galerkin",
                                     fused=True, device=dev)
    util_w = initial_spectrum(B)
    util_ns.forward(util_w, DT, 1)
    trace_dir = os.path.join(tmp, "trace")
    ss.reset_launch_counts()
    with tools.timer(f"10 fused rollout steps, b{B} {N}^2, traced") as util_t:
        with profiling.profile_to(trace_dir):
            with profiling.trace_annotation("rollout"):
                util_ns.forward(util_w, DT, 10)
    traced_launches = ss.LAUNCHES["advect"]
    traces = glob.glob(os.path.join(trace_dir, "*.json"))
    _require(len(traces) == 1, f"one trace written, found {traces}")
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    advect = sum(1 for e in events if e.get("cat") == "kernel"
                 and "advect_kernel" in e.get("name", ""))
    annotated = any(e.get("name") == "rollout" for e in events)
    summary = profiling.device_memory_summary().splitlines()
    util_row = {"timer_s": util_t["seconds"], "trace_advect_kernels": advect,
                "advect_launches": traced_launches, "annotation": annotated,
                "memory_total": summary[-1].strip(), "memory_lines": len(summary) - 1}
    print(f"phase 16: profile_to wrote {os.path.basename(traces[0])}: {advect} "
          f"spectral_advect kernels (advect_kernel) of the {traced_launches} launched in "
          f"10 steps, annotation {annotated}; device_memory_summary: "
          f"{summary[-1].strip()}", flush=True)
    _require(traced_launches == 50 and 0 < advect <= traced_launches and annotated,
             "the trace holds spectral_advect launches and the annotation")
    tmp_ctx.cleanup()

    sources = {"spectral_inverse_first": ("spectral_step", "inverse_first"),
               "spectral_advect": ("spectral_step", "advect"),
               "spectral_forward_first": ("spectral_step", "forward_first"),
               "dft2d_modes": ("spectral_conv", "modes_fused"),
               "dft2d_inverse": ("spectral_conv", "inverse_fused"),
               "dft2d_modes_sweep": ("spectral_conv", "modes_fused_sweep"),
               "dft2d_inverse_sweep": ("spectral_conv", "inverse_fused_sweep"),
               "pointwise_ffn": ("ffn", "ffn"),
               "pointwise_ffn_bf16": ("ffn", "ffn_bf16"),
               "adam_step": ("adam", "adam")}
    replaces = {"spectral_step": "tpu_cfd/ops/pallas/spectral_step.py:104",
                "dft2d_modes": "tpu_cfd/models/pallas_conv.py:82",
                "dft2d_inverse": "tpu_cfd/models/pallas_conv.py:104",
                "dft2d_modes_sweep": "tpu_cfd/models/pallas_conv.py:82",
                "dft2d_inverse_sweep": "tpu_cfd/models/pallas_conv.py:104",
                "pointwise_ffn": "tpu_cfd/ops/pallas/ffn.py:33",
                "pointwise_ffn_bf16": "tpu_cfd/ops/pallas/ffn.py:33",
                "adam_step": "scripts/opt_layout_r4.py:119"}
    shapes = {
        "spectral_step": f"main path 1: b{B} {N}^2 float32",
        "spectral_conv": f"the recipe's: b{rb} {rt * rw} planes {rn}^2 m{rm} float32 "
                         "(launches: main paths 2 and 3)",
        **{name: f"main path 3: b{SWEEP_BATCH} {rt * sw} planes {rn}^2 m{sm} float32"
           for name in ("dft2d_modes_sweep", "dft2d_inverse_sweep")},
        "pointwise_ffn": f"main path 2: {ffn_recipe['rows']} rows {rw}->{4 * rw}->{rw} "
                         "GELU float32",
        "pointwise_ffn_bf16": f"main path 3: {ffn_sweep['rows']} rows {sw}->{4 * sw}->{sw} "
                              "ReLU bfloat16",
        "adam_step": f"main path 3: the {LEAVES} leaves of its SFNO, {SWEEP_PARAMS} "
                     "float32 parameters, one step"}
    # the DFT pair at the recipe's shape: its launches on main path 2 (none
    # where the recipe's SpectralConvS takes torch.fft) and on main path 3,
    # which runs the same two kernels at the sweep's shape
    # the spectral-step kernels run on main paths 1 (mcwilliams), 5 (kolmogorov)
    # and 8 (the demo's 128^2 dataset); the demo's DFT pair runs at m=12, so
    # its launches join the sweep-shape rows; path 7 (fp64) launches none
    # main path 9 runs row 1 (generate) and the FFN (train: the recipe's
    # SpectralConvS takes torch.fft); main path 10 the DFT pair at m=16 and
    # m=32 (the examples' shapes) and the FFN, whose launches join the rows
    # of the recipe's shapes
    ex_launches = {k: shp_launches[k] + spec_launches[k] for k in shp_launches}
    launches = {**{("spectral_step", k): v + kol_launches[k] + demo_launches[k]
                   + dp_gen_launches[k] for k, v in gen_launches.items()},
                **{("spectral_conv", k): v + sweep_launches[k] + dp_train_launches[k]
                   + ex_launches[k] for k, v in train_launches.items() if k in sc.LAUNCHES},
                ("spectral_conv", "modes_fused_sweep"):
                    sweep_launches["modes_fused"] + demo_launches["modes_fused"],
                ("spectral_conv", "inverse_fused_sweep"):
                    sweep_launches["inverse_fused"] + demo_launches["inverse_fused"],
                ("ffn", "ffn"): train_launches["ffn"] + demo_launches["ffn"]
                + dp_train_launches["ffn"] + ex_launches["ffn"],
                # main path 3: its bf16 run for the bf16 rows, its fp32 run for Adam
                ("ffn", "ffn_bf16"): bf16_launches["ffn"],
                ("adam", "adam"): sweep_launches["adam"]}
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": CSRC + src + ".cu",
         "replaces": replaces.get(name, replaces.get(src)),
         "launches": launches[(src, key)], "max_abs_err": r["max_abs_err"],
         "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "bound_ffma_ms": r["bound_ffma_ms"],
         "bound_tf32x3_ms": r["bound_tf32x3_ms"], "library_ms": r["library_ms"],
         "shape": shapes.get(name, shapes.get(src)),
         **({"device_ms": r["device_ms"]} if "device_ms" in r else {}),
         **({"launches_by_path": {"2": train_launches[key], "3": sweep_launches[key],
                                  "9": dp_train_launches[key], "10": ex_launches[key]}}
            if name in ("dft2d_modes", "dft2d_inverse") else {}),
         **({"launches_by_path": {"3": sweep_launches[key[:-len("_sweep")]],
                                  "8": demo_launches[key[:-len("_sweep")]]}}
            if name in ("dft2d_modes_sweep", "dft2d_inverse_sweep") else {}),
         **({"launches_by_path": {"2": train_launches["ffn"], "8": demo_launches["ffn"],
                                  "9": dp_train_launches["ffn"], "10": ex_launches["ffn"]}}
            if name == "pointwise_ffn" else {}),
         **({"launches_by_path": {"1": gen_launches[key], "5": kol_launches[key],
                                  "8": demo_launches[key], "9": dp_gen_launches[key]}}
            if src == "spectral_step" else {})}
        for name, r in results.items() for src, key in [sources[name]]],
        "launches_main_path_3": {"float32": sweep_launches, "bfloat16_scan8": bf16_launches},
        "adam_steps": adam_rows, "two_pass_ms": two_pass, "timed_x3": spread,
        "ffn_other_instances": ffn_other, "sweep_steps": sweep_rows,
        "sweep_profile": sweep_profile, "fno3d_step": fno_row,
        "fno3d_history": fhist,
        "rollouts": rollouts, "train_steps": train_rows,
        "train_step_gate_rounds_ms": gate_rounds,
        "train_step_gate": {"median_ms": gate_ms, "iqr_ms": iqr_ms, "range_ms": range_ms},
        "train_step_kernel_bound_ms": kernel_bound_ms,
        "ffn_chain_ms": chain_ms,
        "datasets": {"kolmogorov": {"seconds": kwall, "steps": ksteps,
                                    "sample_steps_per_s": kol_rate,
                                    "rollout_sample_steps_per_s": kol_rollout,
                                    "ic_max_div": div, "ic_vmax_rel_err": vmax_err,
                                    "rollout_rel_l2_vs_plain": kol_err},
                     "fno": {**fno_rows, "rollout_sample_steps_per_s": fno_rollout,
                             "full_dataset_hours": full_h}},
        "finetune_main_path_7": ft_row, "demo_main_path_8": demo_row, "fvm_phase_13": fvm_rows,
        "data_parallel_main_path_9": dp_rows, "examples_main_path_10": ex_rows,
        "utilities_phase_16": util_row, "card": card}
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())

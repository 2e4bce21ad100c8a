"""Turbulence dataset generation on the card: the McWilliams2d, Kolmogorov2d
and FNO CLIs (PyTorch).

Counterpart of ``tpu_cfd/data/generate.py``. The per-batch pipeline is:
initial vorticity -> warmup rollout -> recorded rollout in chunks, each
chunk inverse-transformed and bilinearly subsampled on the device -> npz
part files, with resume, a sidecar meta file and a divergence guard.

Usage (the JAX package's flags; ``--no-cuda`` runs on the CPU):
  python -m tpu_cfd_torch.data.generate mcwilliams --grid-size 256 \
      --subsample 4 --num-samples 1152 --batch-size 128 --visc 1e-3 \
      --time 10 --time-warmup 4.5 --dt 1e-3 --num-steps 100
  python -m tpu_cfd_torch.data.generate kolmogorov --grid-size 256 \
      --subsample 4 --num-samples 1152
  python -m tpu_cfd_torch.data.generate fno --grid-size 256 --subsample 4 \
      --num-samples 1280 --visc 1e-3 [--replicable-init]

``--data-parallel`` splits each batch's samples over the ranks of a process
group and stores the dataset the run without it stores. On the card:
  python -m torch.distributed.run --standalone --nproc_per_node N \
      -m tpu_cfd_torch.data.generate mcwilliams --data-parallel ...
or plainly ``python -m tpu_cfd_torch.data.generate mcwilliams
--data-parallel ...``, which starts one worker a visible card; with
``--no-cuda`` a world of one on gloo (``parallel.launch``).
"""

from __future__ import annotations

import functools
import json
import logging
import math
import os
import sys
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from tpu_cfd_torch import grids, parallel
from tpu_cfd_torch.data import data_utils
from tpu_cfd_torch.data.grf import GRF2d
from tpu_cfd_torch.device import resolve_device
from tpu_cfd_torch.ops import finite_differences as fdm
from tpu_cfd_torch.solvers import equations, forcings, initial_conditions as ic
from tpu_cfd_torch.solvers import trajectories
from tpu_cfd_torch.solvers.equations import (
    IMEXStepper,
    NavierStokes2DSpectral,
    RK4CrankNicolsonStepper,
)


def _subsample_field(x: torch.Tensor, ns: int) -> torch.Tensor:
    """Bilinear downsample of (..., n, n) fields to (..., ns, ns).

    Antialiased, as ``jax.image.resize(..., "bilinear")`` is when it
    downsamples.
    """
    if x.shape[-1] == ns:
        return x
    lead, n = x.shape[:-2], x.shape[-1]
    y = F.interpolate(x.reshape(-1, 1, n, n), size=(ns, ns), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.reshape(*lead, ns, ns)


def make_batch_pipeline(
    ns2d: NavierStokes2DSpectral,
    dt: float,
    warmup_steps: int,
    total_steps: int,
    record_every: int,
    ns: int,
    fields=("vorticity",),
    max_steps_per_program: int = 2000,
):
    """Returns a fn: ŵ0 batch -> physical-space records dict (host numpy).

    The warmup runs in calls of at most ``max_steps_per_program`` steps, and
    the recording rollout in chunks of as many steps, each chunk
    inverse-transformed and subsampled before it leaves the device.
    """
    n = ns2d.grid.shape[-1]

    def postprocess(recs):
        return {
            k: _subsample_field(torch.fft.irfft2(v, s=(n, n)), ns)
            for k, v in recs.items()
        }

    @torch.no_grad()
    def pipeline(vort_hat: torch.Tensor) -> Dict[str, np.ndarray]:
        remaining = warmup_steps
        while remaining > 0:
            s = min(max_steps_per_program, remaining)
            vort_hat = ns2d.forward(vort_hat, dt, steps=s)[0]
            remaining -= s
        result, _ = trajectories.get_trajectory_imex_chunked(
            ns2d,
            vort_hat,
            dt,
            num_steps=total_steps,
            record_every_steps=record_every,
            fields=fields,
            records_per_chunk=max(1, max_steps_per_program // record_every),
            postprocess=postprocess,
        )
        return result

    return pipeline


def _read_meta(meta_path: str) -> dict:
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            return json.load(f)
    return {}


def _write_meta(meta_path: str, meta: dict) -> None:
    with open(meta_path, "w") as f:
        json.dump(meta, f)


def _repin_meta(
    meta_path: str, new_impl: str, *, record_mix: bool, base: dict | None = None
) -> None:
    """Rewrite the sidecar's ``fft_impl`` pin to the impl actually in use.

    With ``record_mix``, a different earlier pin is folded into
    ``mixed_fft_impls``. ``base`` seeds the full sidecar schema when the
    file is missing or empty.
    """
    meta = _read_meta(meta_path)
    if not meta and base:
        meta = dict(base)
    old = meta.get("fft_impl")
    if record_mix and old and old != new_impl:
        mixed = set(meta.get("mixed_fft_impls", [])) | {old, new_impl}
        meta["mixed_fft_impls"] = sorted(mixed)
    meta["fft_impl"] = new_impl
    _write_meta(meta_path, meta)


def default_fft_impl(n: int, batch_size: int, double: bool, dealias: bool,
                     fused_ok: bool) -> str:
    """The transform a run takes when ``--fft-impl`` is not given:
    ``equations.recommended_fft_impl``'s where the fused kernel can step the
    run's integrator (``fused_ok``), else ``torch.fft``, the fastest route
    without the kernel on the card."""
    if not fused_ok:
        return "fft"
    return equations.recommended_fft_impl(n, batch_size, double=double, dealias=dealias)


def _impl_runs(impl: str, *, solver, dtype: torch.dtype, dealias: bool) -> bool:
    """Whether the transform ``impl`` (a resumed run's pin) can step a solver
    of this stepper (``None``: the default), dtype and dealiasing."""
    if impl.endswith("_fused"):
        return equations.fused_refusal(solver, dtype, dealias) is None
    return dealias or impl != "dft_galerkin"


def _resume_plan(args, data_filepath: str, meta_path: str, fft_impl: str,
                 fft_impl_explicit: bool, impl_compatible, logger) -> dict:
    """Reads the files of a resumable run: how many samples exist, whether
    the run is done (the parts then merged), and the transform the remaining
    samples take (the sidecar's pin). Rank 0 alone calls it."""
    plan = {"done": False, "existing": 0, "fft_impl": fft_impl,
            "mxu_precision": getattr(args, "mxu_precision", "high"),
            "sidecar_needs_repin": False}
    existing = 0
    if os.path.exists(data_filepath) and not args.force_rerun:
        existing = data_utils.count_existing_samples(data_filepath)
        if existing >= args.num_samples:
            logger.info(f"{data_filepath} already has {existing} samples; done.")
            plan["done"] = True
            return plan
    elif args.force_rerun and os.path.exists(data_filepath):
        os.remove(data_filepath)
        if os.path.exists(meta_path):
            os.remove(meta_path)
    existing = max(existing, data_utils.count_existing_samples(data_filepath))
    plan["existing"] = existing
    if existing >= args.num_samples:
        data_utils.merge_parts(data_filepath)
        plan["done"] = True
        return plan

    # the sidecar pins the transform of a resumable run; parts of one
    # dataset never mix transforms silently. Writes wait until every
    # validation has passed.
    if existing > 0 and os.path.exists(meta_path):
        meta = _read_meta(meta_path)
        rec_impl = meta.get("fft_impl")
        rec_prec = meta.get("mxu_precision")
        if rec_impl and rec_impl != fft_impl:
            if fft_impl_explicit:
                logger.warning(
                    f"resuming {data_filepath} with --fft-impl {fft_impl} "
                    f"but existing samples were generated with {rec_impl}; "
                    "the dataset will mix transform implementations"
                )
                plan["sidecar_needs_repin"] = True
            elif not impl_compatible(rec_impl):
                logger.warning(
                    f"resume: recorded fft_impl={rec_impl} is incompatible "
                    "with this run's integrator/precision/dealias settings; "
                    f"continuing with {fft_impl} — the dataset will mix "
                    "transform implementations"
                )
                plan["sidecar_needs_repin"] = True
            else:
                logger.info(
                    f"resume: adopting recorded fft_impl={rec_impl} "
                    f"(current default would be {fft_impl})"
                )
                plan["fft_impl"] = rec_impl
                if rec_prec:
                    plan["mxu_precision"] = rec_prec
    return plan


def run_generation(
    args,
    make_initial_vorticity,
    forcing_fn=None,
    solver=None,
    logger=None,
    example_name: str = "ns2d",
):
    """Shared batch-generation driver (resume-aware, incremental saves).

    ``make_initial_vorticity(sample_ids, grid, dtype, device)`` returns the
    ``(b, n, n)`` initial vorticity of those samples.

    With ``--data-parallel`` it runs on every rank of the process group
    (``parallel.launch``): each rank rolls out its ``np.array_split`` share
    of a batch's samples (a rank may hold none and still joins every
    collective), and rank 0 alone reads and writes files: it counts the
    resume point, writes the sidecar, gathers the records into the parts and
    merges them. Each sample's IC comes from its own generator, so the
    stored dataset does not depend on the world size, and the transform is
    the one the whole batch would take without the flag.
    """
    if args.boundary != "periodic":
        raise NotImplementedError(
            f"--boundary {args.boundary}: spectral data generation is periodic-only"
        )
    device = resolve_device("cpu" if args.no_cuda else None)
    mesh = parallel.make_mesh() if args.data_parallel else None
    root = mesh is None or dist.get_rank() == 0
    if mesh is not None and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    n = args.grid_size
    subsample = args.subsample
    ns = n // subsample
    diam = data_utils.parse_diam(args.diam)
    visc = args.visc if args.Re is None else 1.0 / args.Re
    T, T_warmup, dt = args.time, args.time_warmup, args.dt
    record_steps = args.num_steps
    warmup_steps = int(T_warmup / dt)
    total_steps = int((T - T_warmup) / dt)
    record_every = max(1, total_steps // record_steps)
    save_dtype = np.float64 if args.double else np.float32
    compute_dtype = torch.float64 if args.double else torch.float32

    filepath = args.filepath or data_utils.DATA_PATH
    if root:
        os.makedirs(filepath, exist_ok=True)
    if args.filename is None:
        extra = "_extra" if args.extra_vars else ""
        dtype_str = "_fp64" if args.double else ""
        res = f"{n}to{ns}" if subsample > 1 else f"{ns}x{ns}"
        args.filename = (
            f"{example_name}{extra}{dtype_str}_{res}_N{args.num_samples}"
            f"_v{visc:.0e}_T{int(T)}_steps{record_steps}.npz"
        ).replace("e-0", "e-")
    data_filepath = os.path.join(filepath, args.filename)
    meta_path = data_filepath + ".meta.json"

    if root:
        logger = logger or data_utils.get_logger()
        logger.info(" | ".join(f"{k}={v}" for k, v in vars(args).items()))
    else:  # warnings and errors only
        logger = logging.getLogger(f"tpu_cfd_torch.datagen.rank{dist.get_rank()}")

    grid = grids.Grid((n, n), domain=((0, diam), (0, diam)))
    fft_impl = getattr(args, "fft_impl", None)
    fft_impl_explicit = fft_impl is not None
    refusal = equations.fused_refusal(solver, compute_dtype, not args.no_dealias)
    if fft_impl is None:
        fft_impl = default_fft_impl(n, args.batch_size, args.double,
                                    not args.no_dealias, refusal is None)
    elif fft_impl.endswith("_fused") and refusal:
        raise ValueError(f"--fft-impl {fft_impl} cannot step this run: {refusal}")
    impl_compatible = functools.partial(_impl_runs, solver=solver, dtype=compute_dtype,
                                        dealias=not args.no_dealias)
    plan = (_resume_plan(args, data_filepath, meta_path, fft_impl, fft_impl_explicit,
                         impl_compatible, logger) if root else None)
    if mesh is not None:
        box = [plan]
        dist.broadcast_object_list(box, src=0)
        plan = box[0]
    if plan["done"]:
        return data_filepath
    existing, fft_impl = plan["existing"], plan["fft_impl"]
    mxu_precision = plan["mxu_precision"]
    fused = fft_impl.endswith("_fused")
    ns2d = NavierStokes2DSpectral(
        viscosity=visc,
        grid=grid,
        drag=args.gamma,
        smooth=not args.no_dealias,
        forcing_fn=forcing_fn,
        solver=solver or RK4CrankNicolsonStepper(),
        dtype=compute_dtype,
        fft_impl=fft_impl.removesuffix("_fused"),
        mxu_precision=mxu_precision,
        fused=fused,
        device=device,
    )
    fields = (
        ("vorticity", "stream", "vort_t", "residual")
        if args.extra_vars
        else ("vorticity",)
    )
    pipeline = make_batch_pipeline(
        ns2d, dt, warmup_steps, total_steps, record_every, ns, fields=fields,
        max_steps_per_program=args.max_steps_per_program,
    )

    meta_now = {
        "fft_impl": fft_impl, "mxu_precision": mxu_precision,
        "dt": dt, "visc": visc, "seed": args.seed,
        "double": bool(args.double), "dealias": not args.no_dealias,
    }
    if root and existing == 0:
        _write_meta(meta_path, meta_now)
    elif root and plan["sidecar_needs_repin"]:
        _repin_meta(meta_path, fft_impl, record_mix=True, base=meta_now)

    batch_size = args.batch_size
    todo = args.num_samples - existing
    num_batches = math.ceil(todo / batch_size)
    world = "" if mesh is None else f" over {dist.get_world_size()} rank(s)"
    logger.info(
        f"Generating {todo} samples in {num_batches} batches "
        f"(resuming from {existing}) on {device}{world} -> {data_filepath}"
    )

    for b in range(num_batches):
        idx0 = existing + b * batch_size
        sample_ids = np.arange(idx0, min(idx0 + batch_size, args.num_samples))
        logger.info(
            f"batch [{b + 1}/{num_batches}] samples {sample_ids[0]}..{sample_ids[-1]}"
        )
        mine = sample_ids if mesh is None else parallel.shard_batch(sample_ids, mesh)
        result = None
        if len(mine):
            vort_init = make_initial_vorticity(mine, grid, compute_dtype, device)
            result = pipeline(torch.fft.rfft2(vort_init))
            result = {k: np.asarray(v, dtype=save_dtype) for k, v in result.items()}
        finite = result is None or bool(np.isfinite(result["vorticity"]).all())
        if mesh is not None:
            finite = parallel.all_ranks(finite, mesh)
            result = parallel.gather_batch(result, mesh)
        if not finite:
            raise FloatingPointError(
                f"trajectory diverged in batch {b} (samples {sample_ids[0]}..)"
            )
        if not root:
            continue
        w = result["vorticity"]
        vort_norm = np.linalg.norm(w[:, -1], axis=(-2, -1)).mean() / ns
        logger.info(
            f"  final-snapshot vorticity ell2 {vort_norm:.4e} | shapes {w.shape}"
        )

        if not args.extra_vars:
            for key in ("vort_t", "stream", "residual"):
                result[key] = np.empty((len(sample_ids), 0), dtype=save_dtype)
        result["random_states"] = np.asarray(sample_ids, dtype=np.int32)
        data_utils.save_part(result, data_filepath)

    if root:
        data_utils.merge_parts(data_filepath)
        logger.info(f"Done: {data_filepath}")
    if mesh is not None:
        dist.barrier()  # every rank returns once the merged file exists
    if root and args.demo_plots:
        try:
            out = data_utils.verify_trajectories(
                data_filepath, dt=record_every * dt, T_warmup=T_warmup,
                n_samples=1,
            )
            logger.info(f"verification plot: {out}")
        except Exception as e:  # plotting must never kill a finished run
            logger.error(f"Error in plotting: {e}")
    return data_filepath


# each dataset CLI's description and the defaults it sets over get_args_ns2d's
_EXAMPLES = {
    "mcwilliams": ("Generate NSE 2d decaying turbulence with McWilliams initial vorticity",
                   dict(time=10.0, time_warmup=4.5, dt=1e-3, num_steps=100,
                        diam=2 * math.pi, forcing="none")),
    "kolmogorov": ("Generate NSE 2d Kolmogorov flow",
                   dict(time=10.0, time_warmup=4.5, dt=1e-3, num_steps=100,
                        diam=2 * math.pi, gamma=0.1, max_velocity=5.0)),
    "fno": ("Generate the original FNO data for NSE in 2D",
            dict(time=50.0, time_warmup=30.0, dt=1e-3, num_steps=100, diam=1.0,
                 scale=0.1, alpha=2.5, tau=7.0, peak_wavenumber=1)),
}


def get_parser(example: str):
    """The argument parser of the ``example`` dataset CLI (``mcwilliams``,
    ``kolmogorov`` or ``fno``)."""
    description, defaults = _EXAMPLES[example]
    parser = data_utils.get_args_ns2d(description)
    parser.set_defaults(**defaults)
    return parser


def main_mcwilliams(argv=None):
    """Decaying isotropic turbulence, McWilliams-1984 initial condition."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = get_parser("mcwilliams").parse_args(argv)
    if args.data_parallel and not dist.is_initialized():
        return parallel.launch(main_mcwilliams, argv, cuda=not args.no_cuda)

    def make_ic(sample_ids, grid, dtype, device):
        noise = torch.stack([
            torch.randn(grid.shape, dtype=dtype, device=device,
                        generator=ic.sample_generator(args.seed, i, device))
            for i in sample_ids
        ])
        return ic.vorticity_field(grid, args.peak_wavenumber, dtype=dtype,
                                  noise=noise).data

    return run_generation(
        args, make_ic, forcing_fn=None, example_name="McWilliams2d",
    )


def main_kolmogorov(argv=None):
    """Forced Kolmogorov flow with a drag of 0.1."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = get_parser("kolmogorov").parse_args(argv)
    if args.data_parallel and not dist.is_initialized():
        return parallel.launch(main_kolmogorov, argv, cuda=not args.no_cuda)
    diam = data_utils.parse_diam(args.diam)
    n = args.grid_size
    grid = grids.Grid((n, n), domain=((0, diam), (0, diam)))
    forcing = forcings.KolmogorovForcing(
        grid=grid, scale=args.scale, wave_number=args.peak_wavenumber,
        diam=diam, vorticity=False,
    )

    def make_ic(sample_ids, grid, dtype, device):
        # the curl of a filtered divergence-free velocity, at the corners
        # (offset (1, 1)) as the JAX package takes it
        noise = torch.stack([
            torch.randn((grid.ndim, *grid.shape), dtype=dtype, device=device,
                        generator=ic.sample_generator(args.seed, i, device))
            for i in sample_ids
        ])
        v = ic.filtered_velocity_field(
            grid, maximum_velocity=args.max_velocity,
            peak_wavenumber=args.peak_wavenumber, dtype=dtype, noise=noise)
        return fdm.curl_2d(v).data

    return run_generation(
        args, make_ic, forcing_fn=forcing, example_name="Kolmogorov2d",
    )


def fno_objects(args):
    """The FNO paper's dataset at the ``fno`` CLI's ``args``: the initial
    vorticity a sample at a time (a GRF drawn from each sample's generator),
    the SinCos forcing and the IMEX order-2 stepper, as ``(make_ic,
    forcing, solver)`` for ``run_generation``."""
    diam = data_utils.parse_diam(args.diam)
    n = args.grid_size
    grid = grids.Grid((n, n), domain=((0, diam), (0, diam)))
    forcing = forcings.SinCosForcing(
        grid=grid, scale=args.scale, diam=diam,
        wave_number=args.peak_wavenumber, vorticity=True,
    )
    grf = GRF2d(n=n, alpha=args.alpha, tau=args.tau, normalize=args.normalize,
                smoothing=args.replicable_init,
                dtype=torch.float64 if args.double else torch.float32)

    def make_ic(sample_ids, grid, dtype, device):
        del dtype  # the sampler above is built at the compute dtype
        return torch.cat([
            grf.sample(ic.sample_generator(args.seed, i, device), bsz=1, n=n)
            for i in sample_ids
        ])

    return make_ic, forcing, IMEXStepper(order=2)


def main_fno(argv=None):
    """The FNO paper's dataset: GRF initial vorticity, SinCos forcing, IMEX
    order 2 (``fno_objects``)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = get_parser("fno").parse_args(argv)
    if args.data_parallel and not dist.is_initialized():
        return parallel.launch(main_fno, argv, cuda=not args.no_cuda)
    make_ic, forcing, solver = fno_objects(args)
    return run_generation(args, make_ic, forcing_fn=forcing, solver=solver,
                          example_name="fnodata")


_MAINS = {
    "mcwilliams": main_mcwilliams,
    "kolmogorov": main_kolmogorov,
    "fno": main_fno,
}


def main():
    if len(sys.argv) < 2 or sys.argv[1] not in _MAINS:
        print(f"usage: python -m tpu_cfd_torch.data.generate {{{'|'.join(_MAINS)}}} [flags]")
        raise SystemExit(2)
    return _MAINS[sys.argv[1]](sys.argv[2:])


if __name__ == "__main__":
    main()

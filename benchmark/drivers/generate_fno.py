"""The FNO dataset's generation through the port's per-batch path.

As the ``fno`` dataset CLI runs a batch (``data/generate.py``: ``main_fno``,
``run_generation``), without its npz writes: the CLI's arguments at this
configuration, the objects ``fno_objects`` builds from them for ``main_fno``
(the GRF initial condition drawn a sample at a time from ``(seed, sample
id)``, the SinCos forcing, IMEX order 2), the solver on the route
``default_fft_impl`` picks without the fused kernel, the recorder
``generate.make_batch_pipeline`` with the configuration's fields, and the
finite check of the vorticity records. A unit is one batch.

Traced, ``bench.solver`` covers each solver call, ``bench.explicit`` each
evaluation of the explicit terms and ``bench.ic`` a batch's initial
conditions.

Correctness: after the window, a batch drawn from the seed is run again by
the plain reference (``reference/fno_forced.py``) from the same draws, in
blocks, and each sample's records of each field are compared by their
relative L2 distance; the residual's distance is taken relative to the norm
of the time derivative (``compare``). The whole batch is checked: a fault
may alter a single sample.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchmark import inputs
from benchmark.reference import fno_forced as ref

DTYPES = {"float32": torch.float32, "float64": torch.float64}


class Driver:
    def __init__(self, cell: dict, config: dict, seed: int, device, ranges):
        t0 = time.perf_counter()
        from tpu_cfd_torch import grids
        from tpu_cfd_torch.data import generate
        from tpu_cfd_torch.solvers.equations import NavierStokes2DSpectral

        self.setup_phases = {"import": time.perf_counter() - t0}
        self.cell, self.cfg, self.seed, self.device = cell, config, seed, device
        self.ranges = ranges
        self.batch = cell["batch"]
        self.dtype = DTYPES[cell["precision"]]
        self.fields = tuple(config["fields"])
        n, diam = config["grid_size"], config["domain"]
        self.n, self.ns = n, n // config["subsample"]
        # the CLI's arguments at this configuration, and its objects
        argv = ["--grid-size", str(n), "--subsample", str(config["subsample"]),
                "--diam", repr(diam), "--visc", repr(config["viscosity"]),
                "--gamma", repr(config["drag"]), "--dt", repr(config["dt"]),
                "--alpha", repr(config["alpha"]), "--tau", repr(config["tau"]),
                "--scale", repr(config["forcing_scale"]),
                "--peak-wavenumber", str(config["forcing_wave_number"]),
                "--batch-size", str(self.batch), "--seed", str(seed)]
        if self.dtype == torch.float64:
            argv.append("--double")
        self.args = generate.get_parser("fno").parse_args(argv)
        self._make_ic, forcing, solver = generate.fno_objects(self.args)
        self.grid = grids.Grid((n, n), domain=((0, diam), (0, diam)))
        fft_impl = generate.default_fft_impl(n, self.batch, self.dtype == torch.float64,
                                             True, fused_ok=False)
        self.route = fft_impl
        self.ns2d = NavierStokes2DSpectral(
            viscosity=self.args.visc, grid=self.grid, drag=self.args.gamma, smooth=True,
            forcing_fn=forcing, solver=solver, dtype=self.dtype, fft_impl=fft_impl,
            mxu_precision=self.args.mxu_precision, fused=False, device=device)
        ranges.wrap_method(self.ns2d, "forward", "bench.solver",
                           count=lambda w, dt, steps=1: steps * math.prod(w.shape[:-2]))
        ranges.wrap_method(self.ns2d, "explicit_terms", "bench.explicit")
        every = config["record_every"]
        self.records = -(-config["recorded_steps"] // every)
        self.pipeline = generate.make_batch_pipeline(
            self.ns2d, self.args.dt, config["warmup_steps"], config["recorded_steps"],
            every, self.ns, fields=self.fields,
            max_steps_per_program=self.args.max_steps_per_program)
        self.steps_per_sample = ref.solver_steps(config)
        self.done = {}
        self.next_batch = 0
        self.counters = {"units": 0, "attempted": 0, "failed": 0, "sample_steps": 0}
        # the warm-up: every shape of a batch (the IC, the solver's calls,
        # the extra fields, the recorder's inverse transforms and subsample)
        # on one step a call, from batch 0's initial conditions
        warm = generate.make_batch_pipeline(self.ns2d, self.args.dt, 1, self.records, 1,
                                            self.ns, fields=self.fields)
        self.setup_phases["build"] = time.perf_counter() - t0
        self._run(0, warm)
        self.setup_phases["warm"] = time.perf_counter() - t0

    def _ids(self, b: int) -> np.ndarray:
        return np.arange(b * self.batch, (b + 1) * self.batch)

    def _run(self, b: int, pipeline) -> dict:
        with self.ranges.range("bench.ic"):
            w0 = self._make_ic(self._ids(b), self.grid, self.dtype, self.device)
        return pipeline(torch.fft.rfft2(w0))

    def unit(self) -> None:
        b = self.next_batch
        rec = self._run(b, self.pipeline)
        self.next_batch += 1
        self.counters["units"] += 1
        self.counters["attempted"] += 1
        if not np.isfinite(rec["vorticity"]).all():
            self.counters["failed"] += 1
        self.counters["sample_steps"] += self.batch * self.steps_per_sample
        self.done[b] = rec

    def end_to_end(self, window_s: float, peak_bytes: int) -> dict:
        return {"sample_steps_per_s": self.counters["sample_steps"] / window_s}

    def release(self) -> None:
        self.ns2d = self.pipeline = None

    def _checked(self):
        """The batch the check takes, drawn from the seed, or None before
        any batch."""
        done = sorted(self.done)
        if not done:
            return None
        return int(np.random.default_rng(inputs.stream_seed(self.seed, 4)).choice(done))

    def _reference(self, b: int, tf32: bool = False):
        """The reference's records of batch ``b``, in blocks of
        ``check_block`` samples; yields ``(block's samples, records)``."""
        block = self.cell["check_block"]
        for lo in range(0, self.batch, block):
            part = slice(lo, min(lo + block, self.batch))
            noise = ref.white_noise(self.seed, self._ids(b)[part], self.n, self.dtype,
                                    self.device)
            if self.dtype == torch.float64 and tf32:
                want = {k: v.double() for k, v in ref.records(noise.float(), self.cfg).items()}
            else:
                want = ref.records(noise, self.cfg, tf32=tf32)
            yield part, {k: v.cpu() for k, v in want.items()}

    def use_control(self) -> None:
        """The control in the program's place: the checked batch's records
        as the reference computes them one precision below the cell's (fp32
        for fp64, TF32 operands for fp32)."""
        b = self._checked()
        if b is None:
            return
        for part, want in self._reference(b, tf32=True):
            for k in self.fields:
                self.done[b][k][part] = want[k].numpy()

    def compare(self) -> dict:
        """Each field's largest relative L2 distance, over the samples of the
        checked batch, of a sample's records from the reference's. The
        residual's distance is taken relative to the norm of the reference's
        time derivative: the residual is the small difference of the time
        derivative and the terms of the equation, so its own norm would make
        the check read the rounding of that cancellation."""
        names = [f"{k}_rel_l2" for k in self.fields]
        b = self._checked()
        if b is None:
            return dict.fromkeys(names, math.inf)
        worst = dict.fromkeys(names, 0.0)
        for part, want in self._reference(b):
            for k in self.fields:
                got = torch.as_tensor(self.done[b][k][part]).double()
                w = want[k].double()
                if got.shape != w.shape:
                    return dict.fromkeys(names, math.inf)
                scale = want["vort_t" if k == "residual" else k].double()
                rel = (got - w).flatten(1).norm(dim=1) / scale.flatten(1).norm(dim=1)
                rel = float(torch.nan_to_num(rel, nan=math.inf).max())
                worst[f"{k}_rel_l2"] = max(worst[f"{k}_rel_l2"], rel)
        return worst

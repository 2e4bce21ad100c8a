"""Dataset generation through the port's per-batch path.

As the ``mcwilliams`` dataset CLI runs a batch (``data/generate.py``,
``run_generation``), without its npz writes: noise from the seed, the
McWilliams IC (``initial_conditions.vorticity_field``), ``torch.fft.rfft2``,
``generate.make_batch_pipeline`` on the route ``default_fft_impl`` picks
for the grid and batch, and the finite check. A unit is one batch.

Correctness: after the window, batches drawn from the seed are run again by
the plain reference (``reference/mcwilliams.py``) from the same noise, and
each sample's records are compared by their relative L2 distance.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchmark import inputs
from benchmark.reference import mcwilliams as ref

DTYPES = {"float32": torch.float32, "float64": torch.float64}


class Driver:
    def __init__(self, cell: dict, config: dict, seed: int, device, ranges):
        t0 = time.perf_counter()
        from tpu_cfd_torch import grids
        from tpu_cfd_torch.data import generate
        from tpu_cfd_torch.solvers import initial_conditions as ic
        from tpu_cfd_torch.solvers.equations import (NavierStokes2DSpectral,
                                                     RK4CrankNicolsonStepper)

        self.setup_phases = {"import": time.perf_counter() - t0}
        self.cell, self.cfg, self.seed, self.device = cell, config, seed, device
        self.ranges = ranges
        self.batch = cell["batch"]
        self.dtype = DTYPES[cell["precision"]]
        n, diam = config["grid_size"], config["domain"]
        self.n, self.ns = n, n // config["subsample"]
        self.grid = grids.Grid((n, n), domain=((0, diam), (0, diam)))
        self._ic = ic.vorticity_field
        fft_impl = generate.default_fft_impl(n, self.batch, self.dtype == torch.float64,
                                             True, True)
        fused = fft_impl.endswith("_fused")
        self.route = fft_impl
        self.ns2d = NavierStokes2DSpectral(
            viscosity=config["viscosity"], grid=self.grid, drag=config.get("drag", 0.0),
            smooth=True, forcing_fn=None, solver=RK4CrankNicolsonStepper(),
            dtype=self.dtype, fft_impl=fft_impl[: -len("_fused")] if fused else fft_impl,
            mxu_precision="high", fused=fused, device=device)
        ranges.wrap_method(self.ns2d, "forward", "bench.solver",
                           count=lambda w, dt, steps=1: steps * math.prod(w.shape[:-2]))
        every = config["record_every"]
        self.records = -(-config["recorded_steps"] // every)
        self.pipeline = generate.make_batch_pipeline(
            self.ns2d, config["dt"], config["warmup_steps"], config["recorded_steps"],
            every, self.ns, fields=("vorticity",))
        self.steps_per_sample = ref.solver_steps(config)
        self.done = {}
        self.next_batch = 0
        self.counters = {"units": 0, "attempted": 0, "failed": 0, "sample_steps": 0}
        # the warm-up: every shape of a batch (the IC's transforms, the
        # solver's calls, the recorder's inverse transform and subsample) on
        # one step a call
        warm = generate.make_batch_pipeline(self.ns2d, config["dt"], 1, self.records,
                                            1, self.ns, fields=("vorticity",))
        self.setup_phases["build"] = time.perf_counter() - t0
        self._run(-1, warm)
        self.setup_phases["warm"] = time.perf_counter() - t0

    def _run(self, b: int, pipeline):
        noise = inputs.batch_noise(self.seed, b, (self.batch, self.n, self.n),
                                   self.dtype, self.device)
        with self.ranges.range("bench.ic"):
            w0 = self._ic(self.grid, self.cfg["peak_wavenumber"], dtype=self.dtype,
                          noise=noise).data
        rec = pipeline(torch.fft.rfft2(w0))["vorticity"]
        return rec

    def unit(self) -> None:
        b = self.next_batch
        rec = self._run(b, self.pipeline)
        self.next_batch += 1
        self.counters["units"] += 1
        self.counters["attempted"] += 1
        if not np.isfinite(rec).all():
            self.counters["failed"] += 1
        self.counters["sample_steps"] += self.batch * self.steps_per_sample
        self.done[b] = rec

    def end_to_end(self, window_s: float, peak_bytes: int) -> dict:
        return {"sample_steps_per_s": self.counters["sample_steps"] / window_s}

    def release(self) -> None:
        self.ns2d = self.pipeline = None

    def use_control(self) -> None:
        """The control in the program's place: each finished batch's records
        as the reference computes them one precision below the cell's (fp32
        for fp64, TF32 operands for fp32)."""
        for b in self.done:
            noise = inputs.batch_noise(self.seed, b, (self.batch, self.n, self.n),
                                       self.dtype, self.device)
            if self.dtype == torch.float64:
                rec = ref.records(noise.float(), self.cfg).double()
            else:
                rec = ref.records(noise, self.cfg, tf32=True)
            self.done[b] = rec.cpu().numpy()

    def compare(self) -> dict:
        """Batches drawn from the seed, every sample's records against the
        reference's: the largest relative L2 distance over a sample's
        records."""
        rng = np.random.default_rng(inputs.stream_seed(self.seed, 4))
        done = sorted(self.done)
        take = min(self.cell["check_batches"], len(done))
        worst = math.inf if not done else 0.0
        for b in rng.choice(done, size=take, replace=False) if take else []:
            noise = inputs.batch_noise(self.seed, int(b), (self.batch, self.n, self.n),
                                       self.dtype, self.device)
            want = ref.records(noise, self.cfg).cpu().double()
            got = torch.as_tensor(self.done[int(b)]).double()
            if got.shape != want.shape:
                return {"records_rel_l2": math.inf}
            rel = (got - want).flatten(1).norm(dim=1) / want.flatten(1).norm(dim=1)
            worst = max(worst, float(torch.nan_to_num(rel, nan=math.inf).max()))
        return {"records_rel_l2": worst}


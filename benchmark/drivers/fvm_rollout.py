"""The Kolmogorov FVM example's rollout, a batch an ensemble of samples.

As ``tpu_cfd_torch/examples/ex1_kolmogorov_fvm.py`` runs it: the equation
and time step of ``build``, each batch's initial velocity by
``initial_velocity`` from white noise drawn on the device from ``(seed,
batch id)``, and ``fvm.rollout`` (classic RK4 with a projection after each
stage, the finite-difference vorticity every ``inner_steps`` steps); then
the frames' finite check and their copy to the host, into one of two
page-locked buffers made at set-up, as a generator reuses its output
buffers: the one the checked batch keeps, or the one the other batches
share. Beside an NVIDIA H100 80GB HBM3, a copy into fresh pageable memory
took 79–138 ms of a 4.3 s batch, by how the first touch of its pages went;
into a page-locked buffer 4 ms. A unit is one batch.

Traced, ``bench.solver`` covers each solver step, ``bench.explicit`` each
evaluation of the explicit terms and ``bench.ic`` a batch's initial
velocity.

Correctness: the checked batch is drawn from the seed at set-up, one of
the first ``CHECKABLE`` (the window's last batch where it ends before that
one). After the window it is rolled out again by the plain reference
(``reference/kolmogorov_fvm.py``) from the same noise, in blocks, and each
sample's frames are compared by their relative L2 distance; the program's
final velocity is held to be divergence-free by the reference's own
divergence (``compare``). The whole batch is checked: a fault may alter a
single sample.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchmark import inputs
from benchmark.reference import kolmogorov_fvm as ref

DTYPES = {"float32": torch.float32, "float64": torch.float64}
# batches among which the check is drawn: a 10 s window at 512 samples runs 3
CHECKABLE = 3


def _check_constants(example, config: dict) -> None:
    """The configuration states the example's own constants."""
    stated = {"viscosity": example.VISCOSITY, "density": example.DENSITY,
              "max_velocity": example.MAX_VELOCITY, "peak_wavenumber": example.PEAK_WAVENUMBER,
              "forcing_wave_number": example.PEAK_WAVENUMBER, "drag": example.DRAG,
              "domain_length": 2 * math.pi}
    wrong = {k: (config[k], v) for k, v in stated.items() if config[k] != v}
    if wrong:
        raise ValueError(f"configuration and example differ (config, example): {wrong}")


class Driver:
    def __init__(self, cell: dict, config: dict, seed: int, device, ranges):
        t0 = time.perf_counter()
        from tpu_cfd_torch.examples import ex1_kolmogorov_fvm as example
        from tpu_cfd_torch.solvers import fvm

        self.setup_phases = {"import": time.perf_counter() - t0}
        _check_constants(example, config)
        self.example, self.fvm = example, fvm
        self.cell, self.cfg, self.seed, self.device = cell, config, seed, device
        self.ranges = ranges
        self.batch = cell["batch"]
        self.dtype = DTYPES[cell["precision"]]
        self.n = config["grid_size"]
        self.inner_steps, self.frames = config["inner_steps"], config["frames"]
        v0, self.eqn, self.dt = example.build(self.n, self.dtype, device,
                                              noise=self._noise(-1))
        self.grid = v0[0].grid
        self.checked = int(np.random.default_rng(inputs.stream_seed(seed, 4))
                           .integers(CHECKABLE))
        shape = (self.frames, self.batch, self.n, self.n)
        pin = torch.device(device).type == "cuda"
        self.kept, self.shared = (torch.empty(shape, dtype=self.dtype, pin_memory=pin)
                                  for _ in range(2))
        ranges.wrap_method(self.eqn, "forward", "bench.solver",
                           count=lambda v, dt: math.prod(v[0].data.shape[:-2]))
        ranges.wrap_method(self.eqn, "explicit_terms", "bench.explicit")
        self.done = {}
        self.next_batch = 0
        self.counters = {"units": 0, "attempted": 0, "failed": 0, "sample_steps": 0}
        self.setup_phases["build"] = time.perf_counter() - t0
        # the warm-up: every shape of a batch (the IC's transforms above, the
        # step, the curl, the stack of all frames and their copy), one step
        # a frame, from batch -1's initial velocity
        frames, _ = fvm.rollout(v0, self.eqn, self.dt, 1, self.frames)
        self.shared.copy_(frames)
        self.setup_phases["warm"] = time.perf_counter() - t0

    def _noise(self, b: int) -> torch.Tensor:
        return inputs.batch_noise(self.seed, b, (self.batch, 2, self.n, self.n), self.dtype,
                                  self.device)

    def unit(self) -> None:
        b = self.next_batch
        with self.ranges.range("bench.ic"):
            v0 = self.example.initial_velocity(self.grid, self._noise(b), self.dtype,
                                               self.device)
        frames, v = self.fvm.rollout(v0, self.eqn, self.dt, self.inner_steps, self.frames)
        finite = torch.isfinite(frames).all()
        host = self.kept if b == self.checked else self.shared
        host.copy_(frames)
        self.next_batch += 1
        self.counters["units"] += 1
        self.counters["attempted"] += 1
        if not bool(finite):
            self.counters["failed"] += 1
        self.counters["sample_steps"] += self.batch * self.inner_steps * self.frames
        # the checked batch and the latest, their final velocity on the device
        self.done = {k: d for k, d in self.done.items() if k == self.checked}
        self.done[b] = (host, tuple(u.data for u in v))

    def end_to_end(self, window_s: float, peak_bytes: int) -> dict:
        return {"sample_steps_per_s": self.counters["sample_steps"] / window_s}

    def release(self) -> None:
        self.eqn = None

    def _checked(self):
        """The batch the check takes, or None before any batch."""
        if not self.done:
            return None
        return self.checked if self.checked in self.done else max(self.done)

    def _reference(self, b: int, dtype):
        """The reference's frames and final velocity of batch ``b`` in
        ``dtype`` from the batch's noise, in blocks of ``check_block``
        samples; yields ``(block's samples, frames, (u, v))`` in float64."""
        noise = self._noise(b)
        block = self.cell["check_block"]
        for lo in range(0, self.batch, block):
            part = slice(lo, min(lo + block, self.batch))
            frames, vel = ref.records(noise[part].to(dtype), self.cfg)
            yield part, frames.double().cpu(), tuple(c.double() for c in vel)

    def use_control(self) -> None:
        """The control in the program's place: the checked batch's frames
        and final velocity as the reference computes them one precision
        below the cell's (fp32 for fp64)."""
        b = self._checked()
        if b is None:
            return
        frames, vel = self.done[b]
        frames, vel = frames.clone(), tuple(c.clone() for c in vel)
        for part, want, want_vel in self._reference(b, torch.float32):
            frames[:, part] = want.to(frames.dtype)
            for c, w in zip(vel, want_vel):
                c[part] = w.to(c.dtype)
        self.done[b] = (frames, vel)

    def compare(self) -> dict:
        """The largest relative L2 distance, over the samples of the checked
        batch, of a sample's frames from the reference's (all its frames
        together), and the largest |divergence| of the program's final
        velocity (in 1/time units), by the reference's backward
        differences in float64."""
        names = ("frames_rel_l2", "max_divergence")
        b = self._checked()
        if b is None:
            return dict.fromkeys(names, math.inf)
        got, vel = self.done[b]
        worst = 0.0
        for part, want, _ in self._reference(b, self.dtype):
            g = got[:, part].double()
            if g.shape != want.shape:
                return dict.fromkeys(names, math.inf)
            diff = (g - want).transpose(0, 1).flatten(1).norm(dim=1)
            rel = diff / want.transpose(0, 1).flatten(1).norm(dim=1)
            worst = max(worst, float(torch.nan_to_num(rel, nan=math.inf).max()))
        h = self.cfg["domain_length"] / self.n
        div = ref.divergence(vel[0].double(), vel[1].double(), h).abs().max()
        return {"frames_rel_l2": worst,
                "max_divergence": float(torch.nan_to_num(div, nan=math.inf))}

"""Spectral-Refiner's fine-tune on the FNO data, a batch of trajectories
refined together.

As ``tpu_cfd_torch/examples/ex2_sfno_finetune.py --example fno`` runs it,
on a batch and not one sample: the example's SFNO (``build_sfno``) with
weights the benchmark draws from the seed, the zero-shot pass tapping the
reduced latent ``r`` (``zero_shot``), a fresh enlarged output conv with the
trained corners transplanted in (``build_outconv``), the SinCos forcing
(``make_forcing``), the H^-1 residual norm (``residual_norm``) and the
two-group Adam refine keeping the best iterate
(``finetune.finetune_steps`` at ``LR_WEIGHT`` and the configuration's bias
rate): one conv refined on the batch-mean norm. A
unit is one batch: the zero-shot pass, the refine, and the finite check of
the refined trajectory (the conv's output at the kept iterate) and of the
history. Two batches of input frames are made at set-up and the units
alternate between them.

Each batch's 10 input frames come from the FNO data generator's own
objects (``generate.fno_objects``: the GRF initial vorticity of each
sample from ``(seed, sample id)``, the SinCos forcing, IMEX order 2 on
``torch.fft``) in fp64: ``warmup_steps`` steps, then a frame every
``record_every`` steps.

Traced, ``bench.zero_shot`` covers each zero-shot pass, ``bench.refine``
each refine (its iterations and the keep-best evaluation) and
``bench.post`` each evaluation of the solver post-process
(``OutConvFT.post``, forward only: autograd launches its backward inside
``bench.refine`` but outside ``bench.post``).

Correctness: the checked batch, one of the two drawn from the seed, keeps
its zero-shot prediction, its residual history, its refined trajectory, the
time derivative of its first iteration (kept by the refine's ``track``) and
the size of its parameters' change from the window's last unit on it. The
change is read by hooks that ``torch.optim`` calls around every optimizer
step, registered while a unit runs: the L2 norm of each parameter group's
change, the weights' and the biases', over the refine's first step and over
all its steps (the last iterate's change, before the keep-best copy puts
the best iterate back). After the window the plain reference
(``reference/refiner.py``) runs the zero-shot pass on the same frames and
weights in blocks of ``check_block`` samples, then the whole refine on the
batch, and ``compare`` reads the worst sample's relative L2 distance of the
prediction, of the first time derivative and of the refined trajectory, the
relative gap of the history's entries (the first, the residual before any
update, and the largest) and the ratio of each group's change over the
first step and over the refine.
"""

from __future__ import annotations

import contextlib
import math
import time

import numpy as np
import torch

from benchmark import inputs
from benchmark.reference import refiner as ref
from benchmark.reference import sfno as ref_sfno

DTYPES = {"float32": torch.float32, "float64": torch.float64}
NAMES = ("zero_shot_rel_l2", "first_w_t_rel_l2", "first_residual_gap", "history_gap",
         "first_update_log_gap", "refine_change_log_gap", "refined_rel_l2")


def _check_config(example, model, config: dict) -> None:
    """The configuration states the example's own constants and its SFNO's
    class defaults; the grid, the enlarged conv's modes and the iterations
    are the example's flags (``--res``, ``--modes-ft``, ``--iters``)."""
    stated = {k: v for k, v in example.CONFIGS["fno"].items() if k != "iters"}
    stated.update(delta_ft=example.FT_KWS["delta"], viscosity=example.FT_KWS["visc"],
                  ft_dt=example.FT_KWS["dt"], bdf_weight=list(example.FT_KWS["bdf_weight"]),
                  lr_weight=example.LR_WEIGHT, residual_alpha=example.RESIDUAL_ALPHA,
                  activation=model.activation, delta=model.out_conv.conv.delta,
                  latent_steps=model.lifting.latent_steps, num_layers=len(model.convs) + 1,
                  channel_expansion=model.ffns[0].dense_0.out_features // config["width"])
    wrong = {k: (config.get(k), v) for k, v in stated.items()
             if not (config.get(k) == v or (isinstance(v, float) and isinstance(config.get(k), float)
                                            and math.isclose(config[k], v, rel_tol=1e-15)))}
    if wrong:
        raise ValueError(f"configuration and example differ (config, example): {wrong}")


class Driver:
    def __init__(self, cell: dict, config: dict, seed: int, device, ranges):
        t0 = time.perf_counter()
        from tpu_cfd_torch import grids
        from tpu_cfd_torch.data import generate
        from tpu_cfd_torch.examples import ex2_sfno_finetune as example
        from tpu_cfd_torch.solvers.equations import NavierStokes2DSpectral
        from tpu_cfd_torch.train import finetune

        self.setup_phases = {"import": time.perf_counter() - t0}
        self.example, self.finetune = example, finetune
        self.cell, self.cfg, self.seed, self.device = cell, config, seed, device
        self.ranges = ranges
        self.batch = cell["batch"]
        self.dtype = DTYPES[cell["precision"]]
        self.n, diam = config["grid_size"], config["diam"]

        # the SFNO, with weights drawn from the seed in fp32 (a trained
        # checkpoint's precision) and run in the cell's
        self.model = example.build_sfno(config)
        _check_config(example, self.model, config)
        self.model.load_state_dict(
            inputs.weights(ref_sfno.param_spec(config), seed, "cpu", torch.float32))
        self.model.to(device=device, dtype=self.dtype)
        self.params = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
        self.f = example.make_forcing(config["forcing"], self.n, self.dtype, device)
        self.norm = example.residual_norm(self.n, diam)

        # two batches of input frames, stepped together
        argv = ["--grid-size", str(self.n), "--subsample", "1", "--diam", repr(diam),
                "--visc", repr(config["viscosity"]), "--dt", repr(config["data_dt"]),
                "--alpha", repr(config["ic_alpha"]), "--tau", repr(config["ic_tau"]),
                "--scale", repr(config["forcing_scale"]),
                "--peak-wavenumber", str(config["forcing_wave_number"]),
                "--batch-size", str(2 * self.batch), "--seed", str(seed), "--double"]
        args = generate.get_parser("fno").parse_args(argv)
        make_ic, forcing, solver = generate.fno_objects(args)
        grid = grids.Grid((self.n, self.n), domain=((0, diam), (0, diam)))
        ns2d = NavierStokes2DSpectral(
            viscosity=args.visc, grid=grid, drag=args.gamma, smooth=True, forcing_fn=forcing,
            solver=solver, dtype=torch.float64, fft_impl="fft", fused=False, device=device)
        w_h = torch.fft.rfft2(make_ic(np.arange(2 * self.batch), grid, torch.float64, device))
        w_h, _ = ns2d.forward(w_h, args.dt, steps=config["warmup_steps"])
        frames = [torch.fft.irfft2(w_h, s=(self.n, self.n))]
        for _ in range(config["steps"] - 1):
            w_h, _ = ns2d.forward(w_h, args.dt, steps=config["record_every"])
            frames.append(torch.fft.irfft2(w_h, s=(self.n, self.n)))
        frames = torch.stack(frames, dim=-1).to(self.dtype)
        self.inputs = [frames[:self.batch].contiguous(), frames[self.batch:].contiguous()]
        del frames, w_h, ns2d
        _sync(device)
        self.setup_phases["inputs"] = time.perf_counter() - t0

        self.checked = int(np.random.default_rng(inputs.stream_seed(seed, 4)).integers(2))
        ranges.wrap_method(self, "_zero_shot", "bench.zero_shot")
        ranges.wrap_method(self, "_refine", "bench.refine",
                           count=lambda qft, r, w_in: w_in.shape[0])
        self.done = {}
        self.next_batch = 0
        self.counters = {"units": 0, "attempted": 0, "failed": 0, "sample_iterations": 0,
                         "iterations": 0, "best_copies": 0}
        self.setup_phases["build"] = time.perf_counter() - t0
        # the warm-up: every shape of a unit (the refine's iterations, the
        # keep-best evaluation and the refined trajectory), on batch 0
        self._run(self.inputs[0], iters=1)
        _sync(device)
        self.setup_phases["warm"] = time.perf_counter() - t0

    def _zero_shot(self, w_in):
        return self.example.zero_shot(self.model, w_in, self.cfg["out_steps"])

    def _refine(self, qft, r, w_in):
        return self.finetune.finetune_steps(
            qft, r, w_in, self.f, out_steps=self.cfg["out_steps"], n_steps=self._iters,
            lr=self.example.LR_WEIGHT, lr_bias=self.cfg["lr_bias"], residual_norm=self.norm,
            track=self._track)

    def _track(self, out) -> dict:
        """The refine's ``track``: keeps the first iteration's time
        derivative (the post-process at the conv's initial parameters) and
        adds no metric."""
        if self._first_w_t is None:
            self._first_w_t = out["w_t"].detach()
        return {}

    def _run(self, w_in, iters: int) -> dict:
        """One batch's zero-shot prediction, residual history, refined
        trajectory, first iteration's time derivative, and the size by
        group of its first update and of its whole refine's change."""
        pred, r = self._zero_shot(w_in)
        qft = self.example.build_outconv(self.model, self.cfg, self.cfg["modes_ft"],
                                         self.dtype, self.device)
        self.ranges.wrap_method(qft, "post", "bench.post")
        self._iters, self._first_w_t = iters, None
        with _updates(iters) as change:
            hist = [self.finetune.history_residual(h) for h in self._refine(qft, r, w_in)]
        with torch.no_grad():
            refined = qft(r, w_in, out_steps=self.cfg["out_steps"], original=True)
        run = {"pred": pred, "history": hist, "refined": refined, "first_w_t": self._first_w_t,
               "first_update": change["first"], "change": change["last"]}
        self._first_w_t = None
        return run

    def unit(self) -> None:
        b = self.next_batch % 2
        counts = dict(self.finetune.COUNTS)
        run = self._run(self.inputs[b], self.cfg["iters"])
        finite = bool(torch.isfinite(run["refined"]).all()) and all(
            map(math.isfinite, run["history"]))
        self.next_batch += 1
        c = self.counters
        c["units"] += 1
        c["attempted"] += 1
        c["failed"] += 0 if finite else 1
        c["sample_iterations"] += self.batch * self.cfg["iters"]
        for k in ("iterations", "best_copies"):
            c[k] += self.finetune.COUNTS[k] - counts[k]
        self.done[b] = run

    def end_to_end(self, window_s: float, peak_bytes: int) -> dict:
        return {"train_samples_per_s": self.counters["sample_iterations"] / window_s,
                "train_peak_gib": peak_bytes / 2 ** 30}

    def release(self) -> None:
        self.model = None

    def _checked(self):
        """The batch the check takes, or None before any unit."""
        if not self.done:
            return None
        return self.checked if self.checked in self.done else max(self.done)

    def _reference(self, b: int, dtype) -> dict:
        """The reference's run of batch ``b`` computed in ``dtype``, as
        ``_run`` returns the program's, the tensors in float64."""
        x = self.inputs[b].to(dtype)
        p = {k: v.to(dtype) for k, v in self.params.items()}
        block = self.cell["check_block"]
        with ref.no_tf32(), torch.no_grad():
            parts = [ref.zero_shot(p, x[lo: lo + block], self.cfg)
                     for lo in range(0, self.batch, block)]
        pred = torch.cat([q for q, _ in parts])
        r = torch.cat([latent for _, latent in parts])
        run = ref.refine(ref.initial_ft_params(p, self.cfg), r, x, self.cfg)
        return {"pred": pred.double(), "history": run["history"],
                "refined": run["refined"].double(), "first_w_t": run["first_w_t"].double(),
                "first_update": run["first_update"], "change": run["change"]}

    def use_control(self) -> None:
        """The control in the program's place: the checked batch's results
        as the reference computes them one precision below the cell's (fp32
        for fp64)."""
        b = self._checked()
        if b is not None:
            self.done[b] = self._reference(b, torch.float32)

    def compare(self) -> dict:
        """Against the reference in the cell's precision, on the checked
        batch: the worst sample's relative L2 distance of the zero-shot
        prediction (``zero_shot_rel_l2``), of the first iteration's time
        derivative (``first_w_t_rel_l2``: the post-process at the conv's
        initial parameters, before any update) and of the refined trajectory
        (``refined_rel_l2``); the relative gap of the residual history's
        first entry, the residual before any update
        (``first_residual_gap``), and the largest over its entries
        (``history_gap``); the larger of the two groups' ``|ln(program /
        reference)|`` of the first update's size (``first_update_log_gap``)
        and of the whole refine's change (``refine_change_log_gap``): ratios,
        since the gradient at the rounding floor differs between two
        computations of it by tens of percent, and a learning rate off by a
        factor, or an optimizer that stops, moves a change by a factor."""
        b = self._checked()
        if b is None:
            return dict.fromkeys(NAMES, math.inf)
        got, want = self.done[b], self._reference(b, self.dtype)
        if any(got[k] is None or got[k].shape != want[k].shape
               for k in ("pred", "refined", "first_w_t")) \
                or len(got["history"]) != len(want["history"]) \
                or got["first_update"] is None or got["change"] is None:
            return dict.fromkeys(NAMES, math.inf)
        gaps = [_gap(h, w) for h, w in zip(got["history"], want["history"])]
        return {"zero_shot_rel_l2": _worst_rel(got["pred"], want["pred"]),
                "first_w_t_rel_l2": _worst_rel(got["first_w_t"], want["first_w_t"]),
                "first_residual_gap": gaps[0], "history_gap": max(gaps),
                "first_update_log_gap": _worst_log_gap(got["first_update"],
                                                       want["first_update"]),
                "refine_change_log_gap": _worst_log_gap(got["change"], want["change"]),
                "refined_rel_l2": _worst_rel(got["refined"], want["refined"])}


@contextlib.contextmanager
def _updates(steps: int):
    """While open, each parameter group's change as the L2 norm over the
    group's parameters, over the first optimizer step and over the first
    ``steps``: yields a dict whose ``"first"`` and ``"last"`` are then the
    lists of them, 0-d tensors on the parameters' device (None before the
    step)."""
    from torch.optim.optimizer import (register_optimizer_step_post_hook,
                                       register_optimizer_step_pre_hook)

    found = {"first": None, "last": None, "start": None, "steps": 0}

    def before(opt, args, kwargs):
        if found["start"] is None:
            found["start"] = [[p.detach().clone() for p in g["params"]]
                              for g in opt.param_groups]

    def change(opt):
        return [torch.sqrt(sum(((p.detach() - q) ** 2).sum() for p, q in zip(g["params"], old)))
                for g, old in zip(opt.param_groups, found["start"])]

    def after(opt, args, kwargs):
        found["steps"] += 1
        if found["steps"] == 1:
            found["first"] = change(opt)
        if found["steps"] == steps:
            found["last"] = change(opt)

    handles = (register_optimizer_step_pre_hook(before),
               register_optimizer_step_post_hook(after))
    try:
        yield found
    finally:
        for h in handles:
            h.remove()


def _gap(got: float, want: float) -> float:
    return abs(got - want) / abs(want) if math.isfinite(got) else math.inf


def _worst_log_gap(got, want) -> float:
    """The larger of the groups' ``|ln(got / want)|``."""
    gaps = [abs(math.log(float(g) / w)) if math.isfinite(float(g)) and float(g) > 0 and w > 0
            else math.inf for g, w in zip(got, want)]
    return max(gaps)


def _worst_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double().flatten(1), want.double().flatten(1)
    rel = (got - want).norm(dim=1) / want.norm(dim=1)
    return float(torch.nan_to_num(rel, nan=math.inf).max())


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()

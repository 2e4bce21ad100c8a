"""SFNO training through the objects the training CLI builds.

``train.build_model``, ``pipeline.get_optimizer``, ``pipeline.onecycle_lr``
(built for the recipe's epochs, as ``train.main`` builds it),
``losses.SobolevLoss``, ``pipeline.make_device_epoch`` and
``pipeline.make_device_eval`` (``train/train.py``), on trajectories and
weights the benchmark makes from the seed, with the dataset on the device.
Each epoch's index arrays are drawn as ``epoch_indices`` draws them and fed
to the epoch's ``run`` in slices of ``slice_steps`` steps: a unit is one
slice, and the epoch's last slice runs the validation pass after it, as the
CLI does after each epoch.

Set-up drives the objects through the epoch's first ``check_steps`` steps
in one call of ``run``, as the window calls it, then warms the validation
pass. Correctness is read from the window itself: the parameters, Adam's
state and the schedule's position are copied to the host as the window
opens, and the first ``check_steps`` steps of the window's own ``run``
calls are checked: each step's loss as ``run`` returns it, the first
gradient by leaf as Adam got it (from its first moment after that step and
before it), and each leaf's change over those steps. The plain reference
(``reference/sfno.py``) follows the same steps from the copy, on the same
windows of the data, after the window closes.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchmark import inputs
from benchmark.reference import sfno as ref

DTYPES = {"float32": torch.float32}


def recipe_argv(cfg: dict, batch: int) -> list:
    """The training CLI's arguments for this configuration."""
    return ["--example", "McWilliams2d", "--epochs", str(cfg["epochs"]),
            "--num-samples", str(cfg["num_samples"]),
            "--num-val-samples", str(cfg["num_val_samples"]),
            "--batch-size", str(batch), "--lr", str(cfg["lr"]),
            "--norm-order", str(cfg["norm_order"]), "--width", str(cfg["width"]),
            "--modes", str(cfg["modes"]), "--modes-t", str(cfg["modes_t"]),
            "--num-layers", str(cfg["num_layers"]),
            "--latent-steps", str(cfg["latent_steps"]),
            "--time-steps", str(cfg["time_steps"]),
            "--out-time-steps", str(cfg["out_time_steps"]),
            "--beta", str(cfg["beta"]), "--activation", cfg["activation"],
            "--train-only"]


class Driver:
    def __init__(self, cell: dict, config: dict, seed: int, device, ranges):
        t0 = time.perf_counter()
        from tpu_cfd_torch.models import PointwiseFFN
        from tpu_cfd_torch.train import losses, pipeline, train

        self.setup_phases = {"import": time.perf_counter() - t0}
        self.cell, self.cfg, self.seed, self.device = cell, config, seed, device
        self.ranges = ranges
        self.batch = b = cell["batch"]
        dtype = DTYPES[cell["precision"]]
        n, frames = config["grid_size"], config["frames"]
        self.steps, self.out_steps = config["time_steps"], config["out_time_steps"]
        n_train, n_val = config["num_samples"], config["num_val_samples"]
        self.train_data = inputs.smooth_trajectories(seed, 0, n_train, n, frames, device, dtype)
        self.val_data = inputs.smooth_trajectories(seed, 1, n_val, n, frames, device, dtype)
        _sync(device)
        self.setup_phases["inputs"] = time.perf_counter() - t0

        args = train.get_parser().parse_args(recipe_argv(config, b)
                                             + (["--no-cuda"] if str(device) == "cpu" else []))
        self.model = train.build_model(args).to(device)
        self.model.load_state_dict(inputs.weights(ref.param_spec(config), seed, device, dtype))
        ranges.wrap_module(self.model, "bench.forward")
        for m in self.model.modules():
            if isinstance(m, PointwiseFFN):
                ranges.wrap_module(m, "bench.ffn", count=lambda v: v.numel() // v.shape[-1])
        self.steps_per_epoch = max(1, n_train // b)
        self.optimizer = pipeline.get_optimizer(args.optimizer, self.model.parameters(), args.lr)
        ranges.wrap_method(self.optimizer, "step", "bench.optimizer")
        scheduler = pipeline.onecycle_lr(self.optimizer, args.lr, self.steps_per_epoch,
                                         args.epochs)
        loss = losses.SobolevLoss(n_grid=n, norm_order=args.norm_order, relative=True)
        self.run_epoch = pipeline.make_device_epoch(
            self.model, loss, self.optimizer, self.train_data, self.steps, self.out_steps,
            scheduler, args.grad_clip)
        self.run_eval = pipeline.make_device_eval(
            self.model, loss, self.val_data, self.steps, self.out_steps,
            model_out_steps=self.out_steps)
        self.rng = np.random.default_rng(inputs.stream_seed(seed, 5))
        self.window = self.steps + self.out_steps
        self.val_idx = inputs.epoch_indices(n_val, frames, self.window, b,
                                            np.random.default_rng(0), shuffle=False)
        self._new_epoch()
        self.counters = {"units": 0, "attempted": 0, "failed": 0, "train_steps": 0,
                         "train_samples": 0}
        _sync(device)
        self.setup_phases["model"] = time.perf_counter() - t0
        k = cell["check_steps"]
        self.run_epoch(self.idx[:k], self.starts[:k]).cpu()
        self.pos = k
        self.setup_phases["first_steps"] = time.perf_counter() - t0
        self.model.eval()
        self.run_eval(*self.val_idx).item()  # the validation pass's shapes
        self.model.train()
        self.setup_phases["eval"] = time.perf_counter() - t0
        self.check = StepCheck(self.model, self.optimizer, scheduler, k)
        self.check_losses, self.check_rows, self.check_windows = [], [], None
        self.setup_phases["snapshot"] = time.perf_counter() - t0

    def _new_epoch(self):
        self.idx, self.starts = inputs.epoch_indices(
            self.cfg["num_samples"], self.cfg["frames"], self.window, self.batch, self.rng)
        self.pos = 0

    def unit(self) -> None:
        lo = self.pos
        hi = min(lo + self.cell["slice_steps"], self.steps_per_epoch)
        with self.ranges.range("bench.train"):
            losses = self.run_epoch(self.idx[lo:hi], self.starts[lo:hi]).cpu()
        steps = hi - lo
        need = min(self.cell["check_steps"] - len(self.check_losses), steps)
        if need > 0:
            self.check_losses += losses[:need].tolist()
            self.check_rows += [(self.idx[i], self.starts[i]) for i in range(lo, lo + need)]
        self.pos = hi
        c = self.counters
        c["units"] += 1
        c["attempted"] += steps
        c["failed"] += int((~torch.isfinite(losses)).sum())
        c["train_steps"] += steps
        c["train_samples"] += steps * self.batch
        if hi == self.steps_per_epoch:
            with self.ranges.range("bench.eval"):
                self.model.eval()
                val = float(self.run_eval(*self.val_idx))
                self.model.train()
            if not math.isfinite(val):
                c["failed"] += 1
            self._new_epoch()

    def end_to_end(self, window_s: float, peak_bytes: int) -> dict:
        return {"train_samples_per_s": self.counters["train_samples"] / window_s,
                "train_peak_gib": peak_bytes / 2 ** 30}

    def release(self) -> None:
        """Frees the program's objects; the benchmark's own training data
        stays until the checked windows are gathered from it."""
        self.model = self.optimizer = self.run_epoch = self.run_eval = None
        self.val_data = None

    def windows(self) -> list:
        """The input and target windows of the checked steps."""
        if self.check_windows is None:
            self.check_windows = [ref.gather(self.train_data, i, s, self.steps, self.out_steps)
                                  for i, s in self.check_rows]
            self.train_data = None
        return self.check_windows

    def readings(self) -> dict:
        return dict(self.check.readings(), losses=self.check_losses)

    def reference(self, tf32: bool = False) -> dict:
        """The plain reference's readings over the checked steps, from the
        state the window started from."""
        start = self.check.start(self.device)
        losses, grads, params = ref.train(start["params"], self.windows(), self.cfg,
                                          self.steps_per_epoch, tf32=tf32, state=start)
        return {"losses": losses,
                "first_grad": {k: float(g.double().norm()) for k, g in grads.items()},
                "change": {k: float((params[k] - start["params"][k]).double().norm())
                           for k in params}}

    def use_control(self) -> None:
        """The control in the program's place: the readings of the reference
        computed with TF32 operands."""
        control = self.reference(tf32=True)
        self.check_losses = control["losses"]
        self.check.found = {"first_grad": control["first_grad"], "change": control["change"]}

    def compare(self) -> dict:
        """Every number the check reads, compared or not."""
        return gaps(self.readings(), self.reference())


class StepCheck:
    """The state the window starts from, and what the window's first
    ``k`` optimizer steps make of it.

    Built as the window opens: copies the parameters, Adam's moments, its
    step count and the schedule's position to the host, and wraps the
    optimizer's ``step`` on this instance so that after the first step of
    the window it copies the first moments, and after the ``k``-th the
    parameters, into pinned host memory, without a host sync."""

    def __init__(self, model, optimizer, scheduler, k: int):
        self.names = [name for name, _ in model.named_parameters()]
        self.params = list(model.parameters())
        self.beta1 = optimizer.param_groups[0]["betas"][0]
        state = [optimizer.state.get(p, {}) for p in self.params]
        steps = {int(st["step"]) for st in state if "step" in st}
        self.snapshot = {
            "params": {n: _host(p) for n, p in zip(self.names, self.params)},
            "exp_avg": {n: _host(st["exp_avg"]) for n, st in zip(self.names, state)
                        if "exp_avg" in st},
            "exp_avg_sq": {n: _host(st["exp_avg_sq"]) for n, st in zip(self.names, state)
                           if "exp_avg_sq" in st},
            "step": steps.pop() if len(steps) == 1 else 0,
            "lr_step": scheduler.last_epoch}
        pin = self.params[0].is_cuda
        self.moment = {n: torch.empty(p.shape, dtype=p.dtype, pin_memory=pin)
                       for n, p in zip(self.names, self.params)}
        self.after = {n: torch.empty(p.shape, dtype=p.dtype, pin_memory=pin)
                      for n, p in zip(self.names, self.params)}
        self.k, self.seen, self.moved, self.found = k, 0, set(), None
        self.optimizer = optimizer
        inner = optimizer.step

        def step(*args, **kwargs):
            out = inner(*args, **kwargs)
            if self.seen < self.k:
                self._after_step()
            return out

        optimizer.step = step

    def _after_step(self) -> None:
        self.seen += 1
        if self.seen == 1:
            for n, p in zip(self.names, self.params):
                m = self.optimizer.state.get(p, {}).get("exp_avg")
                if m is not None:
                    self.moment[n].copy_(m, non_blocking=True)
                    self.moved.add(n)
        if self.seen == self.k:
            for n, p in zip(self.names, self.params):
                self.after[n].copy_(p.detach(), non_blocking=True)
            self.optimizer = self.params = None

    def start(self, device) -> dict:
        snap = self.snapshot
        on = {key: {n: v.to(device) for n, v in snap[key].items()}
              for key in ("params", "exp_avg", "exp_avg_sq")}
        return dict(on, step=snap["step"], lr_step=snap["lr_step"])

    def readings(self) -> dict:
        """The first gradient's norm by leaf, ``(m_1 - beta1 m_0) / (1 -
        beta1)`` in float64 (0 for a leaf Adam kept no moment of), and each
        leaf's change over the ``k`` steps; empty where the window took
        fewer than ``k`` steps."""
        if self.found is None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            if self.seen < self.k:
                self.found = {"first_grad": {}, "change": {}}
            else:
                snap, b1 = self.snapshot, self.beta1
                grad = {}
                for n in self.names:
                    m0 = snap["exp_avg"].get(n)
                    g = self.moment[n].double() - (b1 * m0.double() if m0 is not None else 0)
                    grad[n] = float(g.norm()) / (1 - b1) if n in self.moved else 0.0
                change = {n: float((self.after[n].double() - snap["params"][n].double()).norm())
                          for n in self.names}
                self.found = {"first_grad": grad, "change": change}
        return self.found


def gaps(got: dict, want: dict) -> dict:
    """The numbers compared, each by the worst leaf where it is by leaf: the
    largest relative gap of a step's loss; the gap between the port's and
    the reference's norms of the first gradient over the reference's norm
    of that leaf or of the median leaf, whichever is larger; and the same
    gap of each leaf's change over the checked steps. Leaves whose reference
    gradient is under a thousandth of the median leaf's move by round-off
    alone and are left out of the change (``change_worst_leaf`` names the
    leaf that reads highest, for the record)."""
    def rel(a, b, scale):
        r = abs(a - b) / scale
        return r if math.isfinite(r) else math.inf

    if len(got["losses"]) != len(want["losses"]) or not got["first_grad"]:
        return {"loss_gap": math.inf, "grad_gap": math.inf, "change_gap": math.inf,
                "change_worst_leaf": None}
    loss = max(rel(g, w, abs(w)) for g, w in zip(got["losses"], want["losses"]))
    med_g = float(np.median(list(want["first_grad"].values())))
    grad = max(rel(got["first_grad"].get(k, 0.0), w, max(w, med_g))
               for k, w in want["first_grad"].items())
    moved = [k for k, w in want["first_grad"].items() if w >= 1e-3 * med_g]
    med_c = float(np.median([want["change"][k] for k in moved]))
    change = {k: rel(got["change"].get(k, 0.0), want["change"][k], max(want["change"][k], med_c))
              for k in moved}
    worst = max(change, key=change.get)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change[worst],
            "change_worst_leaf": worst}


def _host(t):
    """A copy on the host (never the tensor itself, as ``.cpu()`` gives on
    the CPU)."""
    return t.detach().to("cpu", copy=True)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()

"""FNO-3D training through the objects the FNO3d training CLI builds.

``train_fno3d.load_windows`` on the FNO-paper-format path (``--mat-file``:
``NavierStokesDataset``, the inputs normalised with the train statistics,
the targets raw) with the benchmark's trajectories in place of the file,
``train_fno3d.build`` (the model, Adam, the one-cycle schedule over the
configuration's epochs, the Sobolev loss, the train step) with weights the
benchmark makes from the seed, and an epoch as the CLI runs one:
``epoch_order``, ``train_epoch`` and ``evaluate`` (the test pass, one sample
at a time, on the card one CUDA graph replayed each epoch). The windows
live on the device. A unit is one epoch as the CLI runs one: its train
steps launched inside a ``bench.train`` range, then the test pass inside
``bench.eval``, then one synchronisation; the test pass runs in the window
and is not counted as training.

Set-up captures the test pass's graph (on the card), then runs one epoch as
a unit runs it, so that the window starts on warm allocator pools and plans.
Correctness is read
from the window itself, as ``drivers/train.py`` reads it: the parameters,
Adam's state and the schedule's position are copied to the host as the
window opens (``StepCheck``), and the window's first ``check_steps`` steps
are checked: each step's loss as ``train_epoch`` returns it, the first
gradient by leaf as Adam got it, and each leaf's change over those steps.
The plain reference (``reference/fno3d.py``) follows the same steps from the
copy, on the same rows of the trajectories, which it normalises with the
train statistics it computes itself, after the window closes.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchmark import inputs
from benchmark.drivers.train import StepCheck, gaps
from benchmark.reference import fno3d as ref

DTYPES = {"float32": torch.float32}
FNO3D_COUNTS = ("forwards", "conv_calls", "conv_points")


def cli_argv(cfg: dict, batch: int) -> list:
    """The FNO3d training CLI's arguments for this configuration; the
    trajectories go to ``load_windows`` in place of ``--mat-file``'s."""
    return ["--num-samples", str(cfg["num_samples"]),
            "--num-test-samples", str(cfg["num_test_samples"]),
            "--epochs", str(cfg["epochs"]), "--batch-size", str(batch),
            "--lr", str(cfg["lr"]), "--modes", str(cfg["modes"]),
            "--modes-t", str(cfg["modes_t"]), "--width", str(cfg["width"]),
            "--time-steps", str(cfg["time_steps"]), "--out-steps", str(cfg["out_steps"]),
            "--res", str(cfg["grid_size"])]


class Driver:
    def __init__(self, cell: dict, config: dict, seed: int, device, ranges):
        t0 = time.perf_counter()
        from tpu_cfd_torch.models import fno3d
        from tpu_cfd_torch.train import train_fno3d as cli

        if not hasattr(cli, "build"):
            raise RuntimeError("this tree's train_fno3d has no build(): the cell drives it")
        self.setup_phases = {"import": time.perf_counter() - t0}
        self.cli, self.fno3d = cli, fno3d
        self.cell, self.cfg, self.seed, self.device = cell, config, seed, device
        self.ranges = ranges
        self.batch = b = cell["batch"]
        dtype = DTYPES[cell["precision"]]
        n_train, n_test = config["num_samples"], config["num_test_samples"]
        self.n_train = n_train
        # the trajectories stay on the host, as the file's array, for the
        # check; the program's windows go to the device
        self.trajectories = inputs.smooth_trajectories(
            seed, 0, n_train + n_test, config["grid_size"], config["frames"], device,
            dtype).cpu().numpy()
        self.setup_phases["inputs"] = time.perf_counter() - t0

        args = cli.get_parser().parse_args(cli_argv(config, b)
                                           + (["--no-cuda"] if str(device) == "cpu" else []))
        windows = cli.load_windows(args, mat=self.trajectories)
        (a, u), (at, ut), normalizer = windows
        self.A, self.U, self.At, self.Ut = (cli.to_device(x, device) for x in (a, u, at, ut))
        del windows, a, u, at, ut
        self.setup_phases["windows"] = time.perf_counter() - t0

        self.built = cli.build(args, n_train, normalizer, device)
        self.steps_per_epoch = self.built.steps_per_epoch
        model = self.built.model
        model.load_state_dict(inputs.weights(ref.param_spec(config), seed, device, dtype))
        ranges.wrap_module(model, "bench.forward")
        ranges.wrap_method(self.built.optimizer, "step", "bench.optimizer")
        self.rng = np.random.default_rng(inputs.stream_seed(seed, 5))
        self.counters = {"units": 0, "attempted": 0, "failed": 0, "train_steps": 0,
                         "train_samples": 0, **{k: 0 for k in FNO3D_COUNTS}}
        _sync(device)
        self.setup_phases["model"] = time.perf_counter() - t0

        # the test pass's graph first: its capture empties the allocator's
        # cache, which the epoch after it fills again before the window
        cli.evaluate(self.built, self.At, self.Ut)
        self.setup_phases["test_graph"] = time.perf_counter() - t0
        self._epoch()
        self.setup_phases["first_epoch"] = time.perf_counter() - t0
        self.check = StepCheck(model, self.built.optimizer, self.built.scheduler,
                               cell["check_steps"])
        self.check_losses, self.check_rows = [], []
        self.setup_phases["snapshot"] = time.perf_counter() - t0

    def _epoch(self):
        """One epoch: the train steps' losses and the test loss, on the
        host, and the epoch's order, after the epoch's one synchronisation."""
        order = self.cli.epoch_order(self.rng, self.n_train, self.batch, self.device)
        with self.ranges.range("bench.train"):
            losses = self.cli.train_epoch(self.built, self.A, self.U, order)
        with self.ranges.range("bench.eval"):
            test = self.cli.evaluate(self.built, self.At, self.Ut)
        return losses.cpu(), float(test), order

    def unit(self) -> None:
        counts = dict(self.fno3d.COUNTS)
        losses, test, order = self._epoch()
        steps = len(losses)
        need = min(self.cell["check_steps"] - len(self.check_losses), steps)
        if need > 0:
            self.check_losses += losses[:need].tolist()
            self.check_rows += order[:need].cpu().numpy().tolist()
        c = self.counters
        c["units"] += 1
        c["attempted"] += steps
        c["failed"] += int((~torch.isfinite(losses)).sum()) + (0 if math.isfinite(test) else 1)
        c["train_steps"] += steps
        c["train_samples"] += steps * self.batch
        for key in FNO3D_COUNTS:
            c[key] += self.fno3d.COUNTS[key] - counts[key]

    def end_to_end(self, window_s: float, peak_bytes: int) -> dict:
        return {"train_samples_per_s": self.counters["train_samples"] / window_s,
                "train_peak_gib": peak_bytes / 2 ** 30}

    def release(self) -> None:
        """Frees the program's objects and windows; the benchmark's own
        trajectories stay on the host for the check."""
        self.built = self.A = self.U = self.At = self.Ut = None

    def windows(self) -> list:
        """The checked steps' normalised input frames and target frames, from
        the trajectories, normalised with the statistics the reference
        computes from the train set's input frames."""
        t_in, t_out = self.cfg["time_steps"], self.cfg["out_steps"]
        train = torch.from_numpy(self.trajectories[:self.n_train])
        stats = tuple(s.to(self.device) for s in ref.input_statistics(train[..., :t_in]))
        out = []
        for rows in self.check_rows:
            batch = train[rows].to(self.device)
            out.append((ref.normalize(batch[..., :t_in], stats),
                        batch[..., t_in: t_in + t_out].contiguous()))
        return out

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


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()

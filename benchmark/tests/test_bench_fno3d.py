"""The FNO-3D cell, ``fno3d_ns64.train_b10``, on the CPU at a small size:
added as files alone, its driver's units and counters, correct, failed by
each of its faults and by its control, its work counted as worked by hand,
its readers on a hand-made trace and span log, and its reference free of
the port and of JAX.

The faults are planted here, around ``harness.make_driver``:
``faults.FAULTS`` is keyed by the ``generate`` and ``train`` drivers' names,
and this cell's driver, ``train_fno3d``, builds other objects. ``FAULTS``
below is the set the cell's limits were calibrated against on the card.
"""

import json
import math
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import faults, harness
from benchmark import trace as tracing
from benchmark.faults import patched

from conftest import BENCH
from test_bench_harness import _copy_checkout, _Event, _run_in

WORKLOAD = "fno3d_ns64.train_b10"
# 16², 4 -> 6 frames, modes 4/4/3, width 8 (the CLI's 128-wide head), 8
# train and 2 test trajectories of 12 frames, batch 2: 4 steps an epoch,
# the schedule at the rate of its first steps (1e-7). The limits sit
# between what the program reads at this size over 12 seeds (loss 1.5e-7,
# gradient 1.3e-5, change by the worst leaf 1.7e-4: the last block's and
# the head's biases, whose gradients are near-cancelling sums) and what the
# faults and the control read (gradient 5.5e-4 and more, change 5.7e-3 and
# more or the gradient failed) (test_each_fault_makes_the_run_incorrect,
# test_the_control_fails_the_check); the cell's own limits hold at its own
# size on the card.
SMALL_CELL = dict(batch=2, limits={"loss_gap": 1e-6, "grad_gap": 1e-4, "change_gap": 1e-3})
SMALL_CONFIG = dict(grid_size=16, frames=12, time_steps=4, out_steps=6, width=8, modes=4,
                    modes_t=3, num_samples=8, num_test_samples=2)


def fault_half_batch():
    """Each train step takes the first half of its batch alone."""
    from tpu_cfd_torch.train import pipeline

    inner = pipeline.make_train_step

    def make(*args, **kwargs):
        step = inner(*args, **kwargs)

        def half(inp, target):
            keep = max(1, inp.shape[0] // 2)
            return step(inp[:keep], target[:keep])
        return half
    return patched(pipeline, "make_train_step", make)


def fault_altered():
    """The model's prediction comes out scaled by 1 + 1e-3."""
    from tpu_cfd_torch.models.fno3d import FNO3d

    inner = FNO3d.forward

    def forward(self, x):
        out, aux = inner(self, x)
        return out * (1 + 1e-3), aux
    return patched(FNO3d, "forward", forward)


def fault_altered_after_setup():
    """From the second ``train_epoch`` call on, the window's, the
    prediction comes out scaled by 1 + 1e-3: a path that goes wrong only
    once warmed up."""
    from tpu_cfd_torch.train import train_fno3d

    inner = train_fno3d.train_epoch
    calls = []

    def train_epoch(*args, **kwargs):
        calls.append(1)
        if len(calls) == 1:
            return inner(*args, **kwargs)
        with fault_altered():
            return inner(*args, **kwargs)
    return patched(train_fno3d, "train_epoch", train_epoch)


def fault_corner_dropped():
    """Each spectral conv leaves out its last (x, y) corner block."""
    from tpu_cfd_torch.models.fno3d import SpectralConv3d

    def spectral_conv(self, vh, kx, ky, kt):
        m1, m2, m3 = self.modes
        out = vh.new_zeros((vh.shape[0], kx, ky, kt, self.out_channels))
        corners = [(slice(0, m1), slice(0, m2)), (slice(-m1, None), slice(0, m2)),
                   (slice(0, m1), slice(-m2, None))]
        for i, (sx, sy) in enumerate(corners):
            w = torch.view_as_complex(getattr(self, f"weight_{i}").contiguous())
            out[:, sx, sy, :m3, :] = self.complex_matmul(vh[:, sx, sy, :m3, :], w)
        return out
    return patched(SpectralConv3d, "spectral_conv", spectral_conv)


def fault_unscaled_inputs():
    """The train inputs are centred with the train statistics but not
    divided by their standard deviation."""
    from tpu_cfd_torch.data import datasets

    inner = datasets.UnitGaussianNormalizer.fit_transform

    def fit_transform(self, x):
        inner(self, x)
        return x - self.mean
    return patched(datasets.UnitGaussianNormalizer, "fit_transform", fit_transform)


FAULTS = {"unchanged": faults.train_unchanged, "half_batch": fault_half_batch,
          "altered": fault_altered, "altered_after_setup": fault_altered_after_setup,
          "corner_dropped": fault_corner_dropped, "unscaled_inputs": fault_unscaled_inputs}


def cell_limits() -> dict:
    return harness.load_cell(WORKLOAD)[2]["limits"]


@pytest.fixture
def small():
    _, _, cell, config = harness.load_cell(WORKLOAD)
    return dict(cell, **SMALL_CELL), dict(config, **SMALL_CONFIG)


def test_the_cell_is_added_as_files_alone(tmp_path):
    """A copy of the checkout runs the cell, traced, from its cell,
    configuration, driver, work, metric and reference files and its entries
    in BENCHMARK.json, and loads no module of the JAX stack."""
    _copy_checkout(tmp_path)
    code = (
        "import json, sys, time; from benchmark import harness\n"
        f"_, _, cell, config = harness.load_cell({WORKLOAD!r})\n"
        f"cell = dict(cell, **{SMALL_CELL!r})\n"
        f"config = dict(config, **{SMALL_CONFIG!r})\n"
        f"r = harness.run({WORKLOAD!r}, 2 ** 31 + 7, 0.3, True, time.perf_counter(),"
        " device='cpu', cell=cell, config=config)\n"
        "print(harness.forbidden_modules())\n"
        "print(json.dumps(r))\n")
    out = _run_in(tmp_path, code)
    assert out.returncode == 0, out.stderr[-3000:]
    found, line = out.stdout.strip().splitlines()[-2:]
    assert found == "[]"
    result = json.loads(line)
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == set(cell_limits())
    # the CPU has no device trace: the host-clock metric alone
    assert set(result["metrics"]) == {"step_mfu.fno3d"}
    assert f"benchmark: {WORKLOAD} seed {2 ** 31 + 7} " in out.stderr
    for name in ("bench.forward", "bench.optimizer"):
        assert f"'{name}'" in out.stderr


def test_the_cell_reports_its_metrics():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    e2e = {m["name"] for m in harness.cell_metrics(bench, WORKLOAD, "end_to_end")}
    layers = {m["name"] for m in harness.cell_metrics(bench, WORKLOAD, "per_layer")}
    assert e2e == {"train_samples_per_s", "train_peak_gib", "setup_s"}
    assert layers == {f"{m}.fno3d" for m in ("step_mfu", "device_idle", "launches_per_step",
                                             "conv_share", "conv_roofline")}
    for w in bench["workloads"]:
        if w["name"] != WORKLOAD:
            assert not layers & {m["name"] for m in harness.cell_metrics(bench, w["name"],
                                                                         "per_layer")}
    entry = next(w for w in bench["workloads"] if w["name"] == WORKLOAD)
    assert entry["chips"] == 1 and entry["config"] == "fno3d_ns64"


def test_the_drivers_units_and_counters(small):
    """Each unit is one epoch: 4 train steps of 2 samples and the test pass
    over 2 samples; the port's counters: 4 + 2 forwards, 4 convs each, of 2
    or 1 samples of 16 x 16 x 6 points; traced, a ``bench.forward`` a
    forward and a ``bench.optimizer`` a step."""
    cell, config = small
    ranges = tracing.Ranges(True)
    drv = harness.make_driver(cell, config, 11, "cpu", ranges)
    ranges.reset()
    for _ in range(2):
        drv.unit()
    volume = 16 * 16 * 6
    assert drv.counters == {"units": 2, "attempted": 8, "failed": 0, "train_steps": 8,
                            "train_samples": 16, "forwards": 12, "conv_calls": 48,
                            "conv_points": 2 * 4 * (4 * 2 + 2 * 1) * volume}
    assert ranges.calls == {"bench.forward": 12, "bench.optimizer": 8}
    assert drv.A.shape == (8, 16, 16, 4) and drv.U.shape == (8, 16, 16, 6)
    assert drv.At.shape == (2, 16, 16, 4) and drv.Ut.shape == (2, 16, 16, 6)
    assert len(drv.check_losses) == 3 and len(drv.check_rows) == 3
    assert drv.steps_per_epoch == 4
    assert drv.end_to_end(2.0, 3 * 2 ** 29) == {"train_samples_per_s": 8.0,
                                               "train_peak_gib": 1.5}


@pytest.mark.parametrize("trace", [False, True])
def test_a_small_run_is_correct(small, trace):
    cell, config = small
    result = harness.run(WORKLOAD, 2 ** 33 + 1, 0.2, trace, time.perf_counter(),
                         device="cpu", cell=cell, config=config)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    if not trace:
        assert set(result["metrics"]) == {"train_samples_per_s", "train_peak_gib", "setup_s"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_each_fault_makes_the_run_incorrect(small, fault):
    cell, config = small
    with FAULTS[fault]():
        result = harness.run(WORKLOAD, 2 ** 32 + 3, 0.1, False, time.perf_counter(),
                             device="cpu", cell=cell, config=config)
    assert not result["correct"], result["checks"]


def test_the_control_fails_the_check(small):
    cell, config = small
    drv = harness.make_driver(cell, config, 41, "cpu")
    drv.unit()
    drv.release()
    assert all(v <= cell["limits"][k] for k, v in drv.compare().items()
               if k in cell["limits"])
    drv.use_control()
    found = drv.compare()
    assert any(found[k] > lim for k, lim in cell["limits"].items()), found


def test_a_tree_without_the_factored_cli_fails_at_once(small, monkeypatch):
    """The parent of this cell's files lacks ``train_fno3d.build``: the
    driver stops before it makes any input."""
    from tpu_cfd_torch.train import train_fno3d

    cell, config = small
    monkeypatch.delattr(train_fno3d, "build")
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="no build"):
        harness.make_driver(cell, config, 1, "cpu")
    assert time.perf_counter() - t0 < 5


def test_work_counts_by_hand():
    """At 4², 2 input and 2 output steps, width 2, modes 1/1/1, one block, a
    head of 3: a conv's volume 32 points, its transform 2.5 · 32 · 5 = 400
    operations, two a channel and a contraction of 8 · 2 · 2 · 1 · 4 = 128:
    1,728 a sample; the lift 2 · 32 · 5 · 2 = 640, the block's MLP and skip
    2 · 32 · 3 · 4 = 768, the head 2 · 32 · (6 + 3) = 576, the loss's 4
    transforms of 16 points 4 · 160 = 640: a forward of 4,352; 75
    parameters."""
    work = harness.load_module("work", "fno3d_ns64")
    cfg = dict(grid_size=4, time_steps=2, out_steps=2, width=2, modes=1, modes_t=1,
               num_layers=1, channel_expansion=3)
    assert work.conv_flops(cfg, 1) == 1_728
    assert work.forward_flops(cfg, 1) == 4_352
    assert work.step_flops(cfg, 1) == 3 * 4_352 + 12 * 75
    rec = SimpleNamespace(config=cfg, cell={"batch": 1}, counters={
        "train_steps": 5, "conv_calls": 3, "conv_points": 96}, peak_flops=1e3, peak_bytes=1e3)
    assert work.window_flops(rec) == 5 * work.step_flops(cfg, 1)
    # 3 samples' convs: 5,184 operations; 4 · 96 · 2 · 2 = 1,536 bytes of
    # activations and 3 · 4 · 2 · 2 · 8 = 384 of weights
    assert work.conv_bound_s(rec) == pytest.approx(5_184 / 1e3)
    rec.peak_flops = 1e6
    assert work.conv_bound_s(rec) == pytest.approx(1_920 / 1e3)
    rec.counters = {"train_steps": 5}
    assert work.conv_bound_s(rec) is None


def test_the_published_widths_count():
    """The configuration's parameters, and a train step of about 111 GFLOP
    at batch 10 (a forward of 37.1)."""
    work = harness.load_module("work", "fno3d_ns64")
    config = json.loads((BENCH / "configs" / "fno3d_ns64.json").read_text())
    from benchmark.reference import fno3d as ref

    assert ref.n_params(config) == config["n_params"] == 6_561_737
    assert work.forward_flops(config, 10) == pytest.approx(37.10e9, rel=1e-3)
    assert work.step_flops(config, 10) == pytest.approx(111.38e9, rel=1e-3)
    assert config["reduced"] == {}
    assert (config["grid_size"], config["time_steps"], config["out_steps"], config["width"],
            config["modes"], config["modes_t"], config["num_layers"],
            config["channel_expansion"]) == (64, 10, 40, 20, 8, 8, 4, 128)


def test_the_reference_imports_nothing_of_the_port():
    text = (BENCH / "reference" / "fno3d.py").read_text()
    assert "tpu_cfd" not in text and "jax" not in text
    imported = [line.split()[1] for line in text.splitlines()
                if line.startswith(("import ", "from "))]
    assert not {m.split(".")[0] for m in imported} & set(harness.FORBIDDEN)
    assert "allow_tf32 = False" in text


# A window of 1000 ns. The host: one train step (a ``bench.train`` call,
# 90-500), its forward (100-300) holding two convs, an MLP and the head,
# its backward (300-400); then a test sample's forward in ``bench.eval``
# (550-700), its conv at 600-650. The device: one operation a launch.
LOG = [
    ("train.forward", 100, 300, -1),
    ("fno3d.conv", 110, 150, 0),
    ("fno3d.mlp", 150, 170, 0),
    ("fno3d.conv", 170, 200, 0),
    ("fno3d.head", 200, 220, 0),
    ("train.backward", 300, 400, -1),
    ("fno3d.conv", 600, 650, -1),
]
OPS = [  # (launch call, its host start, the operation's device start and end, its name)
    ("cudaLaunchKernel", 120, 125, 165, "fft_r2c"),
    ("cudaLaunchKernel", 155, 165, 185, "gemm_mlp"),
    ("cuLaunchKernel", 180, 185, 215, "fft_c2r"),
    ("cudaLaunchKernel", 210, 215, 265, "gemm_head"),
    ("cudaLaunchKernel", 350, 270, 370, "backward"),
    ("cudaLaunchKernel", 620, 625, 645, "fft_eval"),
    ("cudaLaunchKernel", 660, 665, 675, "gemm_eval"),
]
READERS = ("step_mfu.fno3d", "device_idle.fno3d", "launches_per_step.fno3d",
           "conv_share.fno3d", "conv_roofline.fno3d")
# by hand: the train forward's operations 40 + 20 + 30 + 50 = 140 ns, its
# convs' 70; all convs' (the test pass's too) 90, the bound 45; busy 125-265,
# 270-370, 625-645, 665-675: 270 ns; 5 launches in the train call, 1 step;
# 200,000 operations over 1000 ns at 1e12/s
HAND = {"step_mfu.fno3d": 20.0, "device_idle.fno3d": 73.0, "launches_per_step.fno3d": 5.0,
        "conv_share.fno3d": 50.0, "conv_roofline.fno3d": 50.0}


def _record():
    events = [_Event(tracing.WINDOW, 0, 1000, annotation=True),
              _Event("bench.train", 90, 500, annotation=True),
              _Event("bench.eval", 550, 700, annotation=True)]
    for corr, (call, at, start, end, name) in enumerate(OPS, 1):
        events += [_Event(call, at, at + 2, corr=corr),
                   _Event(name, start, end, cuda=True, corr=corr)]
    return SimpleNamespace(
        trace=tracing.Trace(events), window_s=1000 / 1e9, peak_flops=1e12,
        counters={"train_steps": 1},
        ranges=SimpleNamespace(calls={"bench.train": 1, "bench.eval": 1}),
        work=SimpleNamespace(window_flops=lambda r: 2e5, conv_bound_s=lambda r: 45e-9))


def _readings(rec) -> dict:
    return {name: harness.load_module("metrics", name).read(rec) for name in READERS}


def test_the_readers_by_hand(monkeypatch):
    from tpu_cfd_torch.utils import profiling

    monkeypatch.setattr(profiling, "span_log", lambda: list(LOG))
    monkeypatch.setattr(profiling, "spans_dropped", lambda: (0, -1))
    assert _readings(_record()) == pytest.approx(HAND)
    # without the port's span log (a tree before it) the span readers read
    # nothing, and the others as before
    monkeypatch.setattr(profiling, "span_log", lambda: [])
    got = _readings(_record())
    assert got["conv_share.fno3d"] is None and got["conv_roofline.fno3d"] is None
    assert {k: got[k] for k in READERS[:3]} == pytest.approx(
        {k: HAND[k] for k in READERS[:3]})


def test_the_readers_are_listed_for_the_cell():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    listed = {m["name"]: m for m in bench["per_layer"] if m["name"] in READERS}
    assert set(listed) == set(READERS)
    for name, m in listed.items():
        assert m["workloads"] == [WORKLOAD] and m["moves"] == "train_samples_per_s"
        assert m["source"] == ("host_clock" if name.startswith("step_mfu") else "device_trace")
    assert math.isclose(HAND["device_idle.fno3d"], 100 * (1 - 270 / 1000))

"""The Spectral-Refiner cell, ``refiner_fno256.ft_b8``, on the CPU at a small
size: added as files alone, its driver's units and counters, correct,
failed by each of its faults and by its control, its work counted as
worked by hand, and its reference free of the port and of JAX.

The faults are planted here, around ``harness.make_driver``:
``faults.FAULTS`` is keyed by the ``generate`` and ``train`` drivers' names,
and a fault of the refine patches other objects. ``FAULTS`` below is the set
the cell's limits were calibrated against on the card.
"""

import json
import math
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness
from benchmark.faults import patched

from conftest import BENCH
from test_bench_harness import _copy_checkout, _run_in

WORKLOAD = "refiner_fno256.ft_b8"
# 32², 2 samples, 12 iterations, the enlarged conv at 16/16/6 (the SFNO's
# widths as configured), input frames 10 steps apart after 20, held to the
# cell's own limits: over 13 seeds the program reads at most 3.9e-16
# (zero-shot), 4.1e-13 (first time derivative), 8.7e-8 (first residual),
# 0.168 (history), 1.17 (first update's log ratio; 0.37 at 256²), 0.243 (the
# whole refine's change; 0.051 at 256²) and 7.2e-5 (refined); each fault
# fails the first time derivative, the first update or the refine's change,
# the optimizer's faults the last by 1.66 and more, the fp32 control all
# three (test_each_fault_makes_the_run_incorrect,
# test_the_control_fails_the_check). Over 3 iterations two sound refines'
# changes part by up to 0.53 and the frozen bias correction reads from 0.55.
SMALL_CELL = dict(batch=2, check_block=1)
SMALL_CONFIG = dict(grid_size=32, modes_ft=[16, 16, 6], iters=12, warmup_steps=20,
                    record_every=10)


def fault_one_direction():
    """The time derivative from the +dt Crank-Nicolson solve alone."""
    from tpu_cfd_torch.train import finetune

    inner = finetune.get_temporal_derivative
    return patched(finetune, "get_temporal_derivative",
                   lambda w_h, f_h, dt, weight=None, **kw: inner(w_h, f_h, dt,
                                                                 weight=(0.0, 1.0), **kw))


def fault_no_dealias():
    """The post-process without the 2/3 rule on the convection."""
    from tpu_cfd_torch.train import finetune

    inner = finetune.fine_tune_post
    return patched(finetune, "fine_tune_post",
                   lambda *a, **k: inner(*a, **dict(k, dealias=False)))


def fault_latent():
    """One sample's reduced latent comes out shifted by one grid cell."""
    from tpu_cfd_torch.examples import ex2_sfno_finetune as example

    inner = example.zero_shot

    def zero_shot(model, w_in, out_steps):
        pred, r = inner(model, w_in, out_steps)
        r = r.clone()
        r[0] = torch.roll(r[0], 1, dims=0)
        return pred, r
    return patched(example, "zero_shot", zero_shot)


def fault_bias_lr():
    """The biases refined at the weights' learning rate."""
    from tpu_cfd_torch.train import finetune

    inner = finetune.groupwise_adam
    return patched(finetune, "groupwise_adam",
                   lambda lr_weight, lr_bias, named: inner(lr_weight, lr_weight, named))


def _adam_with(hook, when: str):
    """``finetune.groupwise_adam`` whose optimizer calls ``hook(opt)``
    before (``when="pre"``) or after (``"post"``) each of its steps."""
    from tpu_cfd_torch.train import finetune

    inner = finetune.groupwise_adam

    def groupwise_adam(*args, **kwargs):
        opt = inner(*args, **kwargs)
        register = (opt.register_step_pre_hook if when == "pre"
                    else opt.register_step_post_hook)
        register(lambda o, a, k: hook(o))
        return opt
    return patched(finetune, "groupwise_adam", groupwise_adam)


def fault_stops_after_first():
    """The optimizer stops after its first step: every group's learning
    rate set to 0 once it has stepped."""
    def stop(opt):
        for g in opt.param_groups:
            g["lr"] = 0.0
    return _adam_with(stop, "post")


def fault_bias_correction_frozen():
    """Adam's bias corrections frozen at t = 1: each step counter set back
    to 0 before the step that raises it to 1."""
    def freeze(opt):
        for state in opt.state.values():
            if "step" in state:
                state["step"].zero_()
    return _adam_with(freeze, "pre")


FAULTS = {"one_direction": fault_one_direction, "no_dealias": fault_no_dealias,
          "latent": fault_latent, "bias_lr": fault_bias_lr,
          "stops_after_first": fault_stops_after_first,
          "bias_correction_frozen": fault_bias_correction_frozen}


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
    assert set(result["metrics"]) == {"step_mfu.ft"}
    assert f"benchmark: {WORKLOAD} seed {2 ** 31 + 7} " in out.stderr
    for name in ("bench.zero_shot", "bench.refine", "bench.post"):
        assert f"'{name}'" in out.stderr


def test_the_cell_reports_its_metrics():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    e2e = {m["name"] for m in harness.cell_metrics(bench, WORKLOAD, "end_to_end")}
    layers = {m["name"] for m in harness.cell_metrics(bench, WORKLOAD, "per_layer")}
    assert e2e == {"train_samples_per_s", "train_peak_gib", "setup_s"}
    assert layers == {f"{m}.ft" for m in ("device_idle", "step_mfu", "refine_roofline",
                                          "post_share")}
    others = [w["name"] for w in bench["workloads"] if w["name"] != WORKLOAD]
    for w in others:
        assert not layers & {m["name"] for m in harness.cell_metrics(bench, w, "per_layer")}


def test_the_drivers_units_and_counters(small):
    """Each unit is one batch, the two batches in turn: 2 samples × 12
    iterations counted, 12 Adam updates and at least one keep-best copy by
    the port's counter; traced, one ``bench.zero_shot`` and one
    ``bench.refine`` call a unit, carrying the batch, and 13 ``bench.post``
    calls (12 iterations and the keep-best evaluation)."""
    from benchmark import trace as tracing

    cell, config = small
    ranges = tracing.Ranges(True)
    drv = harness.make_driver(cell, config, 11, "cpu", ranges)
    assert drv.checked in (0, 1)
    ranges.reset()
    for _ in range(3):
        drv.unit()
    c = drv.counters
    assert {k: c[k] for k in ("units", "attempted", "failed", "sample_iterations",
                              "iterations")} == {"units": 3, "attempted": 3, "failed": 0,
                                                 "sample_iterations": 72, "iterations": 36}
    assert 3 <= c["best_copies"] <= 36
    assert ranges.calls == {"bench.zero_shot": 3, "bench.refine": 3, "bench.post": 39}
    assert ranges.counts == {"bench.refine": 6}
    assert set(drv.done) == {0, 1}
    run = drv.done[0]
    assert run["pred"].shape == run["refined"].shape == run["first_w_t"].shape == (2, 32, 32, 40)
    assert len(run["history"]) == 13 and len(run["first_update"]) == 2
    assert run["pred"].dtype == run["refined"].dtype == torch.float64
    # each batch from its own frames
    assert not torch.equal(drv.inputs[0], drv.inputs[1])
    assert drv.inputs[0].shape == (2, 32, 32, 10)
    assert len(run["change"]) == 2
    assert drv.end_to_end(2.0, 3 * 2 ** 29) == {"train_samples_per_s": 36.0,
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


def test_a_config_that_is_not_the_examples_is_refused(small):
    cell, config = small
    with pytest.raises(ValueError, match="lr_bias"):
        harness.make_driver(cell, dict(config, lr_bias=0.1), 1, "cpu")
    with pytest.raises(ValueError, match="activation"):
        harness.make_driver(cell, dict(config, activation="GELU"), 1, "cpu")


def test_work_counts_by_hand():
    """At 8², 2 output steps, 1 latent step, modes 2/2/1 (SFNO) and 4/4/2
    (enlarged), width 2, expansion 2, 2 layers, 3 iterations: a plane's
    transform 2.5 · 64 · 6 = 960 operations and 64 · 8 + 40 · 16 = 1,152
    bytes; the padded latent (64 · 4 points) 2.5 · 256 · 8 = 5,120 and 2,048
    + 192 · 16 = 5,120 bytes; the conv's inverse (64 · 5 points) 2.5 · 320 ·
    log2 320 and 2,560 + 192 · 16 = 5,632 bytes; the enlarged contraction
    8 · 8 · 8 · 2 = 1,024."""
    work = harness.load_module("work", "refiner_fno256")
    cfg = dict(grid_size=8, out_steps=2, latent_steps=1, steps=2, modes=2, modes_t=1,
               modes_ft=[4, 4, 2], width=2, channel_expansion=2, num_layers=2, iters=3)
    inv = 2.5 * 320 * math.log2(320)
    conv = (5_120 + 1_024 + inv, 5_120 + 5_632)
    assert work.conv_forward(cfg, cfg["modes_ft"]) == pytest.approx(conv)
    (f_ops, f_bytes), (b_ops, b_bytes) = work.iteration(cfg)
    assert (f_ops, f_bytes) == pytest.approx((conv[0] + 40 * 960, conv[1] + 40 * 1_152))
    assert (b_ops, b_bytes) == pytest.approx((inv + 1_024 + 40 * 960, 5_632 + 40 * 1_152))
    ops, nbytes = work.refine_work(cfg, 2)
    assert ops == pytest.approx(2 * (3 * (f_ops + b_ops) + f_ops) + 4 * 960)
    assert nbytes == pytest.approx(2 * (3 * (f_bytes + b_bytes) + f_bytes) + 4 * 1_152)
    rec = SimpleNamespace(config=cfg, cell={"batch": 2}, counters={"units": 5},
                          peak_flops=1e9, peak_bytes=1e6,
                          ranges=SimpleNamespace(calls={"bench.refine": 3},
                                                 counts={"bench.refine": 6}))
    assert work.window_flops(rec) == pytest.approx(5 * work.unit_flops(cfg, 2))
    # bytes bind at 1e6 B/s, operations at 1e12
    assert work.refine_bound_s(rec) == pytest.approx(3 * nbytes / 1e6)
    rec.peak_bytes = 1e12
    assert work.refine_bound_s(rec) == pytest.approx(3 * ops / 1e9)
    rec.ranges.calls = {}
    assert work.refine_bound_s(rec) is None


def test_the_reference_imports_nothing_of_the_port():
    text = (BENCH / "reference" / "refiner.py").read_text()
    assert "tpu_cfd" not in text and "jax" not in text
    imported = [line.split()[1] for line in text.splitlines()
                if line.startswith(("import ", "from "))]
    assert not {m.split(".")[0] for m in imported} & set(harness.FORBIDDEN)


def test_the_configuration_states_the_examples_widths():
    config = json.loads((BENCH / "configs" / "refiner_fno256.json").read_text())
    assert (config["modes"], config["modes_t"], config["width"], config["num_layers"]) == (
        12, 5, 20, 4)
    assert (config["steps"], config["out_steps"], config["grid_size"]) == (10, 40, 256)
    assert config["modes_ft"] == [64, 64, 6] and config["iters"] == 50
    assert config["dtype"] == "float64"


def _refine_readings(events) -> dict:
    from benchmark import trace as tracing

    tr = tracing.Trace(events)
    rec = SimpleNamespace(trace=tr, ranges=SimpleNamespace(calls={"bench.refine": 1}),
                          work=SimpleNamespace(refine_bound_s=lambda r: 1e-7))
    return {name: harness.load_module("metrics", name).read(rec)
            for name in ("post_share", "refine_roofline")}


def test_the_ports_spans_leave_the_refine_readings_unchanged():
    """The port's ``ft.*`` spans sit in the same profiler session as the
    benchmark's ranges and move neither reader: a window of 1000 ns, a
    refine over 100-900 launching three kernels, the first two inside a
    ``bench.post``. The refine's device time is 200 + 200 + 100 ns, the
    post-process's 400 of it, the bound 100 ns."""
    from benchmark import trace as tracing
    from test_bench_harness import _Event as e

    bench = [
        e(tracing.WINDOW, 0, 1000, annotation=True),
        e("bench.refine", 100, 900, annotation=True),
        e("bench.post", 110, 300, annotation=True),
        e("cudaLaunchKernel", 120, 130, corr=1),
        e("cudaLaunchKernel", 200, 210, corr=2),
        e("cudaLaunchKernel", 400, 410, corr=3),
        e("k_post_a", 150, 350, cuda=True, corr=1),
        e("k_post_b", 350, 550, cuda=True, corr=2),
        e("k_backward", 600, 700, cuda=True, corr=3),
    ]
    ports = [
        e("ft.forward", 105, 109, annotation=True),
        e("ft.post", 110, 300, annotation=True),
        e("ft.backward", 390, 420, annotation=True),
        e("ft.record", 420, 430, annotation=True),
        e("ft.optimizer", 430, 890, annotation=True),
    ]
    plain = _refine_readings(bench)
    assert plain == pytest.approx({"post_share": 80.0, "refine_roofline": 20.0})
    for at in (0, 4, len(bench)):
        assert _refine_readings(bench[:at] + ports + bench[at:]) == plain

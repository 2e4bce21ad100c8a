"""The FNO dataset's cell, ``fno_forced256.gen_b256``, on the CPU at a small
size: added as files alone, correct, failed by each generation fault and by
its control, its work counted as worked by hand, and its new reader
(``explicit_share``) on a hand-made trace."""

import json
import time
from types import SimpleNamespace

import pytest

from benchmark import faults, harness
from benchmark import trace as tracing

from conftest import BENCH, ROOT
from test_bench_harness import _Event, _copy_checkout, _run_in

WORKLOAD = "fno_forced256.gen_b256"
# 32², 4 samples, 20 warm-up steps and 3 records 5 steps apart, every
# sample checked in blocks of 2: the program reads 1.2e-7 (vorticity) to
# 3e-6 (the time derivative), the TF32 control 1.8e-4 and more, the faults
# 1e-3 and more (test_torch_fno_forced_reference.py holds each field)
SMALL_CELL = dict(batch=4, check_block=2,
                  limits={"vorticity_rel_l2": 2e-5, "stream_rel_l2": 2e-5,
                          "vort_t_rel_l2": 5e-5, "residual_rel_l2": 5e-5})
SMALL_CONFIG = dict(grid_size=32, subsample=2, warmup_steps=20, recorded_steps=15,
                    record_every=5)


@pytest.fixture
def small():
    _, _, cell, config = harness.load_cell(WORKLOAD)
    return dict(cell, **SMALL_CELL), dict(config, **SMALL_CONFIG)


def test_the_cell_is_added_as_files_alone(tmp_path):
    """A copy of the checkout runs the cell, traced, from its cell,
    configuration, driver, work and metric files and its entries in
    BENCHMARK.json."""
    _copy_checkout(tmp_path)
    code = (
        "import json, time; from benchmark import harness\n"
        f"_, _, cell, config = harness.load_cell({WORKLOAD!r})\n"
        f"cell = dict(cell, **{SMALL_CELL!r})\n"
        f"config = dict(config, **{SMALL_CONFIG!r})\n"
        f"r = harness.run({WORKLOAD!r}, 2 ** 31 + 7, 0.5, True, time.perf_counter(),"
        " device='cpu', cell=cell, config=config)\n"
        "print(json.dumps(r))\n")
    out = _run_in(tmp_path, code)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"vorticity_rel_l2", "stream_rel_l2", "vort_t_rel_l2",
                                     "residual_rel_l2"}
    # the CPU has no device trace: the host-clock metric alone
    assert "step_mfu.fno_gen" in result["metrics"]
    assert f"benchmark: {WORKLOAD} seed {2 ** 31 + 7} route fft " in out.stderr
    assert "'bench.explicit'" in out.stderr and "'bench.solver'" in out.stderr


def test_the_cell_reports_its_metrics():
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    e2e = {m["name"] for m in harness.cell_metrics(bench, WORKLOAD, "end_to_end")}
    layers = {m["name"] for m in harness.cell_metrics(bench, WORKLOAD, "per_layer")}
    assert e2e == {"sample_steps_per_s", "setup_s"}
    assert layers == {f"{m}.fno_gen" for m in ("device_idle", "pipeline_share", "step_mfu",
                                               "rollout_roofline", "explicit_share")}
    # no metric of the other cells reads this one, nor this cell's theirs
    for w in ("mcwilliams256.gen_b32", "sfno_mcwilliams.train_b64"):
        assert not layers & {m["name"] for m in harness.cell_metrics(bench, w, "per_layer")}


@pytest.mark.parametrize("trace", [False, True])
def test_a_small_run_is_correct(small, trace):
    cell, config = small
    result = harness.run(WORKLOAD, 2 ** 33 + 1, 0.3, trace, time.perf_counter(),
                         device="cpu", cell=cell, config=config)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    if not trace:
        assert set(result["metrics"]) == {"sample_steps_per_s", "setup_s"}


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_each_generation_fault_makes_the_run_incorrect(small, fault):
    """The three generation faults, planted around this cell's driver
    (``faults.FAULTS`` is keyed by the ``generate`` driver's name)."""
    cell, config = small
    with faults.FAULTS["generate"][fault]():
        result = harness.run(WORKLOAD, 2 ** 32 + 3, 0.2, False, time.perf_counter(),
                             device="cpu", cell=cell, config=config)
    assert not result["correct"], result["checks"]


def test_the_control_fails_the_check(small):
    cell, config = small
    drv = harness.make_driver(cell, config, 41, "cpu")
    drv.unit()
    drv.release()
    assert all(v <= cell["limits"][k] for k, v in drv.compare().items())
    drv.use_control()
    assert any(v > cell["limits"][k] for k, v in drv.compare().items())


def test_work_counts_by_hand():
    """At 32²: a real transform of 1,024 points is 2.5 · 1,024 · 10 =
    25,600 operations; an explicit evaluation 5 of them, 3 · 1,024 for the
    product and 14 · 544 on the 32 · 17 modes, 138,688; a step two
    evaluations and 30 · 544, 293,696. At 256²: 28,523,008."""
    work = harness.load_module("work", "fno_forced256")
    assert work.modes(32) == 544
    assert work.sample_step_flops({"grid_size": 32}) == 293_696
    assert work.sample_step_flops({"grid_size": 256}) == 28_523_008
    rec = SimpleNamespace(
        config={"grid_size": 32}, cell={"batch": 4, "precision": "float32"},
        counters={"sample_steps": 10}, peak_flops=1e9, peak_bytes=1e6,
        ranges=SimpleNamespace(calls={"bench.solver": 3}, counts={"bench.solver": 8}))
    assert work.window_flops(rec) == 2_936_960
    # operations 8 · 293,696 / 1e9 s; bytes 2 · 3 calls · 4 samples · 544 ·
    # 8 B / 1e6 B/s: the bytes bind here
    assert work.rollout_bound_s(rec) == pytest.approx(max(8 * 293_696 / 1e9,
                                                          2 * 3 * 4 * 544 * 8 / 1e6))
    rec.ranges.calls = {}
    assert work.rollout_bound_s(rec) is None


def _solver_trace():
    """A window of 1000 ns: two solver calls, the first holding one explicit
    evaluation; an explicit evaluation outside any solver call (the
    recorder's residual); a copy outside both."""
    e = _Event
    return tracing.Trace([
        e(tracing.WINDOW, 0, 1000, annotation=True),
        e("bench.solver", 10, 100, annotation=True),
        e("bench.explicit", 20, 60, annotation=True),
        e("bench.solver", 300, 400, annotation=True),
        e("bench.explicit", 500, 550, annotation=True),
        e("cudaLaunchKernel", 25, 30, corr=1),
        e("cudaLaunchKernel", 40, 45, corr=2),
        e("cudaLaunchKernel", 70, 75, corr=3),
        e("cudaLaunchKernel", 310, 315, corr=4),
        e("cudaLaunchKernel", 510, 515, corr=5),
        e("cudaMemcpyAsync", 600, 601, corr=6),
        e("k_adv", 30, 130, cuda=True, corr=1),
        e("k_fft", 130, 160, cuda=True, corr=2),
        e("k_cn", 160, 170, cuda=True, corr=3),
        e("k_step", 320, 380, cuda=True, corr=4),
        e("k_residual", 520, 600, cuda=True, corr=5),
        e("Memcpy DtoH", 610, 700, cuda=True, corr=6),
    ])


def test_explicit_share_read_by_hand():
    """Device time in the solver calls 100 + 30 + 10 + 60 = 200 ns, of it
    launched in an explicit evaluation 130 ns: 65 %; the residual's
    evaluation outside the solver calls does not count."""
    tr = _solver_trace()
    reader = harness.load_module("metrics", "explicit_share.fno_gen")
    rec = SimpleNamespace(trace=tr, ranges=SimpleNamespace(calls={"bench.solver": 2}))
    assert reader.read(rec) == pytest.approx(65.0)
    # nothing to read: no solver call
    assert reader.read(SimpleNamespace(trace=tr, ranges=SimpleNamespace(calls={}))) is None


def test_the_reference_imports_nothing_of_the_port():
    text = (BENCH / "reference" / "fno_forced.py").read_text()
    assert "tpu_cfd" not in text and "jax" not in text

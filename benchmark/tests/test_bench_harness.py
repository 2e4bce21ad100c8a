"""The harness: everything found by name, a cell added as files alone, no
module of the JAX stack loaded, the trace's reading, and the faults."""

import json
import os
import shutil
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest

from benchmark import faults, harness
from benchmark import trace as tracing

from conftest import BENCH, ROOT


def _bench():
    return harness.load_json(ROOT / "BENCHMARK.json")


def test_every_name_resolves_to_its_files():
    bench = _bench()
    for config in bench["configs"]:
        assert (ROOT / config["file"]).exists()
        assert harness.load_module("work", config["name"])
    for w in bench["workloads"]:
        _, entry, cell, config = harness.load_cell(w["name"])
        assert cell["config"] == w["config"] == entry["config"]
        assert config["name"] == w["config"]
        assert hasattr(harness.load_module("drivers", cell["driver"]), "Driver")
        assert set(cell["limits"]), w["name"]
        reported = {m["name"] for m in harness.cell_metrics(bench, w["name"], "end_to_end")}
        assert "setup_s" in reported and len(reported) >= 2
        layers = harness.cell_metrics(bench, w["name"], "per_layer")
        assert layers and all(m["moves"] in reported for m in layers)
        for m in layers:
            assert callable(harness.load_module("metrics", m["name"]).read)


def test_metric_reader_falls_back_to_its_stem():
    assert harness.load_module("metrics", "device_idle.somewhere_new").read
    with pytest.raises(FileNotFoundError):
        harness.load_module("metrics", "no_such_metric.gen")


def test_only_end_to_end_metrics_without_workloads_join_every_cell():
    bench = {"end_to_end": [{"name": "setup_s"}, {"name": "rate", "workloads": ["a"]}],
             "per_layer": [{"name": "x", "moves": "rate"},
                           {"name": "z", "moves": "rate", "workloads": ["b"]}]}
    assert [m["name"] for m in harness.cell_metrics(bench, "a", "end_to_end")] == [
        "setup_s", "rate"]
    assert [m["name"] for m in harness.cell_metrics(bench, "b", "end_to_end")] == ["setup_s"]
    assert harness.cell_metrics(bench, "a", "per_layer") == []
    assert [m["name"] for m in harness.cell_metrics(bench, "b", "per_layer")] == ["z"]


@pytest.mark.parametrize("workload", ["mcwilliams256.gen_b32", "sfno_mcwilliams.train_b64"])
@pytest.mark.parametrize("trace", [False, True])
def test_a_small_run_is_correct(small, workload, trace, capsys):
    cell, config = small(workload)
    result = harness.run(workload, 2 ** 33 + 11, 0.3, trace, time.perf_counter(),
                         device="cpu", cell=cell, config=config)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    bench = _bench()
    section = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in harness.cell_metrics(bench, workload, section)}
    assert set(result["metrics"]) <= names
    if not trace:
        assert set(result["metrics"]) == names
    err = capsys.readouterr().err.strip().splitlines()
    assert all(line.startswith("check ") for line in err[-len(result["checks"]):])


FAULT_CASES = [(w, f) for w, kind in (("mcwilliams256.gen_b32", "generate"),
                                      ("sfno_mcwilliams.train_b64", "train"))
               for f in faults.FAULTS[kind]]


@pytest.mark.parametrize("workload,fault", FAULT_CASES)
def test_each_fault_makes_the_run_incorrect(small, workload, fault):
    cell, config = small(workload)
    with faults.FAULTS[cell["driver"]][fault]():
        result = harness.run(workload, 2 ** 32 + 3, 0.2, False, time.perf_counter(),
                             device="cpu", cell=cell, config=config)
    assert not result["correct"], result["checks"]


def test_a_float64_generation_cell_needs_only_a_cell_file(small):
    """Open question 4's fp64 generation on ``torch.fft``: a configuration
    that states the route's dealiasing (``nonlinear``) and a cell file with
    ``precision`` float64. The run is correct, and its control (the
    reference in fp32) reads far above the program."""
    cell, config = small("mcwilliams256.gen_b32")
    cell = dict(cell, batch=2, precision="float64")
    config = dict(config, dealias="nonlinear", work="mcwilliams256")
    result = harness.run("mcwilliams256.gen_b32", 77, 0.2, False, time.perf_counter(),
                         device="cpu", cell=cell, config=config)
    assert result["correct"], result["checks"]
    program = result["checks"]["records_rel_l2"]["value"]
    drv = harness.make_driver(cell, config, 77, "cpu")
    drv.unit()
    drv.release()
    own = drv.compare()["records_rel_l2"]
    drv.use_control()
    control = drv.compare()["records_rel_l2"]
    assert own < 1e-10 and program < 1e-10 < 1e-6 < control


def _copy_checkout(dst):
    """BENCHMARK.json, the benchmark and the port, as a checkout holds them."""
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    ignore = shutil.ignore_patterns("__pycache__", "*.pyc")
    shutil.copytree(BENCH, dst / "benchmark", ignore=ignore)
    shutil.copytree(ROOT / "tpu_cfd_torch", dst / "tpu_cfd_torch", ignore=ignore)


def _run_in(cwd, code):
    env = dict(os.environ, PYTHONPATH=str(cwd))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_a_cell_is_added_as_files_alone(tmp_path):
    """Open question 1's cell, the SFNO at the recipe's batch of 4, added by a
    cell file and entries in BENCHMARK.json only, runs in a copy of the
    checkout."""
    _copy_checkout(tmp_path)
    cell = json.loads((BENCH / "cells" / "sfno_mcwilliams.train_b64.json").read_text())
    cell.update(batch=4, slice_steps=32)
    (tmp_path / "benchmark" / "cells" / "sfno_mcwilliams.train_b4.json").write_text(
        json.dumps(cell))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "sfno_mcwilliams.train_b4", "config": "sfno_mcwilliams",
                               "traffic": "train_b4", "chips": 1, "why": "the recipe's batch"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "sfno_mcwilliams.train_b64" in m.get("workloads", []):
            m["workloads"].append("sfno_mcwilliams.train_b4")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json, time; from benchmark import harness\n"
        "_, _, cell, config = harness.load_cell('sfno_mcwilliams.train_b4')\n"
        "config = dict(config, grid_size=16, width=4, modes=8, modes_t=3, num_samples=16,"
        " num_val_samples=8, frames=30)\n"
        "cell = dict(cell, slice_steps=2)\n"
        "r = harness.run('sfno_mcwilliams.train_b4', 5, 0.5, True, time.perf_counter(),"
        " device='cpu', cell=cell, config=config)\n"
        "print(json.dumps(r))\n")
    out = _run_in(tmp_path, code)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert "step_mfu.train" in result["metrics"]
    assert "benchmark: sfno_mcwilliams.train_b4 seed 5 " in out.stderr


def test_no_module_of_the_jax_stack_is_loaded(tmp_path):
    """A run of each cell, in a process of its own, loads neither JAX nor the
    JAX package (top-level names compared whole: ``tpu_cfd_torch`` is not
    ``tpu_cfd``)."""
    code = (
        "import sys, time; sys.path.insert(0, 'benchmark/tests')\n"
        "from conftest import SMALL, _load\n"
        "from benchmark import harness\n"
        "for w, (co, fo) in SMALL.items():\n"
        "    cell = dict(_load('cells', w), **co)\n"
        "    config = dict(_load('configs', cell['config']), **fo)\n"
        "    harness.run(w, 9, 0.1, True, time.perf_counter(), device='cpu', cell=cell,"
        " config=config)\n"
        "import benchmark.calibrate, benchmark.faults\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "print(harness.forbidden_modules())\n")
    out = _run_in(ROOT, code)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded, found = out.stdout.strip().splitlines()[-2:]
    assert found == "[]"
    assert "'tpu_cfd_torch'" in loaded
    for name in harness.FORBIDDEN:
        assert f"'{name}'" not in loaded


def test_the_run_refuses_without_a_card_or_without_the_port(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "mcwilliams256.gen_b32", "--seed", "1", "--seconds", "1"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "mcwilliams256.gen_b32", "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()


class _Event:
    def __init__(self, name, start, end, cuda=False, corr=0, annotation=False):
        from torch.autograd import DeviceType
        self._v = (name, start, end, DeviceType.CUDA if cuda else DeviceType.CPU, corr,
                   annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


def test_the_trace_reading():
    """A window of 1000 ns: two kernels launched in ``bench.solver`` (and in
    ``bench.train`` inside it), one in ``bench.ic``, a copy launched outside
    any range; idle 100-200 and
    700-1000 while the host synchronises."""
    e = _Event
    events = [
        e(tracing.WINDOW, 0, 1000, annotation=True),
        e("bench.ic", 0, 40, annotation=True),
        e("bench.solver", 50, 90, annotation=True),
        e("bench.train", 55, 80, annotation=True),
        e("cudaLaunchKernel", 10, 15, corr=1),
        e("cudaLaunchKernel", 60, 65, corr=2),
        e("cudaLaunchKernel", 70, 75, corr=3),
        e("cudaMemcpyAsync", 95, 96, corr=4),
        e("cudaStreamSynchronize", 650, 1000),
        e("k_ic", 20, 100, cuda=True, corr=1),
        e("k_a", 200, 400, cuda=True, corr=2),
        e("k_b", 350, 600, cuda=True, corr=3),
        e("Memcpy DtoH", 600, 700, cuda=True, corr=4),
    ]
    tr = tracing.Trace(events)
    assert tr.launches == 3 and tr.matched == 4
    assert tr.busy_s() == pytest.approx((80 + 500) / 1e9)
    assert tr.device_s("bench.solver") == pytest.approx(450 / 1e9)
    assert tr.union_s("bench.solver") == pytest.approx(400 / 1e9)
    assert tr.device_s("bench.ic") == pytest.approx(80 / 1e9)
    assert tr.device_s("bench.none") == 0.0
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["k_b", 250 / 1e9]
    assert bd["idle_gaps"][0] == ["outside the benchmark's ranges > cudaStreamSynchronize",
                                  300 / 1e9]
    assert [g[1] for g in bd["idle_gaps"]] == [300 / 1e9, 100 / 1e9, 20 / 1e9]
    rec = SimpleNamespace(trace=tr, window_s=1000 / 1e9, ranges=SimpleNamespace(
        calls={"bench.solver": 1}), counters={"train_steps": 3})
    assert harness.load_module("metrics", "device_idle.gen").read(rec) == pytest.approx(42.0)
    assert harness.load_module("metrics", "pipeline_share.gen").read(rec) == pytest.approx(60.0)
    assert tr.launches_in("bench.train") == 2 and tr.launches_in("bench.eval") == 0
    assert harness.load_module("metrics", "launches_per_step.train").read(rec) == 2 / 3

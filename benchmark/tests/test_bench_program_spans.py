"""The program's own spans (``utils.trace_annotation``: ``solver.forward``,
``gen.record``, ``train.step`` and the rest) are user annotations in the
same profiler session as the benchmark's ranges. The trace's reading keeps
only the ``bench.*`` ranges, so every reader reads the same with and
without them."""

from types import SimpleNamespace

import pytest

from benchmark import harness
from benchmark import trace as tracing

from conftest import ROOT
from test_bench_harness import _Event

e = _Event

BENCH_EVENTS = [
    e(tracing.WINDOW, 0, 1000, annotation=True),
    e("bench.ic", 0, 40, annotation=True),
    e("bench.solver", 50, 90, annotation=True),
    e("bench.train", 55, 80, annotation=True),
    e("bench.ffn", 58, 68, annotation=True),
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

# the program's spans: inside the benchmark's ranges, beside them, and open
# over the idle gaps
PROGRAM_SPANS = [
    e("solver.forward", 52, 88, annotation=True),
    e("train.step", 56, 79, annotation=True),
    e("train.forward", 57, 66, annotation=True),
    e("train.backward", 66, 72, annotation=True),
    e("train.optimizer", 72, 78, annotation=True),
    e("Optimizer.step#Adam.step", 73, 77, annotation=True),
    e("gen.record", 90, 1000, annotation=True),
    e("gen.to_host", 94, 1000, annotation=True),
]


def _readings(events) -> dict:
    tr = tracing.Trace(events)
    rec = SimpleNamespace(
        trace=tr, window_s=1000 / 1e9, ranges=SimpleNamespace(calls={"bench.solver": 1}),
        counters={"train_steps": 3}, peak_flops=1e12,
        work=SimpleNamespace(rollout_bound_s=lambda r: 1e-7, ffn_bound_s=lambda r: 2e-8,
                             window_flops=lambda r: 1e2))
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    metrics = {m["name"]: harness.load_module("metrics", m["name"]).read(rec)
               for m in bench["per_layer"]}
    return {"ranges": tr.ranges, "launches": tr.launches, "matched": tr.matched,
            "kernels": tr.kernels, "busy_s": tr.busy_s(), "breakdown": tr.breakdown(),
            "metrics": metrics}


@pytest.mark.parametrize("at", [0, len(BENCH_EVENTS) // 2, len(BENCH_EVENTS)])
def test_program_spans_leave_every_reading_unchanged(at):
    plain = _readings(BENCH_EVENTS)
    assert all(v is not None for v in plain["metrics"].values())
    mixed = BENCH_EVENTS[:at] + PROGRAM_SPANS + BENCH_EVENTS[at:]
    assert _readings(mixed) == plain

"""The readers of the port's span log (``program_spans``:
``poisson_share.fvm``, ``combine_share.fvm``, ``step_launches.fvm``,
``solver_idle.gen``, ``record_idle.gen``) on a hand-made trace and log.

A window of 1000 ns. The host: the initial velocity's pressure solve
(5-15), two solver steps (100-400 with an explicit evaluation, a
combination and a projection holding a solve; 420-480 with a combination)
and a recorded chunk (800-950, its copy to the host nested in it). The
device: one operation for each launch, busy 270 ns in all."""

from types import SimpleNamespace

import pytest

from benchmark import harness
from benchmark import program_spans
from benchmark import trace as tracing
from tpu_cfd_torch.utils import profiling

from test_bench_harness import _Event

e = _Event

LOG = [
    ("solver.poisson", 5, 15, -1),
    ("solver.forward", 100, 400, -1),
    ("solver.explicit", 110, 150, 1),
    ("solver.combine", 150, 170, 1),
    ("solver.projection", 170, 300, 1),
    ("solver.poisson", 190, 250, 4),
    ("solver.forward", 420, 480, -1),
    ("solver.combine", 430, 440, 6),
    ("gen.record", 800, 950, -1),
    ("gen.to_host", 850, 950, 8),
]

# (launch call, its host start, the operation's device start and end, its name)
OPS = [
    ("cudaLaunchKernel", 8, 20, 50, "k_ic_solve"),
    ("cudaLaunchKernel", 120, 125, 185, "k_explicit"),
    ("cudaLaunchKernel", 160, 190, 210, "k_combine4"),
    ("cudaLaunchKernel", 180, 210, 230, "k_divergence"),
    ("cuLaunchKernel", 200, 230, 270, "fft_r2c"),
    ("cuLaunchKernel", 210, 280, 320, "fft_c2r"),
    ("cudaLaunchKernel", 260, 320, 340, "k_subtract_gradient"),
    ("cudaLaunchKernel", 435, 440, 450, "k_combine1"),
    ("cudaMemcpyAsync", 810, 900, 930, "Memcpy DtoH"),
]


def _trace():
    events = [e(tracing.WINDOW, 0, 1000, annotation=True)]
    for corr, (call, at, start, end, name) in enumerate(OPS, 1):
        events += [e(call, at, at + 2, corr=corr), e(name, start, end, cuda=True, corr=corr)]
    return tracing.Trace(events)


def _record():
    return SimpleNamespace(trace=_trace(), window_s=1000 / 1e9,
                           ranges=SimpleNamespace(calls={}), counters={})


@pytest.fixture
def log(monkeypatch):
    """``log(entries, dropped=(0, -1))`` makes the port's span log read so."""
    def use(entries, dropped=(0, -1)):
        monkeypatch.setattr(profiling, "span_log", lambda: list(entries))
        monkeypatch.setattr(profiling, "spans_dropped", lambda: dropped)
    return use


READERS = ("poisson_share.fvm", "combine_share.fvm", "step_launches.fvm",
           "solver_idle.gen", "record_idle.gen")


def _readings(rec) -> dict:
    return {name: harness.load_module("metrics", name).read(rec) for name in READERS}


# by hand: the steps' operations take 60+20+20+40+40+20 + 10 = 210 ns of
# device time; the solve's two transforms 80 (the initial velocity's solve,
# outside any step, is left out), the combinations 20 + 10; 7 launch calls
# in 2 steps; busy 125-185, 190-270, 280-340 in the first step (300 ns) and
# 440-450 in the second (60 ns): idle 100 + 50; in the recorded chunk
# (150 ns) busy 900-930: idle 120, its nested copy not counted twice
HAND = {"poisson_share.fvm": 100 * 80 / 210, "combine_share.fvm": 100 * 30 / 210,
        "step_launches.fvm": 3.5, "solver_idle.gen": 15.0, "record_idle.gen": 12.0}


def test_the_readings_by_hand(log):
    log(LOG)
    rec = _record()
    assert _readings(rec) == pytest.approx(HAND)
    device_idle = harness.load_module("metrics", "device_idle.gen").read(rec)
    assert device_idle == pytest.approx(73.0)
    assert HAND["solver_idle.gen"] + HAND["record_idle.gen"] <= device_idle


def test_solves_outside_a_step_are_left_out(log):
    """The initial velocity's solve (5-15) launched ``k_ic_solve``: in a
    ``solver.poisson`` span, in no step."""
    log(LOG)
    view = program_spans.window_trace(_record())
    assert view.ranges["solver.poisson"] == [(5, 15), (190, 250)]
    solves = view.in_range("solver.poisson")
    assert sorted(n for n, m in zip(view.op_name, solves) if m) == [
        "fft_c2r", "fft_r2c", "k_ic_solve"]
    assert _readings(_record())["poisson_share.fvm"] == pytest.approx(100 * 80 / 210)


def test_the_view_leaves_the_trace_as_it_was(log):
    """The readers read a copy: the benchmark's ranges, and so the
    breakdown's labels, stay the trace's own."""
    log(LOG)
    rec = _record()
    ranges = dict(rec.trace.ranges)
    _readings(rec)
    assert rec.trace.ranges == ranges and "solver.forward" not in ranges


@pytest.mark.parametrize("case", ["empty", "outside", "dropped", "open", "no_log"])
def test_nothing_to_read(log, monkeypatch, case):
    if case == "empty":
        log([])
    elif case == "outside":
        log([(name, start + 5000, end + 5000, parent) for name, start, end, parent in LOG])
    elif case == "dropped":
        log(LOG, dropped=(1, 999))
    elif case == "open":
        log([(name, start, -1, parent) for name, start, _, parent in LOG])
    else:
        monkeypatch.delattr(profiling, "span_log")
    assert _readings(_record()) == dict.fromkeys(READERS)


def test_a_drop_after_the_window_leaves_the_readings(log):
    log(LOG, dropped=(3, 1001))
    assert _readings(_record()) == pytest.approx(HAND)


def test_no_device_reads_nothing(log):
    """A CPU run's trace: no launch and no device operation."""
    log(LOG)
    rec = _record()
    rec.trace = tracing.Trace([e(tracing.WINDOW, 0, 1000, annotation=True)])
    assert _readings(rec) == dict.fromkeys(READERS)


def test_the_benchmarks_synthetic_record_reads_nothing(log):
    """The record of ``test_bench_program_spans.py``: no span log in its
    window."""
    from test_bench_program_spans import BENCH_EVENTS, PROGRAM_SPANS

    log([])
    rec = SimpleNamespace(trace=tracing.Trace(BENCH_EVENTS + PROGRAM_SPANS),
                          window_s=1000 / 1e9)
    assert _readings(rec) == dict.fromkeys(READERS)


def test_the_readers_are_listed_for_their_cells():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cells = {m["name"]: m["workloads"] for m in bench["per_layer"] if m["name"] in READERS}
    assert cells == {name: ["kolmogorov_fvm128.rollout_b512" if name.endswith(".fvm")
                            else "mcwilliams256.gen_b32"] for name in READERS}
    for name in READERS:
        assert harness.load_module("metrics", name).__file__.endswith(
            name.split(".")[0] + ".py")

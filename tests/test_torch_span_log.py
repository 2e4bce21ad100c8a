"""The program's span log (``utils.span_log``) and the FVM step's spans.

Imports only torch and the port, so the card runs it too
(``python -m pytest -m cuda --noconftest tests/test_torch_span_log.py``).
On the CPU: without a profiler a span is the shared no-op and logs nothing;
under ``utils.profile_to`` the log holds the Chrome trace's user annotations
in the same order and nesting, each logged interval holding its event; a
classic-RK4 step of ``NavierStokes2DFVMProjection`` at 32² in fp64 logs one
``solver.forward`` holding four each of ``solver.explicit``,
``solver.combine`` and ``solver.projection``, one ``solver.poisson`` in each
projection, and steps bit for bit as it does without a profiler; the
example's initial velocity logs its three solves outside any step; the log
drops and counts the spans past its cap. On the card (``@pytest.mark.cuda``,
skipped without one): the same step on the kernel route logs the same tree.
"""

import contextlib
import glob
import json
import os
import time

import pytest
import torch

from tpu_cfd_torch.examples import ex1_kolmogorov_fvm as ex
from tpu_cfd_torch.ops.cuda import fvm_projection
from tpu_cfd_torch.utils import (clear_span_log, profile_to, profiling, span_log,
                                 spans_dropped, trace_annotation)

torch.set_num_threads(2)

STEP_CHILDREN = ["solver.explicit", "solver.combine", "solver.projection"] * 4


@pytest.fixture(autouse=True)
def _empty_log():
    clear_span_log()
    yield
    clear_span_log()


def _chrome_spans(log_dir) -> list:
    """``(name, start_ns, end_ns)`` of every user annotation in the one
    Chrome trace in ``log_dir``, on the profiler's clock, in start order."""
    (path,) = glob.glob(os.path.join(log_dir, "*.json"))
    with open(path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    spans = [(e["name"], base + round(e["ts"] * 1000), base + round((e["ts"] + e["dur"]) * 1000))
             for e in trace["traceEvents"]
             if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    return sorted(spans, key=lambda s: (s[1], -s[2]))


def _children(log, i) -> list:
    return [name for name, _, _, parent in log if parent == i]


def test_no_profiler_logs_nothing():
    span = trace_annotation("a")
    assert span is trace_annotation("b")
    assert isinstance(span, contextlib.nullcontext)
    with span, trace_annotation("c"):
        torch.ones(3).sum()
    assert span_log() == []
    assert spans_dropped() == (0, -1)


def test_log_holds_the_traces_annotations(tmp_path):
    """Four spans, two nested in the first; each long enough that its clock
    reads lie well inside it."""
    with profile_to(str(tmp_path)) as d:
        with trace_annotation("t.outer"):
            time.sleep(2e-3)
            with trace_annotation("t.inner"):
                time.sleep(2e-3)
            with trace_annotation("t.second"):
                time.sleep(2e-3)
        with trace_annotation("t.after"):
            time.sleep(2e-3)
    log = span_log()
    assert [(name, parent) for name, _, _, parent in log] == [
        ("t.outer", -1), ("t.inner", 0), ("t.second", 0), ("t.after", -1)]
    events = _chrome_spans(d)
    assert [e[0] for e in events] == [e[0] for e in log]
    for (name, start, end, parent), (_, t0, t1) in zip(log, events):
        assert start < end
        overlap = min(end, t1) - max(start, t0)
        assert overlap > 0.5 * (end - start) and overlap > 0.5 * (t1 - t0), name
        if parent >= 0:
            assert log[parent][1] <= start and end <= log[parent][2]


def _check_step_tree(log):
    (forward,) = [i for i, e in enumerate(log) if e[0] == "solver.forward"]
    assert log[forward][3] == -1
    assert _children(log, forward) == STEP_CHILDREN
    projections = [i for i, e in enumerate(log) if e[0] == "solver.projection"]
    assert len(projections) == 4
    for i in projections:
        assert _children(log, i) == ["solver.poisson"]
    assert len(log) == 17
    assert all(e[1] < e[2] for e in log)


def test_fvm_step_spans(tmp_path):
    v0, eqn, dt = ex.build(32, torch.float64, "cpu")
    plain = eqn.forward(v0, dt)
    with profile_to(str(tmp_path)):
        traced = eqn.forward(v0, dt)
    _check_step_tree(span_log())
    for a, b in zip(plain, traced):
        assert torch.equal(a.data, b.data)


def test_initial_condition_solves_lie_outside_any_step(tmp_path):
    with profile_to(str(tmp_path)):
        ex.build(32, torch.float64, "cpu")
    log = span_log()
    assert [(name, parent) for name, _, _, parent in log] == [("solver.poisson", -1)] * 3


def test_log_drops_and_counts_past_its_cap(tmp_path, monkeypatch):
    monkeypatch.setattr(profiling, "SPAN_LOG_CAP", 3)
    with profile_to(str(tmp_path)):
        with trace_annotation("c.0"):
            with trace_annotation("c.1"):
                pass
        with trace_annotation("c.2"):
            pass
        t = time.time_ns()
        with trace_annotation("c.3"):
            with trace_annotation("c.4"):
                pass
    assert [e[0] for e in span_log()] == ["c.0", "c.1", "c.2"]
    count, first = spans_dropped()
    assert count == 2 and t <= first <= time.time_ns()
    clear_span_log()
    assert span_log() == [] and spans_dropped() == (0, -1)


def test_clear_inside_a_span_leaves_its_children_without_parent(tmp_path):
    with profile_to(str(tmp_path)):
        with trace_annotation("o"):
            clear_span_log()
            with trace_annotation("i"):
                pass
            assert span_log()[0][2] != -1
            with trace_annotation("open"):
                assert span_log()[-1][2] == -1
    assert [(e[0], e[3]) for e in span_log()] == [("i", -1), ("open", -1)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "python -m pytest -m cuda --noconftest tests/test_torch_span_log.py)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_fvm_step_spans_on_the_kernel_route(card, tmp_path):
    """The same tree where the combination and the projection's stencils
    are kernels: four ``combine``, ``divergence`` and ``subtract_gradient``
    launches a step."""
    v0, eqn, dt = ex.build(32, torch.float64, card, batch=2)
    plain = eqn.forward(v0, dt)
    torch.cuda.synchronize()
    fvm_projection.reset_launch_counts()
    with profile_to(str(tmp_path)):
        traced = eqn.forward(v0, dt)
    _check_step_tree(span_log())
    assert fvm_projection.LAUNCHES == {"combine": 4, "divergence": 4, "subtract_gradient": 4}
    for a, b in zip(plain, traced):
        assert torch.equal(a.data, b.data)

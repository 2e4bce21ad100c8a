"""The program's spans (``utils.trace_annotation``) on the CPU.

Without a profiler a span is one shared no-op context. Under
``utils.profile_to`` the Chrome trace holds each span as a user annotation:
``solver.forward`` for every solver call, ``gen.record`` and the nested
``gen.to_host`` for every recorded chunk, ``train.step`` holding
``train.forward``, ``train.backward`` and ``train.optimizer``,
``train.gather`` for each step's window and ``train.eval`` for each
validation batch; ``solver.explicit`` and ``solver.implicit`` for each
explicit evaluation and implicit solve of an IMEX step, ``gen.extra_vars``
for each chunk that records fields beyond the vorticity. A run under the
profiler gives the bits of the same run without one.
"""

import contextlib
import glob
import json
import os

import numpy as np
import pytest
import torch

from tpu_cfd_torch import grids
from tpu_cfd_torch.data import generate
from tpu_cfd_torch.models import SFNO
from tpu_cfd_torch.solvers import equations, forcings
from tpu_cfd_torch.train import losses, pipeline
from tpu_cfd_torch.utils import profile_to, trace_annotation

torch.set_num_threads(2)

PROGRAM_SPANS = {"solver.forward", "gen.record", "gen.to_host", "train.gather",
                 "train.step", "train.forward", "train.backward", "train.optimizer",
                 "train.eval"}


def _spans(log_dir) -> list:
    """``(name, start, end)`` of every user annotation in the one Chrome
    trace that ``profile_to`` wrote into ``log_dir``, in µs."""
    (path,) = glob.glob(os.path.join(log_dir, "*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("cat") == "user_annotation" and e.get("ph") == "X")


def _named(spans, name) -> list:
    return [s for s in spans if s[0] == name]


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_trace_annotation_is_shared_no_op_without_profiler(tmp_path):
    off = trace_annotation("a")
    assert off is trace_annotation("b")
    assert isinstance(off, contextlib.nullcontext)
    with off, off:  # the shared context nests
        pass
    with profile_to(str(tmp_path)) as d:
        on = trace_annotation("test.span")
        assert isinstance(on, torch.autograd.profiler.record_function)
        with on:
            torch.ones(3).sum()
    assert trace_annotation("c") is off
    assert len(_named(_spans(d), "test.span")) == 1


def _generate(n=32, batch=2):
    grid = grids.Grid((n, n), domain=((0, 2 * np.pi), (0, 2 * np.pi)))
    ns2d = equations.NavierStokes2DSpectral(viscosity=1e-3, grid=grid, fft_impl="fft",
                                            dtype=torch.float32, device="cpu")
    # warm-up of 3 steps in one call, then 4 records 2 steps apart in two
    # chunks of 2: five solver calls
    run = generate.make_batch_pipeline(ns2d, 1e-3, 3, 7, 2, n // 2,
                                       max_steps_per_program=4)
    w0 = torch.randn(batch, n, n, generator=torch.Generator().manual_seed(0))
    return run(torch.fft.rfft2(w0))["vorticity"]


def test_generation_batch_spans(tmp_path):
    plain = _generate()
    with profile_to(str(tmp_path)) as d:
        traced = _generate()
    np.testing.assert_array_equal(traced, plain)
    spans = _spans(d)
    assert len(_named(spans, "solver.forward")) == 5
    records, copies = _named(spans, "gen.record"), _named(spans, "gen.to_host")
    assert len(records) == len(copies) == 2
    for rec, copy in zip(records, copies):
        assert _inside(copy, rec)
    # the chunk's solver calls come before its recorder
    assert all(s[2] <= records[0][1] for s in _named(spans, "solver.forward")[:3])


IMEX_SPANS = {"solver.explicit", "solver.implicit", "gen.extra_vars"}


def _imex_generate(order=2, fields=("vorticity", "stream", "vort_t", "residual"), n=32):
    """The FNO dataset's solver (IMEX, SinCos forcing) at ``n``²: one step
    as warm-up, then 2 records 2 steps apart in one chunk of ``fields``."""
    grid = grids.Grid((n, n), domain=((0, 1.0), (0, 1.0)))
    forcing = forcings.SinCosForcing(grid=grid, scale=0.1, diam=1.0, vorticity=True)
    ns2d = equations.NavierStokes2DSpectral(
        viscosity=1e-3, grid=grid, forcing_fn=forcing,
        solver=equations.IMEXStepper(order=order), fft_impl="fft",
        dtype=torch.float32, device="cpu")
    run = generate.make_batch_pipeline(ns2d, 1e-3, 1, 3, 2, n // 2, fields=fields)
    w0 = torch.randn(2, n, n, generator=torch.Generator().manual_seed(3))
    return run(torch.fft.rfft2(w0))


@pytest.mark.parametrize("order,per_step", [(2, 2), (1.5, 1), (1, 1)])
def test_imex_step_spans(tmp_path, order, per_step):
    """Each IMEX step opens ``solver.explicit`` and ``solver.implicit`` once
    an evaluation and a solve (order 2: twice each), inside its
    ``solver.forward``; 1 + 1 + 2 steps."""
    plain = _imex_generate(order)
    with profile_to(str(tmp_path)) as d:
        traced = _imex_generate(order)
    for k in plain:
        np.testing.assert_array_equal(traced[k], plain[k])
    spans = _spans(d)
    forwards = _named(spans, "solver.forward")
    assert len(forwards) == 3
    for name in ("solver.explicit", "solver.implicit"):
        inner = _named(spans, name)
        assert len(inner) == 4 * per_step
        assert all(any(_inside(s, f) for f in forwards) for s in inner)


def test_extra_fields_span(tmp_path):
    """A chunk that records the stream function, ∂ω/∂t and the residual
    opens one ``gen.extra_vars`` inside its ``gen.record``; a vorticity-only
    chunk opens none."""
    with profile_to(str(tmp_path / "extra")) as d:
        _imex_generate()
    spans = _spans(d)
    (extra,), (record,) = _named(spans, "gen.extra_vars"), _named(spans, "gen.record")
    assert _inside(extra, record)
    with profile_to(str(tmp_path / "plain")) as d:
        _imex_generate(fields=("vorticity",))
    assert not _named(_spans(d), "gen.extra_vars")


def test_rk4_cn_and_vorticity_records_open_no_imex_span(tmp_path):
    """The low-storage RK4-CN steps and a vorticity-only recorder open none
    of the IMEX and extra-field spans."""
    with profile_to(str(tmp_path)) as d:
        _generate()
    names = {s[0] for s in _spans(d)}
    assert "solver.forward" in names and not names & IMEX_SPANS


def _train(n=16, frames=12, steps=4, batch=2):
    torch.manual_seed(0)
    model = SFNO(modes_x=4, modes_y=4, modes_t=3, width=4, num_spectral_layers=2,
                 latent_steps=steps, output_steps=steps)
    data = torch.randn(6, n, n, frames, generator=torch.Generator().manual_seed(1))
    loss = losses.SobolevLoss(n_grid=n, norm_order=0, relative=True)
    optimizer = pipeline.get_optimizer("adam", model.parameters(), 1e-3)
    scheduler = pipeline.onecycle_lr(optimizer, 1e-3, 2, 1)
    run = pipeline.make_device_epoch(model, loss, optimizer, data, steps, steps,
                                     scheduler, grad_clip=1.0)
    evaluate = pipeline.make_device_eval(model, loss, data, steps, steps,
                                         model_out_steps=steps)
    idx, starts = np.array([[0, 1], [2, 3]]), np.array([[0, 4], [2, 1]])
    out = run(idx, starts)
    with torch.no_grad():
        val = evaluate(np.array([[4, 5], [0, 2]]), np.array([[0, 3], [1, 4]]))
    return out, val, [p.detach().clone() for p in model.parameters()]


def test_training_epoch_and_eval_spans(tmp_path):
    plain = _train()
    with profile_to(str(tmp_path)) as d:
        traced = _train()
    assert torch.equal(traced[0], plain[0]) and torch.equal(traced[1], plain[1])
    assert all(torch.equal(a, b) for a, b in zip(traced[2], plain[2]))
    spans = _spans(d)
    assert {s[0] for s in spans} >= PROGRAM_SPANS - {"solver.forward", "gen.record",
                                                     "gen.to_host"}
    step_spans = _named(spans, "train.step")
    assert len(step_spans) == 2 and len(_named(spans, "train.gather")) == 2
    for phase in ("train.forward", "train.backward", "train.optimizer"):
        inner = _named(spans, phase)
        assert len(inner) == 2
        assert all(_inside(s, step) for s, step in zip(inner, step_spans))
    # each step's phases in order
    for k in range(2):
        f, b, o = (_named(spans, p)[k] for p in
                   ("train.forward", "train.backward", "train.optimizer"))
        assert f[2] <= b[1] and b[2] <= o[1]
    # one gather before each step, none inside it
    for g, step in zip(_named(spans, "train.gather"), step_spans):
        assert g[2] <= step[1]
    assert len(_named(spans, "train.eval")) == 2


@pytest.mark.parametrize("fn", [_generate, _train, _imex_generate])
def test_no_spans_outside_profiler(fn, monkeypatch):
    """Without a profiler no span of the program reaches ``record_function``
    (torch's optimizer opens its own ranges whatever the profiler)."""
    calls = []

    class Counting(torch.autograd.profiler.record_function):
        def __init__(self, name, args=None):
            calls.append(name)
            super().__init__(name, args)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counting)
    fn()
    assert not (PROGRAM_SPANS | IMEX_SPANS) & set(calls)

"""Faults planted in the timed path, to show that a cell's check fails them.

Each is a context manager that patches the port for as long as it is open,
by the kind of driver (``drivers/<kind>.py``): a step that returns its
state unchanged, half of the batch left out, and an answer altered where it
is produced (in training also one altered only in the calls after
set-up's). One chip holds the whole of each cell, so no exchange between
chips can be left out. ``benchmark/calibrate.py`` reads them on the chip;
``benchmark/tests/`` shows on the CPU that each makes ``correct`` false.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


@contextlib.contextmanager
def patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


# --- generation --------------------------------------------------------------

def gen_unchanged():
    """The solver's step returns the state it was given."""
    from tpu_cfd_torch.solvers.equations import NavierStokes2DSpectral

    return patched(NavierStokes2DSpectral, "forward",
                   lambda self, w, dt, steps=1: (w, torch.zeros_like(w)))


def _wrap_pipeline(edit):
    from tpu_cfd_torch.data import generate

    inner = generate.make_batch_pipeline

    def make(*args, **kwargs):
        pipe = inner(*args, **kwargs)
        return lambda w: edit(w, pipe)

    return patched(generate, "make_batch_pipeline", make)


def gen_half_batch():
    """Only the first half of each batch is rolled out; the rest of the
    batch gets the mean of those records."""
    def edit(w, pipe):
        half = max(1, w.shape[0] // 2)
        out = pipe(w[:half])
        return {k: np.concatenate([v, np.repeat(v.mean(axis=0, keepdims=True),
                                                w.shape[0] - half, axis=0)])
                for k, v in out.items()}
    return _wrap_pipeline(edit)


def gen_altered():
    """One sample's records come out shifted by one grid cell."""
    def edit(w, pipe):
        out = pipe(w)
        for v in out.values():
            v[0] = np.roll(v[0], 1, axis=-1)
        return out
    return _wrap_pipeline(edit)


# --- training ----------------------------------------------------------------

def train_unchanged():
    """The optimizer's step leaves the parameters and its state as they are."""
    return patched(torch.optim.Adam, "step", lambda self, closure=None: None)


def train_half_batch():
    """Each step gathers and trains on the first half of its batch alone, the
    loss the mean over that half."""
    from tpu_cfd_torch.train import pipeline

    inner = pipeline._window_gather

    def gather_half(data, steps, out_steps):
        gather = inner(data, steps, out_steps)

        def half(idx, starts):
            keep = max(1, idx.shape[0] // 2)
            return gather(idx[:keep], starts[:keep])
        return half

    return patched(pipeline, "_window_gather", gather_half)


def train_altered():
    """The model's prediction comes out scaled by 1 + 1e-3."""
    from tpu_cfd_torch.models import SFNO

    inner = SFNO.forward
    return patched(SFNO, "forward", lambda self, *a, **k: inner(self, *a, **k) * (1 + 1e-3))


def train_altered_after_setup():
    """From the second call of an epoch's ``run`` on, the calls that the
    window makes after set-up's one, the model's prediction comes out scaled
    by 1 + 1e-3: a path that goes wrong only once warmed up."""
    from tpu_cfd_torch.train import pipeline

    inner = pipeline.make_device_epoch

    def make(*args, **kwargs):
        run = inner(*args, **kwargs)
        calls = []

        def later(idx, starts):
            calls.append(1)
            if len(calls) == 1:
                return run(idx, starts)
            with train_altered():
                return run(idx, starts)
        return later

    return patched(pipeline, "make_device_epoch", make)


FAULTS = {
    "generate": {"unchanged": gen_unchanged, "half_batch": gen_half_batch,
                 "altered": gen_altered},
    "train": {"unchanged": train_unchanged, "half_batch": train_half_batch,
              "altered": train_altered, "altered_after_setup": train_altered_after_setup},
}

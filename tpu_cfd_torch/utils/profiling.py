"""Profiling helpers: ``torch.profiler`` traces, named spans and the
device's live tensors.

Counterpart of ``tpu_cfd/utils/profiling.py``. A trace is a Chrome trace
(Perfetto, ``chrome://tracing``) with each kernel's device time when a card
is in use, and the program's spans (``trace_annotation``) on the same clock.
While a profiler session is enabled, every span is also kept in an
in-process log (``span_log``), stamped on the clock of the profiler's
events, so that a reader can join it with the trace's device operations
without a Chrome trace.
"""

from __future__ import annotations

import contextlib
import gc
import os
import tempfile
import threading
import time

import torch


@contextlib.contextmanager
def profile_to(log_dir: str = None):
    """Traces the enclosed block and writes ``trace_<pid>_<k>.json`` into
    ``log_dir`` (default: ``tpu_cfd_torch_trace`` in the temporary
    directory; ``k`` the clock in ns). CPU activity always; CUDA activity
    when a card is in use. Yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "tpu_cfd_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_initialized():
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()  # the trace starts on an idle device
    with profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


# where torch lacks the query, every span records
_profiler_enabled = getattr(torch._C._autograd, "_profiler_enabled", None)
_NO_SPAN = contextlib.nullcontext()

# the span log: entries [name, start_ns, end_ns, parent entry or None] in
# the order the spans opened; the spans open on each thread; the spans
# dropped past the cap, and the start of the first of them
SPAN_LOG_CAP = 1 << 20
_log = []
_open = threading.local()
_dropped = [0, -1]


class _LoggedSpan(torch.autograd.profiler.record_function):
    """A ``record_function`` range that also logs itself, on the clock the
    profiler maps its events onto (``time.time_ns``, the realtime clock of
    ``c10::getTime``). The range stamps its start and end inside its entry
    and exit calls (each ~9 µs under a profiler on an H100's host): the
    start about halfway through the entry, the end about three quarters of
    the way through the exit (47 % and 74 % there with torch 2.11, 43 % and
    81 % on a CPU-only host with torch 2.13). The log takes those points
    between the clock reads around each call, so both intervals hold the
    same launches."""

    def __enter__(self):
        before = time.time_ns()
        super().__enter__()
        start = (before + time.time_ns()) // 2
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        if len(_log) < SPAN_LOG_CAP:
            entry = [self.name, start, -1, stack[-1] if stack else None]
            _log.append(entry)
        else:
            entry = None
            if not _dropped[0]:
                _dropped[1] = start
            _dropped[0] += 1
        stack.append(entry)
        return self

    def __exit__(self, *exc):
        entry = _open.stack.pop()
        before = time.time_ns()
        out = super().__exit__(*exc)
        if entry is not None:
            entry[2] = before + 3 * (time.time_ns() - before) // 4
        return out


def trace_annotation(name: str):
    """A named span of the program: a ``record_function`` range while a torch
    profiler session is enabled (``torch.profiler.profile``, so
    ``profile_to``), which the trace keeps beside the device activity on
    the profiler's clock, and one entry of ``span_log``. Otherwise one
    shared no-op context: an ungated ``record_function`` calls a torch
    operator on entry and exit even with no profiler running, over ten
    times the cost of the check."""
    if _profiler_enabled is None or _profiler_enabled():
        return _LoggedSpan(name)
    return _NO_SPAN


def span_log() -> list:
    """The spans logged since the last ``clear_span_log``, in the order they
    opened: ``(name, start_ns, end_ns, parent)``, times in ns of the
    profiler's clock (the ``start_ns()``/``end_ns()`` of its events),
    ``end_ns`` -1 for a span still open, ``parent`` the index of the span
    open around it on its thread, or -1. At most ``SPAN_LOG_CAP`` entries:
    ``spans_dropped`` counts the spans past the cap."""
    index = {id(e): i for i, e in enumerate(_log)}
    return [(name, start, end, -1 if parent is None else index.get(id(parent), -1))
            for name, start, end, parent in _log]


def spans_dropped() -> tuple:
    """``(count, start_ns)``: the spans the full log dropped since the last
    ``clear_span_log``, and the start of the first of them (-1 if none)."""
    return tuple(_dropped)


def clear_span_log() -> None:
    """Empties the log and its count of dropped spans."""
    _log.clear()
    _dropped[:] = [0, -1]


def device_memory_summary(device=None) -> str:
    """One line per live tensor on ``device`` (default: the card when one is
    in use, else the CPU), and their total, counting shared storage once."""
    if device is None:
        device = "cuda" if torch.cuda.is_initialized() else "cpu"
    device_type = torch.device(device).type
    lines, storages = [], {}
    for obj in gc.get_objects():
        # type(), not isinstance(): the latter reads __class__, which some
        # lazily deprecated objects answer with a warning
        if not issubclass(type(obj), torch.Tensor) or obj.device.type != device_type:
            continue
        nbytes = obj.numel() * obj.element_size()
        storage = obj.untyped_storage()
        storages[(str(obj.device), storage.data_ptr())] = storage.nbytes()
        lines.append(f"{str(obj.dtype):>16} {str(tuple(obj.shape)):>24} "
                     f"{nbytes / 2 ** 20:10.3f} MB")
    total = sum(storages.values())
    lines.append(f"{'total':>41} {total / 2 ** 20:10.3f} MB across {len(lines)} "
                 f"tensors on {device_type}")
    return "\n".join(lines)

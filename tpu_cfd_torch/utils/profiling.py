"""Profiling helpers: ``torch.profiler`` traces, named spans and the
device's live tensors.

Counterpart of ``tpu_cfd/utils/profiling.py``. A trace is a Chrome trace
(Perfetto, ``chrome://tracing``) with each kernel's device time when a card
is in use, and the program's spans (``trace_annotation``) on the same clock.
"""

from __future__ import annotations

import contextlib
import gc
import os
import tempfile
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


def trace_annotation(name: str):
    """A named span of the program: a ``record_function`` range while a torch
    profiler session is enabled (``torch.profiler.profile``, so
    ``profile_to``), which the trace keeps beside the device activity on
    the profiler's clock. Otherwise one shared no-op context: an ungated
    ``record_function`` calls a torch operator on entry and exit even with
    no profiler running, over ten times the cost of the check."""
    if _profiler_enabled is None or _profiler_enabled():
        return torch.autograd.profiler.record_function(name)
    return _NO_SPAN


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

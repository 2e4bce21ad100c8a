"""The benchmark's own tracing: named host ranges and a reading of the
profiler's trace.

``Ranges`` puts ``record_function`` ranges around calls into the port from
the benchmark's files (a wrapped method of one instance, or hooks on a
module), and counts the calls and the work each carries; it does nothing in
an untraced run. ``Session`` profiles the measured window with
``torch.profiler`` (CPU and CUDA activities) and reads the raw events,
without building the profiler's own tables. Device operations are given to
the range their launch fell in, by the launch's correlation id, so a range
reads the same work whichever kernels a later change runs in it.
"""

from __future__ import annotations

import bisect
import contextlib
import types
from collections import defaultdict

import numpy as np
import torch

WINDOW = "bench.window"


class Ranges:
    """Named host ranges around calls into the port, on while tracing."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.calls = defaultdict(int)
        self.counts = defaultdict(int)

    def reset(self) -> None:
        self.calls.clear()
        self.counts.clear()

    def range(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        return torch.autograd.profiler.record_function(name)

    def wrap_method(self, obj, attr: str, name: str, count=None) -> None:
        """Wraps ``obj.attr`` on that instance alone; ``count(*args)`` is the
        work a call carries."""
        if not self.enabled:
            return
        inner = getattr(obj, attr)

        def wrapped(_obj, *args, **kwargs):
            self.calls[name] += 1
            if count is not None:
                self.counts[name] += count(*args, **kwargs)
            with torch.autograd.profiler.record_function(name):
                return inner(*args, **kwargs)

        setattr(obj, attr, types.MethodType(wrapped, obj))

    def wrap_module(self, module, name: str, count=None) -> None:
        """A range around each forward of ``module``, by hooks;
        ``count(input)`` is the work a call carries."""
        if not self.enabled:
            return
        open_ranges = []

        def enter(mod, args):
            self.calls[name] += 1
            if count is not None:
                self.counts[name] += count(args[0])
            r = torch.autograd.profiler.record_function(name)
            r.__enter__()
            open_ranges.append(r)

        def leave(mod, args, out):
            open_ranges.pop().__exit__(None, None, None)

        module.register_forward_pre_hook(enter)
        module.register_forward_hook(leave)


_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
             "cuLaunchKernelEx", "cudaLaunchCooperativeKernel", "cudaGraphLaunch")


def _is_runtime(name: str) -> bool:
    return name.startswith("cuda") or name.startswith("cuLaunch") or name.startswith("cuMem")


class Session:
    """The profiler over the measured window, and its reading.

    It records device activity, the runtime's launch calls and the
    benchmark's ranges (``record_function``'s user scope) but not every
    PyTorch operation: recording those doubles a host-bound step's time,
    which would show in the idle share and the rates read from the trace.
    """

    def __init__(self, cuda: bool = True):
        from torch._C._profiler import ProfilerActivity, RecordScope, _ExperimentalConfig
        from torch.autograd import ProfilerConfig, ProfilerState

        self.cuda = cuda
        self.config = ProfilerConfig(ProfilerState.KINETO, False, False, False, False,
                                     False, _ExperimentalConfig())
        self.activities = {ProfilerActivity.CPU} | ({ProfilerActivity.CUDA} if cuda else set())
        self.scopes = {RecordScope.USER_SCOPE}
        self._window = self.result = None

    def __enter__(self):
        from torch.autograd import _enable_profiler, _prepare_profiler

        _prepare_profiler(self.config, self.activities)
        _enable_profiler(self.config, self.activities, self.scopes)
        self._window = torch.autograd.profiler.record_function(WINDOW)
        self._window.__enter__()
        return self

    def __exit__(self, *exc):
        from torch.autograd import _disable_profiler

        self._window.__exit__(None, None, None)
        if self.cuda:
            torch.cuda.synchronize()
        self.result = _disable_profiler()
        return False

    def read(self) -> "Trace":
        return Trace(self.result.events())


class Trace:
    """Device operations, launches and ranges of one profiled window, times
    in ns of the profiler's clock."""

    def __init__(self, events):
        from torch.autograd import DeviceType

        ops, launch_at, ranges, host = [], {}, defaultdict(list), []
        for e in events:
            name = e.name()
            start, end = e.start_ns(), e.end_ns()
            if e.device_type() == DeviceType.CUDA:
                if not e.is_user_annotation():
                    ops.append((start, end, name, e.correlation_id()))
            elif e.is_user_annotation():
                if name.startswith("bench."):
                    ranges[name].append((start, end))
            else:
                host.append((start, end, name))
                if _is_runtime(name):
                    launch_at[e.correlation_id()] = start
        window = ranges.pop(WINDOW, [])
        self.window_start, self.window_end = window[0] if window else (0, 0)
        ops.sort()
        self.op_start = np.array([o[0] for o in ops], dtype=np.int64)
        self.op_end = np.array([o[1] for o in ops], dtype=np.int64)
        self.op_name = [o[2] for o in ops]
        self.op_launch = np.array([launch_at.get(o[3], -1) for o in ops], dtype=np.int64)
        self.ranges = {k: sorted(v) for k, v in ranges.items()}
        self.host = host
        lo, hi = self.window_start, self.window_end
        self.launch_times = np.array(sorted(s for s, _, n in host if n in _LAUNCHES
                                            and lo <= s <= hi), dtype=np.int64)
        self.launches = len(self.launch_times)
        self.matched = int((self.op_launch >= 0).sum())
        self.kernels = sum(1 for n in self.op_name if not n.startswith(("Memcpy", "Memset")))

    # --- the device's timeline ---------------------------------------------
    def _union(self, mask=None):
        """Disjoint intervals covered by the (masked) operations, clipped to
        the window."""
        s, e = self.op_start, self.op_end
        if mask is not None:
            s, e = s[mask], e[mask]
        s = np.clip(s, self.window_start, self.window_end)
        e = np.clip(e, self.window_start, self.window_end)
        out = []
        for a, b in zip(s.tolist(), e.tolist()):
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self._union()) / 1e9

    def in_range(self, name: str) -> np.ndarray:
        """Which operations were launched inside a range called ``name``."""
        spans = np.array(self.ranges.get(name, []), dtype=np.int64).reshape(-1, 2)
        t = self.op_launch
        if not len(spans):
            return np.zeros(len(t), dtype=bool)
        j = np.searchsorted(spans[:, 0], t, side="right") - 1
        return (t >= 0) & (j >= 0) & (t <= spans[np.clip(j, 0, None), 1])

    def launches_in(self, name: str) -> int:
        """The host's kernel-launch calls made inside a range called ``name``."""
        spans = self.ranges.get(name, [])
        t = self.launch_times
        return int(sum(np.searchsorted(t, b, side="right") - np.searchsorted(t, a)
                       for a, b in spans))

    def device_s(self, name: str) -> float:
        """Summed device time of the operations launched in ``name``."""
        m = self.in_range(name)
        return float((self.op_end[m] - self.op_start[m]).sum()) / 1e9

    def union_s(self, name: str) -> float:
        return sum(b - a for a, b in self._union(self.in_range(name))) / 1e9

    # --- the breakdown ------------------------------------------------------
    def breakdown(self, top: int = 10) -> dict:
        """The device operations with the most time, and the longest idle
        gaps of the device, each named by what the host was doing then: the
        innermost benchmark range and the innermost host operation."""
        by_name = defaultdict(int)
        for s, e, n in zip(self.op_start.tolist(), self.op_end.tolist(), self.op_name):
            by_name[n] += e - s
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = self._union()
        edges = [self.window_start] + [x for ab in busy for x in ab] + [self.window_end]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:top]
        hs = np.array([h[0] for h in self.host], dtype=np.int64)
        he = np.array([h[1] for h in self.host], dtype=np.int64)
        out = []
        for length, start in gaps:
            mid = start + length // 2
            label = self._range_at(mid)
            inside = np.nonzero((hs <= mid) & (he >= mid))[0]
            if len(inside):
                label += " > " + self.host[int(inside[np.argmax(hs[inside])])][2]
            out.append([label, length / 1e9])
        return {"device_ops": [[n[:160], t / 1e9] for n, t in ops], "idle_gaps": out}

    def _range_at(self, t: int) -> str:
        best, best_start = "outside the benchmark's ranges", -1
        for name, spans in self.ranges.items():
            j = bisect.bisect_right([a for a, _ in spans], t) - 1
            if j >= 0 and t <= spans[j][1] and spans[j][0] > best_start:
                best, best_start = name, spans[j][0]
        return best

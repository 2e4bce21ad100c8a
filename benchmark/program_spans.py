"""The port's own spans inside a traced window, read like the benchmark's
ranges.

While a profiler session is enabled, the port logs each of its spans
(``tpu_cfd_torch.utils.trace_annotation``) in memory, stamped on the clock
of the profiler's events (``utils.span_log``). ``window_trace`` gives a view
of the window's trace whose ranges are those spans, so that ``Trace``'s own
reading (``in_range``, ``launches_in``) applies to them: an operation
belongs to a span when it was launched inside it. Where the port has no
span log (a tree before it), the log holds no span of the window, or it
dropped one, there is nothing to read: ``window_trace`` returns None, and
so do the readers.
"""

from __future__ import annotations

import copy
from collections import defaultdict


def window_trace(rec):
    """A copy of ``rec.trace`` whose ``ranges`` are the port's spans that lie
    in its window, by name, or None (see above)."""
    tr = rec.trace
    if tr is None:
        return None
    try:
        from tpu_cfd_torch.utils import profiling

        log, (dropped, first_dropped) = profiling.span_log(), profiling.spans_dropped()
    except (ImportError, AttributeError):
        return None
    if dropped and first_dropped <= tr.window_end:
        return None
    spans = defaultdict(list)
    for name, start, end, _ in log:
        if tr.window_start <= start and 0 <= end <= tr.window_end:
            spans[name].append((start, end))
    if not spans:
        return None
    view = copy.copy(tr)
    view.ranges = {name: sorted(v) for name, v in spans.items()}
    return view


def share_of_step(rec, name: str, step: str = "solver.forward"):
    """The device time of the operations launched inside both a span called
    ``name`` and a ``step`` span, over that of the operations launched
    inside ``step``, in %; None without steps in the window or device time
    in them. A ``name`` span outside any step counts for nothing."""
    view = window_trace(rec)
    if view is None:
        return None
    steps = view.in_range(step)
    spent = float((view.op_end[steps] - view.op_start[steps]).sum())
    if spent <= 0:
        return None
    part = steps & view.in_range(name)
    return 100.0 * float((view.op_end[part] - view.op_start[part]).sum()) / spent


def _overlap_ns(a, b) -> int:
    """Length of the overlap of two lists of disjoint sorted intervals."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return int(total)


def idle_share(rec, name: str):
    """The device's idle time (no operation running) inside the window while
    a span called ``name`` was open on the host, over the window, in %; None
    without such spans or without device operations. Spans of one name do
    not overlap, so the shares of two names that never nest add up to no
    more than the idle share of the trace's window."""
    view = window_trace(rec)
    if view is None or not len(view.op_start) or name not in view.ranges:
        return None
    spans = view.ranges[name]
    idle = sum(end - start for start, end in spans) - _overlap_ns(spans, view._union())
    return 100.0 * idle / (rec.window_s * 1e9)

"""Kernel launches the host made a solver step: the runtime's launch calls
made inside the port's ``solver.forward`` spans (the port's span log,
``program_spans``; the trace keeps the calls even where it drops a kernel's
own record), over the number of those spans in the window. Copies
(``cudaMemcpyAsync``) are not launches. None without the log, without
steps in the window or without launches (no device)."""

from benchmark import program_spans


def read(rec):
    view = program_spans.window_trace(rec)
    if view is None or "solver.forward" not in view.ranges:
        return None
    launches = view.launches_in("solver.forward")
    return launches / len(view.ranges["solver.forward"]) if launches else None

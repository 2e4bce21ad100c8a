"""Kernel launches the host made inside the window's training calls
(``bench.train``: the runtime's launch calls, which the trace keeps even
where it drops a kernel's own record) per train step of the window; the
validation passes (``bench.eval``) are not counted."""


def read(rec):
    steps = rec.counters.get("train_steps", 0)
    if rec.trace is None or not steps:
        return None
    launches = rec.trace.launches_in("bench.train")
    return launches / steps if launches else None

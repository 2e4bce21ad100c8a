"""The share of the traced window in which the device was not running the
solver's work: the initial conditions, the recorder's transforms, subsample
and host copies, and the idle time between them. Solver work is every
device operation launched inside a ``bench.solver`` range."""


def read(rec):
    if (rec.trace is None or not len(rec.trace.op_start)
            or not rec.ranges.calls.get("bench.solver")):
        return None
    return 100.0 * (1.0 - rec.trace.union_s("bench.solver") / rec.window_s)

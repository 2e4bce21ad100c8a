"""The explicit terms' share of the solver's device time: the device time of
the operations launched inside both a ``bench.explicit`` range (each
evaluation of the equation's explicit terms) and a ``bench.solver`` range,
over that of all operations launched inside ``bench.solver``. Evaluations
outside the solver calls (the recorder's residual) are left out. None
without solver calls; 0 where the solver evaluated no explicit terms."""


def read(rec):
    tr = rec.trace
    if tr is None or not rec.ranges.calls.get("bench.solver"):
        return None
    solver = tr.in_range("bench.solver")
    spent = float((tr.op_end[solver] - tr.op_start[solver]).sum())
    if spent <= 0:
        return None
    explicit = solver & tr.in_range("bench.explicit")
    return 100.0 * float((tr.op_end[explicit] - tr.op_start[explicit]).sum()) / spent

"""The solver post-process's share of the refine's device time: the device
time of the operations launched inside both a ``bench.post`` range (each
forward evaluation of the post-process: the rfft2 of the planes, the +-dt
Crank-Nicolson solves, the residual and the inverse transforms) and a
``bench.refine`` range, over that of all operations launched inside
``bench.refine``. Autograd launches the post-process's backward outside
``bench.post``, so it counts in the refine's time alone. None without
refines."""


def read(rec):
    tr = rec.trace
    if tr is None or not rec.ranges.calls.get("bench.refine"):
        return None
    refine = tr.in_range("bench.refine")
    spent = float((tr.op_end[refine] - tr.op_start[refine]).sum())
    if spent <= 0:
        return None
    post = refine & tr.in_range("bench.post")
    return 100.0 * float((tr.op_end[post] - tr.op_start[post]).sum()) / spent

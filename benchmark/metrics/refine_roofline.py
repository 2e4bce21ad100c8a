"""The refine's roofline share: the least time the traced refines' work
could take (``work/<config>.py``: ``refine_bound_s``) over the device time
of the operations launched inside the ``bench.refine`` ranges."""


def read(rec):
    fn = getattr(rec.work, "refine_bound_s", None)
    bound = fn(rec) if fn is not None else None
    spent = rec.trace.device_s("bench.refine") if rec.trace is not None else 0.0
    return 100.0 * bound / spent if bound and spent > 0 else None

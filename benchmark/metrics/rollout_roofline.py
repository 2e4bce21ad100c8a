"""The solver's roofline share: the least time its traced calls' work could
take (``work/<config>.py``: ``rollout_bound_s``) over the device time of
the operations launched inside the ``bench.solver`` ranges."""


def read(rec):
    fn = getattr(rec.work, "rollout_bound_s", None)
    bound = fn(rec) if fn is not None else None
    spent = rec.trace.device_s("bench.solver") if rec.trace is not None else 0.0
    return 100.0 * bound / spent if bound and spent > 0 else None

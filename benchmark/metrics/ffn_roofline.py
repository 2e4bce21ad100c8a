"""The FFN's roofline share: the least time the traced FFN forwards' work
could take (``work/<config>.py``: ``ffn_bound_s``) over the device time of
the operations launched inside the ``bench.ffn`` ranges."""


def read(rec):
    fn = getattr(rec.work, "ffn_bound_s", None)
    bound = fn(rec) if fn is not None else None
    spent = rec.trace.device_s("bench.ffn") if rec.trace is not None else 0.0
    return 100.0 * bound / spent if bound and spent > 0 else None

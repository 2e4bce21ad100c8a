"""The window's model operations (``work/<config>.py``: ``window_flops``)
over its wall time, as a share of the peak rate of the cell's precision."""


def read(rec):
    fn = getattr(rec.work, "window_flops", None)
    if fn is None:
        return None
    flops = fn(rec)
    return 100.0 * flops / rec.window_s / rec.peak_flops if flops else None

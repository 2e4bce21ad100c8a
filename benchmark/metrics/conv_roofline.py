"""The spectral convs' roofline share: the least time the forward convs the
port counted in the window could take (``work/<config>.py``:
``conv_bound_s``, from ``fno3d.COUNTS``) over the device time of the
operations launched inside the port's ``fno3d.conv`` spans (the port's span
log, ``program_spans``). Both see the convs run op by op, not those of a
replayed CUDA graph (the card's test pass), which open no span and move no
counter. None without the log, the counts or device time in the spans."""

from benchmark import program_spans


def read(rec):
    fn = getattr(rec.work, "conv_bound_s", None)
    bound = fn(rec) if fn is not None else None
    view = program_spans.window_trace(rec)
    if not bound or view is None:
        return None
    spent = view.device_s("fno3d.conv")
    return 100.0 * bound / spent if spent > 0 else None

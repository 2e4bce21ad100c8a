"""The share of the traced window in which no operation ran on the device."""


def read(rec):
    if rec.trace is None or not len(rec.trace.op_start):
        return None
    return 100.0 * (1.0 - rec.trace.busy_s() / rec.window_s)

"""The share of the traced window in which the device was idle while the
host was recording: the device's idle time (no operation running) that
overlaps the port's ``gen.record`` spans (a chunk's stack, transforms and
copy to the host, ``gen.to_host`` inside them; the port's span log,
``program_spans``), over the window. None without the log or without
recorded chunks in the window."""

from benchmark import program_spans


def read(rec):
    return program_spans.idle_share(rec, "gen.record")

"""The share of the traced window in which the device was idle while the
host was inside a solver call: the device's idle time (no operation
running) that overlaps the port's ``solver.forward`` spans (the port's span
log, ``program_spans``), over the window. Idle there is the host's launch
pace and the gaps between kernels, not the recorder's. None without the log
or without solver calls in the window."""

from benchmark import program_spans


def read(rec):
    return program_spans.idle_share(rec, "solver.forward")
